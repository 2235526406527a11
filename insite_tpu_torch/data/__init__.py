"""Dataset container, PKPD processing and the dataset collections."""

from insite_tpu_torch.data.collection import (CancerDatasetCollection,
                                              ContinuousDatasetCollection,
                                              DatasetCollection,
                                              PkpdDatasetCollection,
                                              make_collection)
from insite_tpu_torch.data.dataset import SeqDataset

__all__ = ['SeqDataset', 'DatasetCollection', 'PkpdDatasetCollection',
           'CancerDatasetCollection', 'ContinuousDatasetCollection',
           'make_collection']
