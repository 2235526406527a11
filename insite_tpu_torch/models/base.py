"""Estimator base: the evaluation protocol every method shares."""

from __future__ import annotations

import numpy as np

from insite_tpu_torch.eval.metrics import (normalised_masked_rmse,
                                           normalised_n_step_rmses)


def collection_vitals_width(collection) -> int:
    """The width of a collection's vitals stream (0 without one), read
    from its training rows, or from the rows they were before a decoder's
    processing replaced them."""
    if not getattr(collection, 'has_vitals', False):
        return 0
    train_f = collection.train_f
    data = train_f.data if 'vitals' in train_f.data else \
        train_f.data_original
    return data['vitals'].shape[-1]


class CausalEstimator:
    """Subclasses provide get_predictions / get_autoregressive_predictions
    (numpy, scaled like the dataset's outputs); this base supplies the
    normalised masked RMSE protocol."""

    unscale_rmse = True
    percentage_rmse = True

    def get_predictions(self, dataset) -> np.ndarray:
        raise NotImplementedError

    def get_autoregressive_predictions(self, dataset) -> np.ndarray:
        raise NotImplementedError

    def get_normalised_masked_rmse(self, dataset,
                                   one_step_counterfactual=False):
        outputs_scaled = np.asarray(self.get_predictions(dataset))
        return normalised_masked_rmse(
            dataset, outputs_scaled, unscale=self.unscale_rmse,
            percentage=self.percentage_rmse,
            one_step_counterfactual=one_step_counterfactual)

    def get_normalised_n_step_rmses(self, dataset, datasets_mc=None):
        """The 2..(ph+1)-step RMSEs of ``dataset``, predicted from
        ``datasets_mc`` where it is given (G-Net's Monte-Carlo views of
        the dataset)."""
        outputs_scaled = np.asarray(self.get_autoregressive_predictions(
            dataset if datasets_mc is None else datasets_mc))
        return normalised_n_step_rmses(dataset, outputs_scaled,
                                       unscale=self.unscale_rmse,
                                       percentage=self.percentage_rmse)
