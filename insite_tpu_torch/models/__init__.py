"""The estimator base and the SINDy / INSITE estimator."""

from insite_tpu_torch.models.base import CausalEstimator
from insite_tpu_torch.models.sindy import SINDyConfig, SINDyRegressor

__all__ = ['CausalEstimator', 'SINDyConfig', 'SINDyRegressor']
