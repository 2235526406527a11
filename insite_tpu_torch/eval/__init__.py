"""The normalised masked RMSE protocol."""

from insite_tpu_torch.eval.metrics import (normalised_masked_rmse,
                                           normalised_n_step_rmses)

__all__ = ['normalised_masked_rmse', 'normalised_n_step_rmses']
