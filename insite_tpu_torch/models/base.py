"""Estimator base: the evaluation protocol every method shares."""

from __future__ import annotations

import numpy as np

from insite_tpu_torch.eval.metrics import (normalised_masked_rmse,
                                           normalised_n_step_rmses)


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

    def get_normalised_n_step_rmses(self, dataset):
        outputs_scaled = np.asarray(
            self.get_autoregressive_predictions(dataset))
        return normalised_n_step_rmses(dataset, outputs_scaled,
                                       unscale=self.unscale_rmse,
                                       percentage=self.percentage_rmse)
