"""The evaluation protocol: normalised masked RMSE of factual, 1-step
counterfactual and n-step counterfactual predictions, in numpy, as
`insite_tpu.eval.metrics` computes it."""

from __future__ import annotations

import numpy as np


def normalised_masked_rmse(dataset, outputs_scaled, unscale=True,
                           percentage=True, one_step_counterfactual=False):
    """Returns (rmse_orig, rmse_all[, rmse_last]): the per-time-step mean
    of the squared error then its root (orig), the pooled root mean square
    (all) and, for the 1-step counterfactual set, the pooled error of each
    row's last active entry, the counterfactual one (last)."""
    d = dataset.data
    active = d['active_entries']
    if unscale:
        stds = dataset.scaling_params['output_stds']
        means = dataset.scaling_params['output_means']
        outputs_unscaled = outputs_scaled * stds + means
        mse = ((outputs_unscaled - d['unscaled_outputs']) ** 2) * active
    else:
        mse = ((outputs_scaled - d['outputs']) ** 2) * active

    mse_orig = (mse.sum(0).sum(-1) / active.sum(0).sum(-1)).mean()
    rmse_orig = np.sqrt(mse_orig) / dataset.norm_const
    mse_all = mse.sum() / active.sum()
    rmse_all = np.sqrt(mse_all) / dataset.norm_const
    if percentage:
        rmse_orig, rmse_all = rmse_orig * 100.0, rmse_all * 100.0

    if not one_step_counterfactual:
        return float(rmse_orig), float(rmse_all)

    # only the last active entry holds an actual counterfactual
    num, time_dim, out_dim = active.shape
    last_entries = active - np.concatenate(
        [active[:, 1:, :], np.zeros((num, 1, out_dim))], axis=1)
    if unscale:
        mse_last = ((outputs_unscaled - d['unscaled_outputs']) ** 2) \
            * last_entries
    else:
        mse_last = ((outputs_scaled - d['outputs']) ** 2) * last_entries
    mse_last = mse_last.sum() / last_entries.sum()
    rmse_last = np.sqrt(mse_last) / dataset.norm_const
    if percentage:
        rmse_last = rmse_last * 100.0
    return float(rmse_orig), float(rmse_all), float(rmse_last)


def normalised_n_step_rmses(dataset, outputs_scaled, unscale=True,
                            percentage=True):
    """Per-horizon normalised RMSE over the last-tau-steps evaluation rows.
    ``dataset.data_processed_seq`` must hold the sequential-test targets."""
    seq = dataset.data_processed_seq
    active = seq['active_entries']
    if unscale:
        stds = dataset.scaling_params['output_stds']
        means = dataset.scaling_params['output_means']
        outputs_unscaled = outputs_scaled * stds + means
        mse = ((outputs_unscaled - seq['unscaled_outputs']) ** 2) * active
    else:
        mse = ((outputs_scaled - seq['outputs']) ** 2) * active

    nan_idx = np.unique(np.where(np.isnan(seq['outputs']))[0])
    not_nan = np.setdiff1d(np.arange(outputs_scaled.shape[0]), nan_idx)
    mse_orig = (mse[not_nan].sum(0).sum(-1) /
                active[not_nan].sum(0).sum(-1))
    rmses = np.sqrt(mse_orig) / dataset.norm_const
    if percentage:
        rmses = rmses * 100.0
    return rmses
