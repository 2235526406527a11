"""Vectorized MSM seed columns: every per-seed solve batched over seeds.

The standard MSM path (`models/msm.py`) fits 2 propensity models (a
scipy L-BFGS-B fit per output) and projection_horizon + 1 weighted linear
regressors per seed, one seed after another. Here a whole seed column
becomes three batched float64 solves on the host, as in
`insite_tpu.harness.vectorized_msm`:

  1. damped-Newton logistic regression over a stacked [S, N, D] design
     (all seeds and outputs at once) for each propensity model, with the
     mean-NLL objective of `models.msm.logistic_fit`;
  2. per-horizon weighted least squares from batched normal equations
     (the pseudo-inverse of the [S, D+1, D+1] grams);
  3. the per-seed evaluation protocol, with the batched coefficients set
     into standard `MSM` instances.

MSM has no device code: cohorts are simulated on ``device``, as the
standard path simulates them, and everything else is numpy.
"""

from __future__ import annotations

import numpy as np

from insite_tpu_torch.data.collection import make_collection
from insite_tpu_torch.models.msm import MSM, MSMConfig


def _pad_stack(mats):
    """Stack [N_s, ...] per-seed matrices to [S, N_max, ...] plus a
    validity mask [S, N_max]."""
    n_max = max(m.shape[0] for m in mats)
    out = np.zeros((len(mats), n_max) + mats[0].shape[1:], np.float64)
    mask = np.zeros((len(mats), n_max), np.float64)
    for s, m in enumerate(mats):
        out[s, :m.shape[0]] = m
        mask[s, :m.shape[0]] = 1.0
    return out, mask


def batched_logistic_fit(X, Y, mask, max_iter=100, tol=1e-10, damp=1e-9):
    """Damped-Newton logistic regression batched over seeds and outputs.

    X [S, N, D] f64, Y [S, N, K] binary, mask [S, N] (0 = padding row).
    Returns (W [S, K, D], b [S, K]) minimizing the mean NLL of
    `models.msm.logistic_fit` (no penalty)."""
    S, N, D = X.shape
    K = Y.shape[-1]
    X1 = np.concatenate([X, np.ones((S, N, 1))], axis=-1)   # [S, N, D+1]
    nvalid = mask.sum(axis=1)[:, None, None]                # [S, 1, 1]
    wb = np.zeros((S, K, D + 1))
    eye = np.eye(D + 1)
    for _ in range(max_iter):
        logits = np.einsum('snd,skd->snk', X1, wb)
        logits = np.clip(logits, -500.0, 500.0)
        p = 1.0 / (1.0 + np.exp(-logits))
        resid = (p - Y) * mask[:, :, None] / nvalid          # [S, N, K]
        grad = np.einsum('snk,snd->skd', resid, X1)          # [S, K, D+1]
        r = p * (1.0 - p) * mask[:, :, None] / nvalid
        H = np.einsum('snk,snd,sne->skde', r, X1, X1)
        H = H + damp * eye
        step = np.linalg.solve(H, grad[..., None])[..., 0]
        wb = wb - step
        if float(np.max(np.abs(grad))) < tol:
            break
    return wb[..., :D], wb[..., D]


def batched_wlinreg(X, Y, sw, mask):
    """Weighted multi-output linear regression with an intercept, batched
    over seeds by the pseudo-inverse of the normal equations (D+1 is ~15,
    so the float64 gram is well conditioned). X [S, N, D], Y [S, N, K],
    sw and mask [S, N] -> coef [S, D+1, K] (intercept last)."""
    S, N, D = X.shape
    X1 = np.concatenate([X, np.ones((S, N, 1))], axis=-1)
    w = (sw * mask)[:, :, None]
    G = np.einsum('snd,sne->sde', X1 * w, X1)                # [S,D+1,D+1]
    c = np.einsum('snd,snk->sdk', X1 * w, Y)
    return np.linalg.pinv(G) @ c


def msm_column(collections, epochs: int = 100,
               model_overrides: dict = None) -> dict:
    """Fit and evaluate MSM on each of ``collections`` (one a seed) with
    the batched solves; ``epochs`` caps the Newton iterations as
    `MSMConfig.max_epochs` caps L-BFGS-B. Returns the metric keys of a run
    row, one float64 value a seed."""
    models = []
    for coll in collections:
        if not coll.processed_data_multi:
            coll.process_data_multi()
        d = coll.train_f.data
        cfg = MSMConfig(max_epochs=epochs,
                        dim_outcome=d['outputs'].shape[-1],
                        dim_treatments=d['current_treatments'].shape[-1],
                        dim_static_features=d['static_features'].shape[-1],
                        **(model_overrides or {}))
        models.append(MSM(cfg, coll))

    # stage 1: both propensity models, all seeds at once
    for which, attr in (('treat', 'prop_treat'), ('hist', 'prop_hist')):
        designs = [m._propensity_design(which) for m in models]
        X, mask = _pad_stack([x for x, _ in designs])
        Y, _ = _pad_stack([y for _, y in designs])
        W, b = batched_logistic_fit(X, Y, mask, max_iter=epochs)
        for s, m in enumerate(models):
            setattr(m, attr, (W[s], b[s]))
    for m in models:
        m.compute_stabilized_weights()
        m.regressors = []

    # stage 2: the per-horizon regressor bank, one batched solve per tau
    for tau in range(models[0].cfg.projection_horizon + 1):
        designs = [m._regressor_design(tau) for m in models]
        X, mask = _pad_stack([x for x, _, _ in designs])
        Y, _ = _pad_stack([y for _, y, _ in designs])
        sw, _ = _pad_stack([w for _, _, w in designs])
        coef = batched_wlinreg(X, Y, sw, mask)
        for s, m in enumerate(models):
            m.regressors.append(coef[s])

    # stage 3: the per-seed evaluation protocol
    res = {'encoder_test_rmse_orig': [], 'encoder_test_rmse_all': [],
           'encoder_test_rmse_last': []}
    for m, coll in zip(models, collections):
        o, a, l = m.get_normalised_masked_rmse(
            coll.test_cf_one_step, one_step_counterfactual=True)
        res['encoder_test_rmse_orig'].append(o)
        res['encoder_test_rmse_all'].append(a)
        res['encoder_test_rmse_last'].append(l)
        n_step = np.asarray(
            m.get_normalised_n_step_rmses(coll.test_cf_treatment_seq))
        for k, v in enumerate(n_step):
            res.setdefault(f'decoder_test_rmse_{k + 2}-step',
                           []).append(float(v))
    return {k: np.asarray(v, np.float64) for k, v in res.items()}


def vectorized_msm_sweep(dataset_name: str, n_seeds: int = 10,
                         num_patients: dict = None, coeff: float = 2.0,
                         epochs: int = 100, seed_start: int = 0,
                         cf_seq_mode: str = 'sliding_treatment',
                         noise_scale: float = 1.0,
                         model_overrides: dict = None,
                         max_seq_length: int = 60, *, device,
                         dtype=None) -> dict:
    """A whole MSM seed column, seeds ``seed_start`` .. + n_seeds - 1,
    over the standard path's cohorts (`make_collection` on ``device``, one
    collection a seed, multilabel), with `msm_column`'s batched solves.
    Returns the run row's metric keys, one value a seed."""
    num_patients = num_patients or {'train': 1000, 'val': 100, 'test': 100}
    collections = [make_collection(dataset_name, dict(num_patients), seed,
                                   coeff=float(coeff),
                                   treatment_mode='multilabel',
                                   cf_seq_mode=cf_seq_mode,
                                   noise_scale=noise_scale,
                                   max_seq_length=max_seq_length,
                                   device=device, dtype=dtype)
                   for seed in range(seed_start, seed_start + n_seeds)]
    return msm_column(collections, epochs, model_overrides)
