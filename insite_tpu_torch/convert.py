"""Carry the system's state from numpy into the port's tensors.

The "weights" of this system are the simulated cohort, the simulator's
parameter dict, the discovered global coefficients ``[A, F]`` and the
per-patient coefficients ``[B, A, F]``. These helpers take numpy arrays
(for example pulled from the JAX package with ``np.asarray``) so that both
packages compute from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from insite_tpu_torch.data.collection import (CancerDatasetCollection,
                                              ContinuousDatasetCollection,
                                              PkpdDatasetCollection)
from insite_tpu_torch.harness.config import model_dataset_name


def params_from_numpy(d: dict, device, dtype) -> dict:
    """Simulator parameters: every numeric array becomes a tensor of
    ``dtype`` on ``device``; other arrays (the tumor cohort's stage names)
    stay numpy, and scalars (noise level, sigmoid constants, window) stay
    Python numbers."""
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = a.item()
        elif a.dtype.kind in 'biuf':
            out[k] = torch.as_tensor(a, dtype=dtype, device=device)
        else:
            out[k] = a
    return out


def coefs_from_numpy(c, device, dtype) -> torch.Tensor:
    """Global ``[A, F]`` or per-patient ``[B, A, F]`` coefficients."""
    return torch.as_tensor(np.asarray(c), dtype=dtype, device=device)


def collection_from_numpy(raw_subsets: dict, scaling_params,
                          equation_name: str, *, projection_horizon: int,
                          treatment_mode: str, sim_params: dict = None,
                          seed: int = 0):
    """The port's collection of ``equation_name`` (EQ_4_*: PKPD;
    CANCER_SIM or cancer_sim: cancer; EQ_5_*: continuous) over simulated,
    unprocessed subsets: ``raw_subsets`` maps train_f / val_f /
    test_cf_one_step / test_cf_treatment_seq to the simulator's numpy dicts
    (for example copies of a JAX collection's ``.data`` taken before
    processing), and ``scaling_params`` is the ``(means, stds)`` pair of
    the training subset. ``treatment_mode`` is 'multiclass' or 'multilabel'
    (the raw binary treatment columns, as the one-ODE ablation reads them).
    ``sim_params`` optionally maps a subset's name to its simulator
    parameters (numpy), which become that subset's ``sim_params`` (the
    hidden constants the recovery analysis reads). ``seed`` is the seed the
    subsets were simulated from; the collection's holdout split draws its
    permutation from it, as the source collection would. The dicts are copied
    shallowly; processing adds keys to the copies and writes into no
    array."""
    equation_name = model_dataset_name(equation_name)
    if 'EQ_4' in equation_name:
        cls = PkpdDatasetCollection
    elif equation_name == 'CANCER_SIM':
        cls = CancerDatasetCollection
    elif 'EQ_5' in equation_name:
        cls = ContinuousDatasetCollection
    else:
        raise ValueError(f'unknown dataset {equation_name}')
    coll = cls.from_subsets(
        {k: {n: np.asarray(a) for n, a in d.items()}
         for k, d in raw_subsets.items()},
        scaling_params, equation_name,
        projection_horizon=projection_horizon, treatment_mode=treatment_mode,
        seed=seed)
    for subset, params in (sim_params or {}).items():
        getattr(coll, subset).sim_params = {
            k: np.asarray(v) for k, v in params.items()}
    return coll


def msm_state_from_numpy(msm, prop_treat, prop_hist, regressors):
    """Put a fitted marginal structural model's state into the port's
    ``msm`` (`models/msm.py::MSM`): the two propensity models as ``(W [K, D],
    b [K])`` pairs and the ``projection_horizon + 1`` regressors'
    ``[(D + 1), K]`` coefficients (intercept last), for example the
    ``prop_treat``, ``prop_hist`` and ``regressors`` of a fitted JAX-package
    MSM. Returns ``msm``, which then predicts without a fit of its own."""
    msm.prop_treat = tuple(np.asarray(a, np.float64) for a in prop_treat)
    msm.prop_hist = tuple(np.asarray(a, np.float64) for a in prop_hist)
    msm.regressors = [np.asarray(c, np.float64) for c in regressors]
    if len(msm.regressors) != msm.cfg.projection_horizon + 1:
        raise ValueError(f'{len(msm.regressors)} regressors for a projection '
                         f'horizon of {msm.cfg.projection_horizon}')
    return msm
