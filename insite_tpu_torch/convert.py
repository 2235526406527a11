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
                          treatment_mode: str):
    """The port's collection of ``equation_name`` (EQ_4_*: PKPD;
    CANCER_SIM or cancer_sim: cancer; EQ_5_*: continuous) over simulated,
    unprocessed subsets: ``raw_subsets`` maps train_f / val_f /
    test_cf_one_step / test_cf_treatment_seq to the simulator's numpy dicts
    (for example copies of a JAX collection's ``.data`` taken before
    processing), and ``scaling_params`` is the ``(means, stds)`` pair of
    the training subset. The dicts are copied shallowly; processing adds
    keys to the copies and writes into no array."""
    equation_name = model_dataset_name(equation_name)
    if 'EQ_4' in equation_name:
        cls = PkpdDatasetCollection
    elif equation_name == 'CANCER_SIM':
        cls = CancerDatasetCollection
    elif 'EQ_5' in equation_name:
        cls = ContinuousDatasetCollection
    else:
        raise ValueError(f'unknown dataset {equation_name}')
    return cls.from_subsets(
        {k: {n: np.asarray(a) for n, a in d.items()}
         for k, d in raw_subsets.items()},
        scaling_params, equation_name,
        projection_horizon=projection_horizon, treatment_mode=treatment_mode)
