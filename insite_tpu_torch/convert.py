"""Carry the system's state from numpy into the port's tensors.

The "weights" of this system are the simulated cohort, the simulator's
parameter dict, the discovered global coefficients ``[A, F]``, the
per-patient coefficients ``[B, A, F]``, a fitted MSM's regressions and the
parameters of the neural baselines' networks. These helpers take numpy
arrays (for example pulled from the JAX package with ``np.asarray``) so
that both packages compute from the same state.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from insite_tpu_torch.data.collection import (CancerDatasetCollection,
                                              ContinuousDatasetCollection,
                                              PkpdDatasetCollection)
from insite_tpu_torch.harness.config import model_dataset_name
from insite_tpu_torch.models.nn.blocks import ROutcomeVitalsHead


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


# flax's automatic module names -> the port's attribute names
_FLAX_MODULES = {'TorchDense_0': 'linear1', 'TorchDense_1': 'linear2',
                 'LayerNorm_0': 'layer_norm'}


def _module_name(name: str, parent) -> str:
    """The port's attribute name of the flax module ``name`` inside the
    port's module ``parent``. In G-Net's `ROutcomeVitalsHead` flax numbers
    the dense layers in order: the r projection, then per component its
    hidden layer and its output (``r_layer``, ``fc.{c}``, ``out.{c}``)."""
    m = re.fullmatch(r'TorchDense_(\d+)', name)
    if isinstance(parent, ROutcomeVitalsHead) and m:
        i = int(m.group(1))
        if i == 0:
            return 'r_layer'
        return f'{("out", "fc")[i % 2]}.{(i - 1) // 2}'
    return _FLAX_MODULES.get(name, name)


def _flax_leaf(name: str, value: np.ndarray):
    """(the port's parameter name, value) of one flax parameter: a dense
    kernel ``[in, out]`` becomes ``weight [out, in]``, a LayerNorm scale a
    weight, the LSTM's ``w_ih_l`` / ``w_hh_l`` ``[in, 4H]`` the transposed
    ``weight_ih_l{l}`` / ``weight_hh_l{l}``, and its ``b_l`` / ``b_hh_l``
    the two biases (gate order i, f, g, o in both packages)."""
    m = re.fullmatch(r'(w_ih|w_hh|b|b_hh)_(\d+)', name)
    if m:
        kind, layer = m.groups()
        torch_name = {'w_ih': 'weight_ih', 'w_hh': 'weight_hh',
                      'b': 'bias_ih', 'b_hh': 'bias_hh'}[kind]
        return (f'{torch_name}_l{layer}',
                value.T if kind.startswith('w') else value)
    if name == 'kernel':
        return 'weight', value.T
    if name == 'scale':
        return 'weight', value
    return name, value


def state_dict_from_flax(params: dict, module: torch.nn.Module) -> dict:
    """``module``'s state_dict from a flax ``params`` tree (nested dicts of
    numpy arrays, for example the JAX package's CT, CRN, RMSN, G-Net or
    EDCT parameters pulled with ``np.asarray``), in ``module``'s dtypes and
    on its device. Raises
    ``ValueError`` unless the tree gives every entry of the state_dict, in
    its shape, and nothing else."""
    out = {}

    def walk(tree, prefix):
        try:
            parent = module.get_submodule('.'.join(prefix))
        except AttributeError:          # no such module: reported below
            parent = None
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + [_module_name(k, parent)])
            else:
                name, value = _flax_leaf(k, np.asarray(v))
                out['.'.join(prefix + [name])] = value

    walk(params, [])
    want = module.state_dict()
    if set(out) != set(want):
        raise ValueError(f'flax parameters {sorted(set(out) - set(want))} '
                         f'have no place in the module, which also needs '
                         f'{sorted(set(want) - set(out))}')
    for k, ref in want.items():
        if tuple(out[k].shape) != tuple(ref.shape):
            raise ValueError(f'{k}: flax shape {out[k].shape}, module '
                             f'shape {tuple(ref.shape)}')
        out[k] = torch.tensor(out[k], dtype=ref.dtype, device=ref.device)
    return out


def stacked_params_from_flax(trees, module: torch.nn.Module) -> dict:
    """The seed-stacked parameters of a vectorized column's stage
    (`models.nn.training.stack_nets`) from S flax ``trees``, one a seed,
    for example the JAX package's initial parameters of each seed of a
    column: {name: [S, ...]} in ``module``'s dtypes and on its device, new
    leaf tensors that require gradients. Raises as `state_dict_from_flax`
    does."""
    states = [state_dict_from_flax(t, module) for t in trees]
    return {name: torch.stack([st[name] for st in states]).requires_grad_()
            for name, _ in module.named_parameters()}
