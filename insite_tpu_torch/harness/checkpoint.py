"""Save a fitted estimator to disk and load it into a fresh one, in the
meaning of `insite_tpu.harness.checkpoint`, for every estimator family.

A checkpoint is a directory holding

- ``meta.json``: the estimator's class, its config as a dict and, for a
  SINDy-family model, its library's spec;
- ``state.pt``: the fitted state, `torch.save` of tensors, numbers,
  strings, None and lists and dicts of these (numpy arrays stored as
  tensors with their kind marked), read back with ``torch.load(...,
  weights_only=True)``, which unpickles nothing else.

The fields are the JAX package's `STATE_FIELDS`, on the port's objects: a
network is saved as its ``state_dict``, and the EMA parameters and
treatment masks of the balanced-representation stages as they are. The
format is the port's own: it does not read the JAX package's
``state.msgpack``.

    save_model(model, 'ckpts/insite_eq4d_s0')
    fresh = SINDyRegressor(cfg, device='cuda')   # same config, not fitted
    load_model(fresh, 'ckpts/insite_eq4d_s0')
    fresh.get_predictions(dataset)               # the saved model's
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.ops.joint_fold import JointFold

# fitted state per estimator class; dotted paths reach sub-objects
STATE_FIELDS = {
    'SINDyRegressor': ('coefs', 'global_equation_string'),
    'CausalTransformer': ('net', 'ema_params', 'treat_mask'),
    'CRN': ('encoder.net', 'encoder.ema_params', 'encoder.treat_mask',
            'decoder.net', 'decoder.ema_params', 'decoder.treat_mask'),
    'EDCT': ('encoder.net', 'encoder.ema_params', 'encoder.treat_mask',
             'decoder.net', 'decoder.ema_params', 'decoder.treat_mask'),
    'RMSN': ('prop_treat.net', 'prop_hist.net', 'encoder.net',
             'decoder.net'),
    'GNet': ('net', 'holdout_resid', 'holdout_resid_len'),
    'MSM': ('prop_treat', 'prop_hist', 'regressors'),
}
STATE_FILE = 'state.pt'
_NUMPY = '__numpy__'


def _owner_and_name(obj, path: str):
    *parents, name = path.split('.')
    for part in parents:
        obj = getattr(obj, part)
    return obj, name


def _encode(x):
    """Host copies of tensors; numpy arrays as marked tensors; tuples as
    lists (sequence unpacking reads both alike)."""
    if isinstance(x, torch.nn.Module):
        return _encode(x.state_dict())
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_encode(v) for v in x]
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return {_NUMPY: torch.from_numpy(np.ascontiguousarray(x))}
    if isinstance(x, np.generic):
        return x.item()
    return x


def _decode(x, device):
    if isinstance(x, dict):
        if set(x) == {_NUMPY}:
            return x[_NUMPY].numpy()
        return {k: _decode(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_decode(v, device) for v in x]
    if torch.is_tensor(x):
        return x.to(device)
    return x


def save_model(model, path: str) -> str:
    """Write a fitted estimator's state into the directory ``path``
    (made if missing); returns ``path``."""
    cls = type(model).__name__
    if cls not in STATE_FIELDS:
        raise NotImplementedError(f'no checkpoint schema for {cls}')
    os.makedirs(path, exist_ok=True)
    state = {}
    for field in STATE_FIELDS[cls]:
        owner, name = _owner_and_name(model, field)
        state[field] = _encode(getattr(owner, name))
    cfg = getattr(model, 'cfg', None)
    meta = {'class': cls,
            'config': (dataclasses.asdict(cfg)
                       if dataclasses.is_dataclass(cfg) else None)}
    lib = getattr(model, 'library', None)
    if lib is not None:
        meta['library'] = {'n_inputs': lib.n_inputs, 'degree': lib.degree,
                           'interaction_only': lib.interaction_only,
                           'include_bias': lib.include_bias}
        fold = getattr(model, '_fold', None)
        if fold is not None:
            meta['fold_treatments'] = fold.n_treatments
    torch.save(state, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, 'meta.json'), 'w') as f:
        json.dump(meta, f, indent=1, default=str)
    return path


def load_model(model, path: str):
    """Load the state saved at ``path`` into ``model``, an estimator of
    the same class built with the same config (and, for the neural
    families, a collection with the same widths); returns ``model``.
    Tensors go to the device of the object that holds them (a stage's or
    the estimator's ``device``; the host where it has none)."""
    with open(os.path.join(path, 'meta.json')) as f:
        meta = json.load(f)
    cls = type(model).__name__
    if meta['class'] != cls:
        raise ValueError(
            f"checkpoint is a {meta['class']}, got a {cls} instance")
    state = torch.load(os.path.join(path, STATE_FILE), map_location='cpu',
                       weights_only=True)
    for field, value in state.items():
        owner, name = _owner_and_name(model, field)
        current = getattr(owner, name)
        if isinstance(current, torch.nn.Module):
            current.load_state_dict(value)
        else:
            setattr(owner, name,
                    _decode(value, getattr(owner, 'device', 'cpu')))
    if 'library' in meta:
        model.library = PolynomialLibrary(**meta['library'])
        if 'fold_treatments' in meta:
            model._fold = JointFold(model.library, meta['fold_treatments'])
    return model
