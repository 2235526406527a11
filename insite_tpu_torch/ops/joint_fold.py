"""The joint (one-ODE) model on the per-arm rollout kernels.

The joint model has one coefficient vector over a library whose inputs are
``[y, treatment inputs, statics]``. Its treatment inputs are binary per
step, so they take A = 2^E value combinations, and for combination ``a``
every joint feature is a feature of the reduced ``[y, statics]`` library
times a constant (0 or 1: u^k = u for binary u). With the fixed matrices
``M[a]`` of shape ``[F_reduced, F_joint]``,

    coefs_eff[a] = M[a] @ c_joint

is a per-arm model on the reduced library whose "arm" at a step is the
combination index of that step's treatment inputs. So

- the rollout of the joint model is one `batched_rollout` of the reduced
  library with ``coefs_eff``: one launch of the rollout kernel;
- ``d y / d c_joint = (d y / d coefs_eff) @ M``: one `rollout_with_sens`
  over the structurally non-zero effective coordinates, then one matrix
  product. A clipped step zeroes its sensitivities before that linear
  map, so the clip commutes with it.

`ops/rollout.py`'s plain versions take per-step ``treatments`` and run the
joint library directly; they are what the fold is tested against.
"""

from __future__ import annotations

import numpy as np
import torch

from insite_tpu_torch.core.constants import STEPS_FOR_DT
from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.ops.rollout import (batched_rollout,
                                          batched_rollout_plain,
                                          rollout_with_sens,
                                          rollout_with_sens_plain)


def combination_index(treatments: np.ndarray) -> np.ndarray:
    """The combination index per step of binary treatment inputs:
    ``treatments`` [B, T] (one column) or [B, T, E] -> int32 [B, T] with
    value sum_i u_i * 2^i (tumor family: chemo + 2 * radio)."""
    u = np.asarray(treatments)
    if u.ndim == 2:
        u = u[..., None]
    if not np.isin(u, (0, 1)).all():
        raise ValueError('the joint model folds binary treatment inputs; '
                         f'got values {np.unique(u)[:8]}')
    weights = 1 << np.arange(u.shape[-1])
    return (u.astype(np.int64) * weights).sum(-1).astype(np.int32)


class JointFold:
    """The fold of a joint library over ``[y, n_treatments binary inputs,
    statics]`` onto the reduced library over ``[y, statics]``:
    ``self.library`` (reduced) and ``self.M`` [A, F_reduced, F_joint]."""

    def __init__(self, joint_library: PolynomialLibrary, n_treatments: int):
        E = n_treatments
        if not 1 <= E < joint_library.n_inputs:
            raise ValueError(f'{E} treatment inputs do not fit a library of '
                             f'{joint_library.n_inputs} inputs')
        self.joint_library = joint_library
        self.n_treatments = E
        self.library = PolynomialLibrary(
            n_inputs=joint_library.n_inputs - E, degree=joint_library.degree,
            interaction_only=joint_library.interaction_only,
            include_bias=joint_library.include_bias)
        exps = joint_library.exponents()                    # [F_joint, 1+E+S]
        reduced = {tuple(e): f
                   for f, e in enumerate(self.library.exponents())}
        A = 1 << E
        M = np.zeros((A, len(reduced), exps.shape[0]))
        for k, e in enumerate(exps):
            f = reduced[tuple(np.delete(e, np.arange(1, 1 + E)))]
            for a in range(A):
                u = (a >> np.arange(E)) & 1
                # u^e with 0^0 = 1: the feature survives iff every
                # treatment input it contains is on
                M[a, f, k] = float(np.all((e[1:1 + E] == 0) | (u == 1)))
        M.flags.writeable = False
        self.M = M
        self._tensors = {}      # (what, device, dtype) -> tensor on device
        self._active = {}       # active_idx -> (eff_idx, M_act)

    @property
    def n_arms(self) -> int:
        return self.M.shape[0]

    def _on(self, key, array: np.ndarray, like: torch.Tensor):
        """``array`` as a tensor of ``like``'s type on its device, copied
        there once per ``key``."""
        key = (key, like.device, like.dtype)
        if key not in self._tensors:
            self._tensors[key] = torch.tensor(array, dtype=like.dtype,
                                              device=like.device)
        return self._tensors[key]

    def effective(self, coefs: torch.Tensor) -> torch.Tensor:
        """Joint coefficients [1 or B, 1, F_joint] -> the per-combination
        coefficients of the reduced library [1 or B, A, F_reduced]."""
        return torch.einsum('afk,bk->baf', self._on('M', self.M, coefs),
                            coefs[:, 0])

    def effective_active(self, active_idx: tuple):
        """For the active joint coordinates: the flat (a * F_reduced + f)
        effective coordinates that depend on any of them, and the matrix
        [Kr_eff, Kr_joint] that maps effective to joint sensitivities."""
        if active_idx not in self._active:
            M_act = self.M[:, :, list(active_idx)].reshape(
                -1, len(active_idx))
            eff = np.flatnonzero(M_act.any(axis=1))
            self._active[active_idx] = (tuple(int(i) for i in eff),
                                        M_act[eff])
        return self._active[active_idx]

    def rollout(self, coefs, y0, statics, arms, dt, substeps=STEPS_FOR_DT,
                y_clip=None):
        """`batched_rollout` of the joint model: coefs [1 or B, 1, F_joint],
        arms [B, T] the combination index per step."""
        return batched_rollout(self.library, self.effective(coefs), y0,
                               statics, arms, dt, substeps, y_clip)

    def rollout_with_sens(self, coefs, y0, statics, arms, dt, active_idx,
                          substeps=STEPS_FOR_DT, y_clip=None):
        """`rollout_with_sens` of the joint model: (preds [B, T],
        d y / d c_joint[active_idx] [B, T, Kr])."""
        return self._with_sens(rollout_with_sens, coefs, y0, statics, arms,
                               dt, active_idx, substeps, y_clip)

    def rollout_plain(self, coefs, y0, statics, arms, dt,
                      substeps=STEPS_FOR_DT, y_clip=None):
        """`rollout` by the plain version on any device; differentiable in
        ``coefs`` (the fold is an einsum)."""
        return batched_rollout_plain(self.library, self.effective(coefs), y0,
                                     statics, arms, dt, substeps, y_clip)

    def rollout_with_sens_plain(self, coefs, y0, statics, arms, dt,
                                active_idx, substeps=STEPS_FOR_DT,
                                y_clip=None):
        """`rollout_with_sens` by the plain version on any device."""
        return self._with_sens(rollout_with_sens_plain, coefs, y0, statics,
                               arms, dt, active_idx, substeps, y_clip)

    def _with_sens(self, sens_fn, coefs, y0, statics, arms, dt, active_idx,
                   substeps, y_clip):
        active_idx = tuple(active_idx)
        eff_idx, M_act = self.effective_active(active_idx)
        y, s_eff = sens_fn(self.library, self.effective(coefs), y0, statics,
                           arms, dt, eff_idx, substeps, y_clip)
        return y, s_eff @ self._on(active_idx, M_act, s_eff)
