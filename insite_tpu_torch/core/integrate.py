"""Fixed-step sub-stepped Euler integration on batched tensors.

The benchmark family integrates every ODE, the simulators' and the
discovered models' alike, with a fixed-grid Euler scheme that splits each
observation interval into ``STEPS_FOR_DT`` sub-steps. These functions give
that scheme for any vector field on tensors of any shape (typically a whole
batch), as `insite_tpu.core.integrate` does with `lax.scan`: here a Python
loop over time, and autograd differentiates through it. The rollout
kernels (`ops/rollout.py`) carry the same sub-steps for the polynomial
models themselves.
"""

from __future__ import annotations

from typing import Callable

import torch

from insite_tpu_torch.core.constants import STEPS_FOR_DT


def euler_step(f: Callable, y, t, dt, *args, substeps: int = STEPS_FOR_DT):
    """Advance ``y`` by one observation interval ``dt`` in ``substeps``
    Euler sub-steps of ``dt / substeps``; ``f(y, t, *args)`` is the vector
    field."""
    h = dt / substeps
    for k in range(substeps):
        y = y + f(y, t + k * h, *args) * h
    return y


def euler_rollout(f: Callable, y0, ts, *args, substeps: int = STEPS_FOR_DT):
    """Integrate over the grid ``ts`` [T], returning the state at every grid
    point: ``[T, *y0.shape]`` with ``out[0] == y0``."""
    ys = [y0]
    y = y0
    for i in range(ts.shape[0] - 1):
        y = euler_step(f, y, ts[i], ts[i + 1] - ts[i], *args,
                       substeps=substeps)
        ys.append(y)
    return torch.stack(ys)


def euler_odeint(f: Callable, y0, ts, *args):
    """One trajectory over ``ts``: `euler_rollout` with the default
    sub-steps."""
    return euler_rollout(f, y0, ts, *args)


def controlled_rollout(f: Callable, y0, controls, dt, *args,
                       substeps: int = STEPS_FOR_DT):
    """Roll out a controlled ODE: at step ``k`` the vector field
    ``f(y, t, controls[k], *args)`` integrates one ``dt``. Returns the T
    post-step states ``[T, *y0.shape]``, T = ``controls.shape[0]``."""
    ys = []
    y = y0
    for k in range(controls.shape[0]):
        u = controls[k]
        y = euler_step(lambda yy, tt: f(yy, tt, u, *args), y, 0.0, dt,
                       substeps=substeps)
        ys.append(y)
    return torch.stack(ys)
