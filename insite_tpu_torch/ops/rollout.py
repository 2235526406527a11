"""Fused Euler + polynomial-library rollout of the discovered model, with
and without forward sensitivities.

Two public functions, each with its kernel in `csrc/rollout.cu` and its
plain PyTorch version beside it:

- `batched_rollout` (kernel `rollout_kernel`, plain `batched_rollout_plain`)
  gives the [B, T] predictions y[1..T].
- `rollout_with_sens` (kernel `rollout_sens_kernel`, plain
  `rollout_with_sens_plain`) also gives d y / d c for the active flat
  coefficient coordinates, [B, T, Kr]: the Jacobian of the INSITE
  fine-tune.

Each dispatches on the device of its inputs: CPU tensors take the plain
version, CUDA tensors launch the kernel on the card that holds them
(whichever card is current), and a failed build or launch raises, as do
inputs on more than one device. More active coordinates than the
sensitivity kernel takes go through it in groups, one launch a group. The module counts kernel launches
in `ROLLOUT_LAUNCHES` and `SENS_LAUNCHES`, so a run can show that it went
through the kernels.

The plain versions also take per-step ``treatments``: the joint (one-ODE)
model, whose library reads ``[y, treatment inputs, statics]``. The kernels
run that model folded onto a per-arm one (`ops/joint_fold.py`), and the
plain joint versions are what the fold is tested against.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from insite_tpu_torch.core.constants import STEPS_FOR_DT
from insite_tpu_torch.discovery.library import integer_powers
from insite_tpu_torch.ops import build

ROLLOUT_LAUNCHES = 0
SENS_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference for the kernels)

def _select_arm(coefs, arm_t):
    """coefs [1|B, A, F], arm_t [B] -> per-patient coefficients [B, F]."""
    B = arm_t.shape[0]
    return coefs.expand(B, *coefs.shape[1:])[
        torch.arange(B, device=arm_t.device), arm_t.long()]


def _state_inputs(y, statics, treatments_t=None):
    """[y, (this step's treatment inputs,) statics]: [B, n_inputs]."""
    parts = [y[:, None], statics]
    if treatments_t is not None:
        parts.insert(1, treatments_t.to(y.dtype))
    return torch.cat(parts, dim=-1)


def _treatments_at(treatments, t):
    """Step t of [B, T, E] (or [B, T]: one column) treatment inputs."""
    if treatments is None:
        return None
    u = treatments[:, t]
    return u[:, None] if u.ndim == 1 else u


def batched_rollout_plain(library, coefs, y0, statics, arms, dt,
                          substeps=STEPS_FOR_DT, y_clip=None,
                          treatments=None):
    """The function `rollout_kernel` computes, in plain PyTorch. With
    ``treatments`` [B, T, E], the joint model: the library takes
    [y, treatments of the step, statics] and ``arms`` picks among the
    coefficient rows as ever (all zeros for the one joint row)."""
    h = dt / substeps
    y = y0
    out = []
    for t in range(arms.shape[1]):
        c = _select_arm(coefs, arms[:, t])
        u = _treatments_at(treatments, t)
        for _ in range(substeps):
            theta = library(_state_inputs(y, statics, u))   # [B, F]
            y = y + h * (c * theta).sum(-1)
        if y_clip is not None:
            y = torch.clamp(y, y_clip[0], y_clip[1])
        out.append(y)
    return torch.stack(out, dim=1)


def rollout_with_sens_plain(library, coefs, y0, statics, arms, dt,
                            active_idx, substeps=STEPS_FOR_DT, y_clip=None,
                            treatments=None):
    """The function `rollout_sens_kernel` computes, in plain PyTorch: the
    forward-sensitivity recurrence batched over B, a loop over T and the
    sub-steps, evaluated at the pre-update state. ``treatments`` as in
    `batched_rollout_plain`."""
    B, T = arms.shape
    F = coefs.shape[-1]
    e0 = library.exponents()[:, :1]                         # [F, 1]
    e0_less_one = np.maximum(e0 - 1, 0)
    e0 = torch.as_tensor(e0[:, 0], dtype=y0.dtype, device=y0.device)
    act_arm = torch.tensor([i // F for i in active_idx], device=y0.device)
    act_feat = torch.tensor([i % F for i in active_idx], device=y0.device)
    h = dt / substeps
    y = y0
    s = y0.new_zeros(B, len(active_idx))
    ys, ss = [], []
    for t in range(T):
        arm = arms[:, t].long()
        c = _select_arm(coefs, arm)
        driven = arm[:, None] == act_arm[None, :]            # [B, Kr]
        u = _treatments_at(treatments, t)
        for _ in range(substeps):
            P = library.powers(_state_inputs(y, statics, u))  # [B, F, n_in]
            theta = P.prod(-1)
            # e_0 * y^(e_0 - 1) * prod_{i>0} X_i^e_i  (0 where e_0 = 0)
            dtheta_dy = (e0 * integer_powers(y[:, None], e0_less_one)[..., 0]
                         * P[..., 1:].prod(-1))
            dy = (c * theta).sum(-1)
            dfdy = (c * dtheta_dy).sum(-1)
            drive = torch.where(driven, theta[:, act_feat], 0.0)
            s = s + h * (dfdy[:, None] * s + drive)
            y = y + h * dy
        if y_clip is not None:
            inside = (y > y_clip[0]) & (y < y_clip[1])
            y = torch.clamp(y, y_clip[0], y_clip[1])
            s = torch.where(inside[:, None], s, 0.0)
        ys.append(y)
        ss.append(s)
    return torch.stack(ys, dim=1), torch.stack(ss, dim=1)


# ---------------------------------------------------------------------------
# CUDA kernels

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = build.load_library()
    for suffix, real in (('f32', ctypes.c_float), ('f64', ctypes.c_double)):
        fn = getattr(lib, f'insite_rollout_{suffix}')
        fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, real, _I, real, real, _P]
        fn.restype = _I
        fn = getattr(lib, f'insite_rollout_sens_{suffix}')
        fn.argtypes = [_P, ctypes.c_longlong, _P, _P, _P, _P, _P, _I, _P, _P,
                       _I, _I, _I, _I, _I, _I, real, _I, real, real, _P]
        fn.restype = _I
    lib.insite_rollout_bounds.argtypes = [ctypes.POINTER(_I)]
    lib.insite_rollout_bounds.restype = None
    return lib


@functools.cache
def kernel_bounds() -> dict:
    """The largest shapes the kernels take, as compiled into
    csrc/rollout.cu: F features, n_inputs library inputs, arms, and Kr
    active coordinates."""
    out = (_I * 4)()
    _kernels().insite_rollout_bounds(out)
    return dict(zip(('F', 'n_inputs', 'arms', 'Kr'), out))


@functools.lru_cache(maxsize=None)
def _library_table(library) -> np.ndarray:
    """The library's exponent table [F, n_inputs] as a host int32 array,
    which the launch copies into the kernel's parameters. Cached per
    library: the wrappers run it on every launch."""
    exps = library.exponents()
    bound = kernel_bounds()
    F = exps.shape[0]
    if F > bound['F'] or library.n_inputs > bound['n_inputs']:
        raise ValueError(f'F={F}, n_inputs={library.n_inputs} exceed the '
                         f'kernel bounds {bound["F"]}, {bound["n_inputs"]}')
    table = np.ascontiguousarray(exps, dtype=np.int32)
    table.flags.writeable = False
    return table


@functools.lru_cache(maxsize=None)
def _active_table(active: tuple, A: int, F: int) -> np.ndarray:
    """(arm, feature) of each active flat coordinate, a host int32 array."""
    bound = kernel_bounds()['Kr']
    if not 1 <= len(active) <= bound:
        raise ValueError(f'Kr={len(active)} active coordinates; the kernel '
                         f'takes 1..{bound}')
    if any(not 0 <= int(i) < A * F for i in active):
        raise ValueError(f'active_idx {active} outside [0, {A * F})')
    table = np.array([divmod(int(i), F) for i in active], dtype=np.int32)
    table.flags.writeable = False
    return table


def _checked(library, coefs, y0, statics, arms):
    """Validate what the kernels take; returns contiguous operands, the
    shape tuple (B, T, A, F, S), the coefficient batch stride and the host
    exponent table."""
    dev = y0.device
    if dev.type != 'cuda':
        raise ValueError(f'the rollout kernels take CUDA tensors, got {dev}')
    dtype = y0.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'the rollout kernels take float32 or float64, '
                        f'got {dtype}')
    for name, x in (('coefs', coefs), ('statics', statics)):
        if x.device != dev or x.dtype != dtype:
            raise ValueError(f'{name} is {x.dtype} on {x.device}; '
                             f'expected {dtype} on {dev}')
    if arms.device != dev:
        raise ValueError(f'arms is on {arms.device}; expected {dev}')
    B, T = arms.shape
    A, F = coefs.shape[-2:]
    S = statics.shape[-1]
    if coefs.ndim != 3 or coefs.shape[0] not in (1, B):
        raise ValueError(f'coefs must be [1 or {B}, A, F], got '
                         f'{tuple(coefs.shape)}')
    if y0.shape != (B,) or statics.shape != (B, S):
        raise ValueError(f'y0 {tuple(y0.shape)} / statics '
                         f'{tuple(statics.shape)} do not match B={B}')
    table = _library_table(library)
    if library.n_inputs != 1 + S or table.shape[0] != F:
        raise ValueError('the library must take [y, statics] and have one '
                         'feature per coefficient (a joint model is '
                         'folded first: ops/joint_fold.py)')
    if A > kernel_bounds()['arms']:
        raise ValueError(f'A={A} exceeds the kernel bounds '
                         f'{kernel_bounds()["arms"]}')
    coef_bstride = 0 if coefs.shape[0] == 1 else A * F
    return ((coefs.contiguous(), y0.contiguous(), statics.contiguous(),
             arms.to(torch.int32).contiguous()), (B, T, A, F, S),
            coef_bstride, table)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'{what} launch failed: cudaError_t {err}')


def _suffix(dtype) -> str:
    return 'f32' if dtype == torch.float32 else 'f64'


def _clip_args(y_clip):
    return (0, 0.0, 0.0) if y_clip is None else (1, float(y_clip[0]),
                                                 float(y_clip[1]))


def _rollout_cuda(library, coefs, y0, statics, arms, dt, substeps, y_clip):
    global ROLLOUT_LAUNCHES
    ops, (B, T, A, F, S), bstride, table = _checked(library, coefs, y0,
                                                    statics, arms)
    out = torch.empty((B, T), dtype=y0.dtype, device=y0.device)
    if B == 0 or T == 0:
        return out
    fn = getattr(_kernels(), f'insite_rollout_{_suffix(y0.dtype)}')
    c, y, u, ar = ops
    # the launch, its shared-memory attribute and the stream act on the
    # current card: make it the tensors' own
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        err = fn(c.data_ptr(), bstride, y.data_ptr(), u.data_ptr(),
                 ar.data_ptr(), table.ctypes.data, out.data_ptr(), B, T, A,
                 F, S, substeps, dt / substeps, *_clip_args(y_clip), stream)
    _raise_on(err, 'rollout_kernel')
    ROLLOUT_LAUNCHES += 1
    return out


def _sens_outputs(out, B, T, Kr, dtype, device):
    """The sensitivity kernel's outputs (y [B, T], sens [B, T, Kr]): new
    tensors where ``out`` is None, else the pair ``out`` after a check
    that the kernel can write them as they are."""
    if out is None:
        return (torch.empty((B, T), dtype=dtype, device=device),
                torch.empty((B, T, Kr), dtype=dtype, device=device))
    for name, x, shape in zip(('y', 'sens'), out, ((B, T), (B, T, Kr))):
        if x.shape != shape or x.dtype != dtype or x.device != device \
                or not x.is_contiguous():
            raise ValueError(f'the {name} buffer is {x.dtype} '
                             f'{tuple(x.shape)} on {x.device}; expected a '
                             f'contiguous {dtype} {shape} on {device}')
    return tuple(out)


def _sens_cuda(library, coefs, y0, statics, arms, dt, active_idx, substeps,
               y_clip, out=None):
    """The sensitivity kernel's launch; ``out``, a pair (y, sens), takes
    its outputs in place of new tensors."""
    global SENS_LAUNCHES
    ops, (B, T, A, F, S), bstride, table = _checked(library, coefs, y0,
                                                    statics, arms)
    act = _active_table(tuple(active_idx), A, F)
    Kr = len(active_idx)
    out, sens = _sens_outputs(out, B, T, Kr, y0.dtype, y0.device)
    if B == 0 or T == 0:
        return out, sens
    fn = getattr(_kernels(), f'insite_rollout_sens_{_suffix(y0.dtype)}')
    c, y, u, ar = ops
    with torch.cuda.device(y0.device):
        stream = torch.cuda.current_stream(y0.device).cuda_stream
        err = fn(c.data_ptr(), bstride, y.data_ptr(), u.data_ptr(),
                 ar.data_ptr(), table.ctypes.data, act.ctypes.data, Kr,
                 out.data_ptr(), sens.data_ptr(), B, T, A, F, S, substeps,
                 dt / substeps, *_clip_args(y_clip), stream)
    _raise_on(err, 'rollout_sens_kernel')
    SENS_LAUNCHES += 1
    return out, sens


def _sens_in_groups(sens_fn, group: int, library, coefs, y0, statics, arms,
                    dt, active_idx, substeps, y_clip, out=None):
    """``sens_fn`` over ``active_idx`` in groups of at most ``group``
    coordinates, one call a group: sensitivities of different coordinates
    are independent given the state, so the groups' [B, T, k] blocks are
    concatenated on the last axis and y is the first group's. ``out``
    (output buffers) takes one group only."""
    active_idx = tuple(active_idx)
    if len(active_idx) <= group:
        # `out` goes positionally, and only where given: wraps of the
        # launcher forward their trailing arguments as they come
        return sens_fn(library, coefs, y0, statics, arms, dt, active_idx,
                       substeps, y_clip, *(() if out is None else (out,)))
    if out is not None:
        raise ValueError(f'output buffers take at most {group} active '
                         f'coordinates, one launch; got {len(active_idx)}')
    outs = [sens_fn(library, coefs, y0, statics, arms, dt,
                    active_idx[i:i + group], substeps, y_clip)
            for i in range(0, len(active_idx), group)]
    return outs[0][0], torch.cat([s for _, s in outs], dim=-1)


# ---------------------------------------------------------------------------
# public entry points

def _one_device(*tensors) -> torch.device:
    """The one device of ``tensors``; inputs on two devices raise."""
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError('the rollout inputs lie on more than one device: '
                         f'{sorted(map(str, devices))}')
    return devices.pop()


def batched_rollout(library, coefs, y0, statics, arms, dt,
                    substeps=STEPS_FOR_DT, y_clip=None):
    """Euler rollout of the discovered model: [B, T] predictions y[1..T].

    coefs: [1, A, F] (shared) or [B, A, F]; y0: [B]; statics: [B, S];
    arms: [B, T] integer arm per step; y_clip: optional (lo, hi) applied
    after each step's sub-steps."""
    if _one_device(coefs, y0, statics, arms).type == 'cpu':
        return batched_rollout_plain(library, coefs, y0, statics, arms, dt,
                                     substeps, y_clip)
    return _rollout_cuda(library, coefs, y0, statics, arms, dt, substeps,
                         y_clip)


def rollout_with_sens(library, coefs, y0, statics, arms, dt, active_idx,
                      substeps=STEPS_FOR_DT, y_clip=None, out=None):
    """Rollout plus d y_t / d coefs.flat[active_idx[j]]: returns
    (preds [B, T], sens [B, T, Kr]). active_idx: flat (arm * F + feature)
    coordinates, any number of them: beyond the kernel's bound they take
    one launch per group of that many. ``out``, a pair of contiguous CUDA
    tensors of those shapes, is where the kernel writes them (one launch
    only); the plain version takes none."""
    if _one_device(coefs, y0, statics, arms).type == 'cpu':
        if out is not None:
            raise ValueError('output buffers are for the kernel: CUDA '
                             'tensors only')
        return rollout_with_sens_plain(library, coefs, y0, statics, arms, dt,
                                       active_idx, substeps, y_clip)
    return _sens_in_groups(_sens_cuda, kernel_bounds()['Kr'], library, coefs,
                           y0, statics, arms, dt, active_idx, substeps,
                           y_clip, out)
