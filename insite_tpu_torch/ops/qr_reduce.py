"""The QR reduction of weighted least-squares problems on the card: every
arm's ``[R | Q^T y]`` from one pass over the design (TSQR).

`qr_reduce` launches the kernels of `csrc/qr_reduce.cu` on CUDA tensors
and raises on anything else: the host's reduction is numpy's LAPACK QR in
`discovery/stlsq.py`, the JAX package's bit for bit, and
`qr_reduce_plain` here is the float64 function the kernels compute, the
reference of their tests. The module counts calls in `QR_LAUNCHES` (each
call is the kernels' two launches), reset with the other kernels' counters
by `ops.reset_launch_counts`. The kernels are built at their first
call, not on import.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from insite_tpu_torch.ops import build

QR_LAUNCHES = 0

# The widths the kernels take: every library a CUDA path of the port builds,
# up to the degree-4 library's F = 35, and up to 8 arms (the tumour family
# has 4). csrc/qr_reduce.cu refuses wider shapes with the same bounds.
MAX_FEATURES = 35
MAX_ARMS = 8
# blocks of the first stage an SM: their scratch is float64
# [blocks, K, (F + 1) (F + 2) / 2]
BLOCKS_PER_SM = 4

_ARM_KIND = {None: 0, torch.int64: 1}       # else the design's float type


def qr_reduce_plain(theta, y, n_arms=1, weight=None, ok=None, arm=None):
    """The function the kernels compute, in float64 numpy on the host:
    for each arm k < ``n_arms`` the upper triangle [F + 1, F + 1] of the QR
    of ``[theta | y]`` over the rows with ``arm == k``, ``ok`` and a
    positive ``weight``, each scaled by the square root of its weight
    (no weight: 1; no arm: every row in arm 0), with a non-negative
    diagonal. Returns numpy [K, F + 1, F + 1]."""
    A = np.concatenate([np.asarray(theta.cpu(), np.float64),
                        np.asarray(y.cpu(), np.float64)[:, None]], axis=1)
    w = (np.ones(len(A)) if weight is None
         else np.asarray(weight.cpu(), np.float64))
    keep = w > 0
    if ok is not None:
        keep &= np.asarray(ok.cpu(), bool)
    a = (np.zeros(len(A)) if arm is None
         else np.asarray(arm.cpu(), np.float64))
    C = A.shape[1]
    out = np.zeros((n_arms, C, C))
    for k in range(n_arms):
        rows = keep & (a == k)
        R = np.linalg.qr(A[rows] * np.sqrt(w[rows])[:, None], mode='r')
        R = R * np.where(np.diag(R) < 0, -1.0, 1.0)[:, None]
        out[k, :len(R)] = R
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = build.load_library()
    for suffix in ('f32', 'f64'):
        fn = getattr(lib, f'insite_qr_reduce_{suffix}')
        fn.argtypes = [_P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _I,
                       _P, _I, _P, _P]
        fn.restype = _I
    return lib


@functools.cache
def _max_blocks(dev: torch.device) -> int:
    """Blocks the first stage may take on ``dev``: `BLOCKS_PER_SM` an SM."""
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count


def _check(theta, y, n_arms, weight, ok, arm) -> torch.device:
    """Validate what the kernels take; returns the card."""
    given = [x for x in (theta, y, weight, ok, arm) if x is not None]
    devices = {x.device for x in given}
    if len(devices) != 1:
        raise ValueError('the QR inputs lie on more than one device: '
                         f'{sorted(map(str, devices))}')
    if theta.ndim != 2:
        raise ValueError(f'theta must be [N, F], got {tuple(theta.shape)}')
    N, F = theta.shape
    if not 1 <= F <= MAX_FEATURES or not 1 <= n_arms <= MAX_ARMS:
        raise ValueError(f'F={F}, {n_arms} arms: the QR kernels take F in '
                         f'1..{MAX_FEATURES} and 1..{MAX_ARMS} arms')
    dev = devices.pop()
    if dev.type != 'cuda':
        raise ValueError(f'the QR kernels take CUDA tensors, got {dev}')
    dtype = theta.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f'the QR kernels take float32 or float64, got {dtype}')
    for name, x, types in (('y', y, (dtype,)), ('weight', weight, (dtype,)),
                           ('ok', ok, (torch.bool,)),
                           ('arm', arm, (torch.int64, dtype))):
        if x is None:
            continue
        if x.shape != (N,) or x.dtype not in types:
            raise ValueError(f'{name} is {x.dtype} {tuple(x.shape)}; '
                             f'expected one of {types} ({N},)')
    for name, x in (('theta', theta), ('y', y), ('weight', weight),
                    ('ok', ok), ('arm', arm)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return dev


def qr_reduce(theta, y, n_arms: int = 1, weight=None, ok=None, arm=None):
    """Every arm's triangle ``[R_k | Q_k^T y_k]`` of the weighted problem
    ``[theta | y]``, from one pass over the rows: [K, F + 1, F + 1] in
    theta's dtype on theta's card, the arithmetic in float64.

    theta [N, F] and y [N] float32 or float64; ``weight`` [N] of theta's
    dtype (rows of weight <= 0 are left out; default 1), ``ok`` [N] bool
    (rows that are not ok are left out), ``arm`` [N] int64 or of theta's
    dtype (a row of arm k < ``n_arms`` goes to triangle k, any other value to
    none; default: every row is of arm 0). All contiguous, on one card.
    The diagonal is non-negative; an arm with no rows, or columns that are
    exactly dependent, leave zeros on it. Two calls on the same inputs give
    the same bits."""
    global QR_LAUNCHES
    dev = _check(theta, y, n_arms, weight, ok, arm)
    N, F = theta.shape
    C = F + 1
    max_blocks = _max_blocks(dev)
    partial = torch.empty(max_blocks * n_arms * C * (C + 1) // 2,
                          dtype=torch.float64, device=dev)
    out = torch.empty((n_arms, C, C), dtype=theta.dtype, device=dev)
    suffix = 'f32' if theta.dtype == torch.float32 else 'f64'
    fn = getattr(_kernels(), f'insite_qr_reduce_{suffix}')

    def ptr(x):
        return None if x is None else x.data_ptr()

    arm_kind = _ARM_KIND.get(None if arm is None else arm.dtype, 2)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptr(theta), ptr(y), ptr(weight), ptr(ok), ptr(arm),
                 arm_kind, N, F, n_arms, partial.data_ptr(), max_blocks,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'tsqr launch failed: cudaError_t {err}')
    QR_LAUNCHES += 1
    return out
