"""The tumour simulator's day loops on the card: one launch a cohort, one
thread a patient through every day.

`factual` and `cf_factual` launch the kernels of `csrc/tumor_sim.cu` on
CUDA tensors and raise on anything else: the host runs the Python loops of
`sim/tumor.py` (`_factual_loop`, `_cf_factual_loop`), which are the
kernels' reference. Each returns what its loop returns, in the same layout,
on the tensors' card. A launch reads nothing back from the card and does
not wait for it. The module counts launches in `SIM_LAUNCHES` (one a call),
reset with the other kernels' counters by `ops.reset_launch_counts`. The
kernels are built at their first call, not on import.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from insite_tpu_torch.ops import build

DRAWS = ('noise', 'recovery', 'chemo_rv', 'radio_rv')
FACTUAL_OUT = ('cancer_volume', 'chemo_dosage', 'radio_dosage',
               'chemo_application', 'radio_application',
               'chemo_probabilities', 'radio_probabilities', 'death_flags',
               'recovery_flags')
CF_OUT = ('chemo_dosage', 'radio_dosage', 'chemo_application',
          'radio_application')

SIM_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _kernels() -> ctypes.CDLL:
    lib = build.load_library()
    for core in ('factual', 'cf_factual'):
        for suffix in ('f32', 'f64'):
            fn = getattr(lib, f'insite_tumor_{core}_{suffix}')
            fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
            fn.restype = _I
    return lib


def _check(params, rvs, seq_length, window_size, lag, factual):
    """Validate what the kernels take; returns (B, dtype, device)."""
    if len(params) != 10:
        raise ValueError(f'expected the 10 parameter arrays of PARAM_KEYS, '
                         f'got {len(params)}')
    noise = rvs['noise']
    dtype, dev = noise.dtype, noise.device
    if dev.type != 'cuda':
        raise ValueError('the tumour simulator kernels take CUDA tensors '
                         f'only (the host runs sim/tumor.py\'s loops), got '
                         f'{dev}')
    if dtype not in (torch.float32, torch.float64):
        raise TypeError('the tumour simulator kernels take float32 or '
                        f'float64, got {dtype}')
    least = 3 if factual else 2
    if seq_length < least or window_size < 0 or lag < 0:
        raise ValueError(f'seq_length {seq_length} (at least {least}), '
                         f'window_size {window_size} and lag {lag} (at '
                         'least 0) are outside what the loop takes')
    B = params[0].shape[0] if params[0].ndim == 1 else -1
    for i, x in enumerate(params):
        if x.shape != (B,) or x.dtype != dtype or x.device != dev or \
                not x.is_contiguous():
            raise ValueError(f'parameter {i} is {x.dtype} {tuple(x.shape)} '
                             f'on {x.device}; expected a contiguous {dtype} '
                             f'[B] on {dev}')
    # the days read noise[:, t] up to T - 2 (factual) or T - 1 (cf), the
    # other draws up to T - 2
    for name in DRAWS:
        x = rvs[name]
        width = seq_length - (1 if factual or name != 'noise' else 0)
        if x.ndim != 2 or x.shape[0] != B or x.shape[1] < width or \
                x.dtype != dtype or x.device != dev or not x.is_contiguous():
            raise ValueError(f'{name} is {x.dtype} {tuple(x.shape)} on '
                             f'{x.device}; expected a contiguous {dtype} '
                             f'[{B}, >= {width}] on {dev}')
    return B, dtype, dev


def _launch(core, params, rvs, out, extra, B, T, window_size, lag, dtype,
            dev):
    global SIM_LAUNCHES
    suffix = 'f32' if dtype == torch.float32 else 'f64'
    fn = getattr(_kernels(), f'insite_tumor_{core}_{suffix}')
    ptrs = (_P * 10)(*(x.data_ptr() for x in params))
    draws = (_P * 4)(*(rvs[k].data_ptr() for k in DRAWS))
    strides = (ctypes.c_longlong * 4)(*(rvs[k].stride(0) for k in DRAWS))
    outs = (_P * len(out))(*(x.data_ptr() for x in out))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptrs, draws, strides, outs, extra.data_ptr(), B, T,
                 window_size, lag, stream)
    if err != 0:
        raise RuntimeError(f'tumor_{core}_kernel launch failed: '
                           f'cudaError_t {err}')
    SIM_LAUNCHES += 1


def factual(params, rvs: dict, seq_length: int, window_size: int,
            lag: int) -> dict:
    """`sim/tumor.py::factual_core` in one launch. ``params``: the ten [B]
    parameter arrays in `PARAM_KEYS` order; ``rvs``: the draws noise,
    recovery, chemo_rv and radio_rv, each [B, >= T - 1]; all contiguous, of
    one float type, on one card. Returns the trajectory arrays [B, T], the
    sequence lengths [B] int64 and the death and recovery flags [B, T]."""
    B, dtype, dev = _check(params, rvs, seq_length, window_size, lag, True)
    T = seq_length
    out = [torch.empty((B, T), dtype=dtype, device=dev) for _ in FACTUAL_OUT]
    lengths = torch.empty(B, dtype=torch.int64, device=dev)
    _launch('factual', params, rvs, out, lengths, B, T, window_size, lag,
            dtype, dev)
    return dict(zip(FACTUAL_OUT, out), sequence_lengths=lengths)


def cf_factual(params, rvs: dict, seq_length: int, window_size: int,
               lag: int) -> dict:
    """`sim/tumor.py::cf_factual_core` in one launch. ``params`` and
    ``rvs`` as `factual` takes them, noise [B, >= T]. Returns volumes
    [B, T], the dosages and applications [B, T - 1] and ``active``
    [B, T - 1] bool."""
    B, dtype, dev = _check(params, rvs, seq_length, window_size, lag, False)
    T = seq_length
    volumes = torch.empty((B, T), dtype=dtype, device=dev)
    out = [torch.empty((B, T - 1), dtype=dtype, device=dev) for _ in CF_OUT]
    active = torch.empty((B, T - 1), dtype=torch.bool, device=dev)
    _launch('cf_factual', params, rvs, [volumes] + out, active, B, T,
            window_size, lag, dtype, dev)
    return dict(volumes=volumes, **dict(zip(CF_OUT, out)), active=active)
