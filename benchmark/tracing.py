"""Spans, launch records and the reading of the profiler's trace, all
recorded from the benchmark's side.

`Hooks` wraps attributes of the program's modules (a layer's entry
function) for the length of a run. Each wrap can keep the call's result
(what a cell judges) and, in a traced run, time the call as a span of its
layer: a device synchronisation before and after, the host clock between
them, and a ``record_function`` range of the layer's name so that the
profiler's timeline shows which layer the host was in.

`Launches` wraps the port's two kernel launchers and records each launch's
logical shapes (`yardstick.Launch`).

`read_profile` turns a profile into the numbers the per-layer
readers take: device busy time, each kernel's device time and launch
count, the device operations that took most time, and the idle time named
by the span open on the host.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from time import perf_counter

from benchmark.yardstick import Launch, gaps, union_length

KERNELS = {'rollout': 'rollout_kernel<', 'sens': 'rollout_sens_kernel<'}
WINDOW_RANGE = 'bench.traced_window'
OUTSIDE = 'outside layers'


def _sync(device):
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


class Hooks:
    """Wraps of (owner, attribute, layer, keep) while the context is open.
    ``keep``: the key under which the latest result is kept in
    ``self.kept`` ('+key': every result, in a list), or None. With
    ``timed`` each call is a span of ``layer``: its seconds are summed in
    ``self.seconds``."""

    def __init__(self, hooks, device):
        self.hooks = list(hooks)
        self.device = device
        self.timed = False
        self.kept = {}
        self.seconds = defaultdict(float)
        self._open = 0

    def _wrap(self, fn, layer, keep):
        import torch

        def call(*args, **kwargs):
            if not self.timed or self._open:
                out = fn(*args, **kwargs)
            else:
                self._open += 1
                try:
                    with torch.profiler.record_function(layer):
                        _sync(self.device)
                        t0 = perf_counter()
                        out = fn(*args, **kwargs)
                        _sync(self.device)
                        self.seconds[layer] += perf_counter() - t0
                finally:
                    self._open -= 1
            if keep and keep.startswith('+'):
                self.kept.setdefault(keep[1:], []).append(out)
            elif keep:
                self.kept[keep] = out
            return out
        return call

    @contextlib.contextmanager
    def installed(self):
        saved = [(owner, attr, getattr(owner, attr))
                 for owner, attr, _, _ in self.hooks]
        try:
            for (owner, attr, layer, keep), (_, _, fn) in zip(self.hooks,
                                                              saved):
                setattr(owner, attr, self._wrap(fn, layer, keep))
            yield self
        finally:
            for owner, attr, fn in saved:
                setattr(owner, attr, fn)


class Launches:
    """Records the logical shapes of every kernel launch while
    ``recording`` is set, through wraps of the port's two launchers."""

    def __init__(self):
        self.recording = False
        self.launches = []

    def _record(self, kind, library, coefs, statics, arms, active=()):
        B, T = arms.shape
        A, F = coefs.shape[-2:]
        exps = library.exponents()
        self.launches.append(Launch(
            kind, int(B), int(T), int(A), int(F), int(statics.shape[-1]),
            int(coefs.shape[0]) if coefs.ndim == 3 else 1,
            tuple(int(e) for e in exps[:, 0]),
            tuple(int(i) for i in active), coefs.element_size()))

    @contextlib.contextmanager
    def installed(self):
        from insite_tpu_torch.ops import rollout
        roll, sens = rollout._rollout_cuda, rollout._sens_cuda

        def roll_rec(library, coefs, y0, statics, arms, *rest):
            if self.recording:
                self._record('rollout', library, coefs, statics, arms)
            return roll(library, coefs, y0, statics, arms, *rest)

        def sens_rec(library, coefs, y0, statics, arms, dt, active_idx,
                     *rest):
            if self.recording:
                self._record('sens', library, coefs, statics, arms,
                             active_idx)
            return sens(library, coefs, y0, statics, arms, dt, active_idx,
                        *rest)

        rollout._rollout_cuda, rollout._sens_cuda = roll_rec, sens_rec
        try:
            yield self
        finally:
            rollout._rollout_cuda, rollout._sens_cuda = roll, sens


def read_profile(prof, layers) -> dict:
    """From a profile whose traced window is the range
    `WINDOW_RANGE`: the window's length and the device's busy time in it
    (s), each kernel's device seconds and launch count, the ten device
    operations that took most time, and the idle seconds named by the
    layer span open on the host at each gap (`OUTSIDE` where none is).
    Annotation ranges on the device are not operations and are left
    out."""
    import torch
    events = list(prof.events())
    window = [e for e in events if e.name == WINDOW_RANGE
              and e.device_type == torch.autograd.DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f'{len(window)} traced windows in the profile')
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)
              and e.name not in layers and e.name != WINDOW_RANGE]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.name in layers
                   and e.device_type == torch.autograd.DeviceType.CPU)
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in device]
    intervals = [(s, e) for s, e in intervals if e > s]
    by_name = defaultdict(float)
    kernel_s = defaultdict(float)
    kernel_n = defaultdict(int)
    for e in device:
        us = e.time_range.end - e.time_range.start
        by_name[e.name] += us
        for key, prefix in KERNELS.items():
            if prefix in e.name:
                kernel_s[key] += us / 1e6
                kernel_n[key] += 1
    idle = defaultdict(float)
    for g0, g1 in gaps(intervals, w0, w1):
        mid = 0.5 * (g0 + g1)
        name = next((n for s, e, n in spans if s <= mid <= e), OUTSIDE)
        idle[name] += (g1 - g0) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        'window_s': (w1 - w0) / 1e6,
        'busy_s': union_length(intervals) / 1e6,
        'kernel_s': dict(kernel_s),
        'kernel_n': dict(kernel_n),
        'device_ops': [[n[:160], us / 1e6] for n, us in top],
        'idle_gaps': sorted(([n, s] for n, s in idle.items()),
                            key=lambda kv: -kv[1])[:10],
    }
