"""Tracing and timing tools, the port of `insite_tpu.utils.profiling`: a
`torch.profiler` trace around a block of code, written as a Chrome trace
(open it in Perfetto or chrome://tracing), a wall-clock timer that waits
for the device before it reads the clock, and a stage logger in the
reference's ``seconds_taken`` idiom.

A trace records CUDA activity (kernel launches and device time) only
where the process has a card; the first profiler session of a process is
the one to rely on for kernel events: a later one in the same process has
been seen to lose them.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

logger = logging.getLogger('insite_tpu_torch')

TRACE_FILE = 'trace.json'


@contextlib.contextmanager
def trace(log_dir='logs/trace'):
    """`torch.profiler` trace (host activity, and the card's where there
    is one) around a block of code::

        with profiling.trace('logs/tb') as prof:
            model.fit(train_f)

    yields the profiler (``prof.key_averages()`` sums by name) and writes
    the Chrome trace to ``log_dir/trace.json`` when the block ends."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir) / TRACE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(path))
    logger.info(f'[trace] profile written to {path}')


def _synchronize(result) -> None:
    """Wait for the device of every tensor in ``result`` (a tensor, or a
    tuple, list or dict of them, nested)."""
    if torch.is_tensor(result):
        if result.device.type == 'cuda':
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (tuple, list)):
        for v in result:
            _synchronize(v)


def time_blocked(fn, *args, reps: int = 1, warmup: int = 1, **kwargs):
    """Wall-clock ``fn(*args, **kwargs)``: ``warmup`` untimed calls (first
    builds and caches), then ``reps`` timed ones, each waiting for the
    device of its result, so that asynchronous launches do not return
    early. Returns (seconds per call, the last result)."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _synchronize(result)
    t0 = time.perf_counter()
    for _ in range(reps):
        result = fn(*args, **kwargs)
        _synchronize(result)
    return (time.perf_counter() - t0) / max(reps, 1), result


@contextlib.contextmanager
def wall_clock_logger(stage: str, log=None):
    """Log '[<stage>] X.XXs' when the block ends, after the card (where
    there is one) has finished the block's work."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    (log or logger).info(f'[{stage}] {time.perf_counter() - t0:.2f}s')
