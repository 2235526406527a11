"""Tracing and timing tools, the port of `insite_tpu.utils.profiling`.

- `trace(log_dir)`: a `torch.profiler` session around a block of code,
  written as a Chrome trace (open it in Perfetto or chrome://tracing).
- The program's tracer: `span` (a named stage), `count` (a named
  counter), `to_host` and `to_device` (the program's device<->host
  crossings), `totals` and `reset`. A span always measures its own host
  duration (``.seconds``), which is what the pipelines' stage times read.
  Everything else is recorded exactly while a `torch.profiler` session
  records in the process (`torch.autograd._profiler_enabled()`): then a
  span is also a ``record_function`` range on the profiler's timeline, on
  the clock of the device's events, and its host time, self time and (for
  a span given a CUDA device) device time are summed by name; counters and
  crossings are summed too. With no profiler recording, a span costs a
  clock pair and one flag test, and nothing is kept. `trace` clears the
  totals on entry, so those read after its block are the block's.
- `time_blocked`, a wall-clock timer that waits for the device before it
  reads the clock, and `wall_clock_logger`, a stage logger in the
  reference's ``seconds_taken`` idiom.

A trace records CUDA activity (kernel launches and device time) only
where the process has a card; the first profiler session of a process is
the one to rely on for kernel events: a later one in the same process has
been seen to lose them.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import time
from collections import defaultdict
from pathlib import Path
from time import perf_counter

import torch
from torch.profiler import ProfilerActivity, profile

logger = logging.getLogger('insite_tpu_torch')

TRACE_FILE = 'trace.json'

# the crossing counters `to_host` and `to_device` keep
D2H_READS, D2H_BYTES = 'd2h.reads', 'd2h.bytes'
H2D_COPIES, H2D_BYTES = 'h2d.copies', 'h2d.bytes'

_recording = torch.autograd._profiler_enabled
_open = []                       # the open spans, innermost last
_spans = {}                      # name -> [calls, host_s, self_s]
_counters = defaultdict(int)
_pending = []                    # (name, start, end) CUDA events unread
_device_s = defaultdict(float)   # name -> device seconds read so far


class span:
    """A named stage of the program::

        with profiling.span('fit.qr', device=A.device) as s:
            ...
        s.seconds          # the block's host seconds, always

    Keeps the host clock at entry and exit (``start``, ``end``) and the
    enclosing span (``parent``). While a profiler records (see the
    module's docstring) the block is also a ``record_function`` range of
    ``name``, and its host seconds and self seconds (host seconds less
    those of the spans opened inside it) are added to the totals of
    ``name``; given a CUDA ``device``, a pair of CUDA events on that
    device's current stream times the block on the device too, read when
    `totals` is called (no synchronisation inside the block). A span
    opened inside an open span of the same name records nothing of its
    own: its time is already the outer one's. Spans are opened and closed
    on one thread, in nested order."""

    __slots__ = ('name', 'device', 'parent', 'start', 'end', '_child_s',
                 '_range', '_events')

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.parent = None
        self.start = self.end = None
        self._child_s = 0.0
        self._range = self._events = None

    @property
    def seconds(self) -> float:
        """Host seconds from entry to exit."""
        return self.end - self.start

    def _recorded(self) -> bool:
        return self._range is not None

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        if _recording() and all(s.name != self.name for s in _open):
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if self.device is not None and \
                    torch.device(self.device).type == 'cuda':
                stream = torch.cuda.current_stream(self.device)
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(stream)
        _open.append(self)
        self.start = perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = perf_counter()
        _open.pop()
        seconds = self.end - self.start
        if self.parent is not None:
            # an unrecorded span hands its children's time on, so that
            # self times add up to the recorded spans' host times
            self.parent._child_s += (seconds if self._recorded()
                                     else self._child_s)
        if self._recorded():
            if self._events is not None:
                self._events[1].record(
                    torch.cuda.current_stream(self.device))
                _pending.append((self.name,) + self._events)
                _read_finished()
            self._range.__exit__(*exc)
            t = _spans.setdefault(self.name, [0, 0.0, 0.0])
            t[0] += 1
            t[1] += seconds
            t[2] += seconds - self._child_s
        return False

    def __call__(self, fn):
        """The decorator form: each call of ``fn`` is a span of this
        span's name and device."""
        name, device = self.name, self.device

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)
        return wrapped


def _read_finished() -> None:
    """Add the device seconds of the event pairs the device has passed,
    oldest first, without waiting for the others."""
    while _pending and _pending[0][2].query():
        name, start, end = _pending.pop(0)
        _device_s[name] += start.elapsed_time(end) / 1e3


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _recording():
        _counters[name] += n


def _nbytes(t) -> int:
    return t.nelement() * t.element_size()


def to_host(t):
    """``t.cpu()``. While a profiler records, a tensor that is not on the
    host counts one device->host read (each one waits for the device's
    stream to reach it) and its bytes."""
    if _recording() and t.device.type != 'cpu':
        _counters[D2H_READS] += 1
        _counters[D2H_BYTES] += _nbytes(t)
    return t.cpu()


def to_device(x, device, dtype=None):
    """``torch.as_tensor(x, dtype=dtype, device=device)``. While a
    profiler records, a copy from the host (an array, a list, a number or
    a host tensor) to a device that is not the host counts one
    host->device copy and the bytes of the result."""
    out = torch.as_tensor(x, dtype=dtype, device=device)
    if _recording() and out.device.type != 'cpu' and not (
            torch.is_tensor(x) and x.device.type != 'cpu'):
        _counters[H2D_COPIES] += 1
        _counters[H2D_BYTES] += _nbytes(out)
    return out


def totals() -> dict:
    """What was recorded since the last `reset`: for each span name
    ``{'calls', 'host_s', 'self_s', 'device_s'}`` (``device_s`` None for
    a span with no CUDA device), and for each counter its value. Waits for
    the device events still pending."""
    while _pending:
        _pending[0][2].synchronize()
        _read_finished()
    out = {name: {'calls': calls, 'host_s': host_s, 'self_s': self_s,
                  'device_s': _device_s.get(name)}
           for name, (calls, host_s, self_s) in _spans.items()}
    out.update(_counters)
    return out


def reset() -> None:
    """Forget every span total, counter and pending device event."""
    _spans.clear()
    _counters.clear()
    _pending.clear()
    _device_s.clear()


@contextlib.contextmanager
def trace(log_dir='logs/trace'):
    """`torch.profiler` trace (host activity, and the card's where there
    is one) around a block of code::

        with profiling.trace('logs/tb') as prof:
            model.fit(train_f)
        profiling.totals()      # the block's spans and counters

    yields the profiler (``prof.key_averages()`` sums by name) and writes
    the Chrome trace to ``log_dir/trace.json`` when the block ends. The
    tracer's totals are cleared on entry."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = Path(log_dir) / TRACE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    reset()
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
