"""Runs one cell of the benchmark once and prints one JSON line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`. The cell's
configuration, traffic mix and limits are found by name (`cell.py`).

A run: set-up (imports, the kernel library, a warm-up of the cell's own
task at its own shapes on seeds no measured task gets), then a closed
loop for ``--seconds``: one researcher's sweep, the next task sent when
the last returns, every task on a fresh seed derived from ``--seed`` and
its index. A sample of the completed tasks, drawn from the seed, is kept
and judged against the plain reference after the window, once the peak
memory is read. With ``--trace 1`` every task's layer calls are spans and
the first `TRACE_SLICE_S` seconds of the window run under the profiler
(the rooflines, the whole task's share of the peak and the idle share
come from that slice, the layers' times from the tasks after it); the
line then carries the per-layer metrics instead of the end-to-end ones.

Without a CUDA card, or with fewer than the cell asks for, the run exits
with 2 and prints no result; with the JAX package or JAX loaded, with 3.
"""

from __future__ import annotations

from time import perf_counter

T_START = perf_counter()

import os  # noqa: E402

if __name__ == '__main__':
    # one host thread for OpenMP and BLAS, set before numpy and torch load:
    # the program's host work is serial, and pools beside it add jitter
    for _var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS',
                 'MKL_NUM_THREADS'):
        os.environ[_var] = '1'

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import cell as cells  # noqa: E402

TRACE_SLICE_S = 4.0
WARM_INDEX = 1 << 40          # warm-up tasks' indices: no window task's
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'insite_tpu')


def task_seed(seed: int, index: int) -> int:
    """The seed of task ``index`` of a run seeded ``seed``: 32 bits, as
    the program's host generators take them."""
    return int(np.random.SeedSequence([seed % 2**64, index])
               .generate_state(1)[0])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m for m in sys.modules
                   if m.split('.')[0] in FORBIDDEN})


class Sample:
    """A uniform sample of ``k`` of the completed tasks' outputs (reservoir
    sampling, drawn from the run's seed)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([seed % 2**64, 1])
        self.seen = 0
        self.kept = []

    def offer(self, outputs):
        if len(self.kept) < self.k:
            self.kept.append(outputs)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.kept[j] = outputs
        self.seen += 1


class CellRun:
    """One run of a cell on ``device``: `setup`, `window`, `judge`.
    ``patients`` overrides the traffic's task size (tests at a tiny size
    on the CPU)."""

    def __init__(self, cell: cells.Cell, seed: int, device, patients=None):
        self.cell, self.seed, self.device = cell, seed, device
        self.entry = cell.entry().Entry(cell.config, cell.traffic, device,
                                          patients)
        self.sample = Sample(int(cell.traffic['checked_tasks']), seed)
        self.attempted = self.failed = self.patients = 0
        self.task_s = []
        self.trace = None

    def _sync(self):
        import torch
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def setup(self):
        """Warm the cell's task at its own shapes, on warm-up seeds."""
        with self.entry.hooks.installed():
            for k in range(int(self.cell.traffic['warmup_tasks'])):
                self.entry.task(task_seed(self.seed, WARM_INDEX + k))
        self._sync()

    def window(self, seconds: float, trace: bool):
        """The closed loop for ``seconds``; with ``trace`` the spans, and
        the profiler over the first `TRACE_SLICE_S` seconds."""
        import torch
        from benchmark.tracing import WINDOW_RANGE, Launches, read_profile
        cuda = self.device.type == 'cuda'
        launches = Launches()
        prof = ctx = None
        profiled = (0, {})
        slice_work, slice_tasks = [], 0
        with self.entry.hooks.installed(), launches.installed():
            self.entry.hooks.timed = trace
            if trace and cuda:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                ctx = torch.profiler.record_function(WINDOW_RANGE)
                ctx.__enter__()
                launches.recording = True
            t0 = perf_counter()
            stop = t0 + seconds
            i = 0
            while i == 0 or perf_counter() < stop:
                events = None
                if cuda:
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                self.attempted += 1
                try:
                    n, out, work = self.entry.task(task_seed(self.seed, i))
                except Exception as e:                    # noqa: BLE001
                    # a task that raises is a failed answer: count it, say
                    # why, and go on with the next one
                    self.failed += 1
                    print(f'task {i} failed: {e!r}', file=sys.stderr)
                    n, out, work = 0, None, []
                if cuda:
                    events[1].record()
                self._sync()
                i += 1
                if out is not None:
                    self.patients += n
                    self.sample.offer(out)
                    self.task_s.append(events)
                if ctx is not None:
                    slice_work += work
                    slice_tasks += 1
                    if perf_counter() - t0 >= min(TRACE_SLICE_S, seconds):
                        slice_wall = perf_counter() - t0
                        ctx.__exit__(None, None, None)
                        prof.__exit__(None, None, None)
                        ctx = None
                        launches.recording = False
                        profiled = (self.attempted - self.failed,
                                    dict(self.entry.hooks.seconds))
            self.window_s = perf_counter() - t0
            if ctx is not None:
                slice_wall = self.window_s
                ctx.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                launches.recording = False
            self.entry.hooks.timed = False
        if prof is not None:
            p = read_profile(prof, _layers(self.entry))
            p.update(tasks=slice_tasks, wall_s=slice_wall, work=slice_work,
                     launches=launches.launches)
            # the layers' spans of the tasks after the profiled slice, where
            # the profiler's own host cost is not in them
            done, seconds = self.attempted - self.failed, \
                dict(self.entry.hooks.seconds)
            if done > profiled[0]:
                seconds = {k: v - profiled[1].get(k, 0.0)
                           for k, v in seconds.items()}
                done -= profiled[0]
            self.trace = {'tasks': done, 'layer_s': seconds, 'slice': p}
        if cuda:
            self.task_s = [a.elapsed_time(b) / 1e3 for a, b in self.task_s]

    def correct(self, readings: dict) -> bool:
        """Every task answered, some judged, and every compared number
        within its limit."""
        limits = self.cell.limits
        return (self.failed == 0 and len(self.sample.kept) > 0 and
                all(k in readings and readings[k] <= v
                    for k, v in limits.items()))

    def judge(self) -> dict:
        """The worst reading of each compared number over the sampled
        tasks."""
        worst = {}
        for out in self.sample.kept:
            for k, v in self.entry.judge(out).items():
                cur = worst.get(k, v)
                # a reading that is not a number stays the worst
                worst[k] = cur if cur != cur or (v == v and v <= cur) else v
        return worst


def _layers(entry):
    return tuple(sorted({layer for _, _, layer, _ in entry.hooks.hooks}))


def _plain(x):
    """A reading as JSON can carry it: a number not finite as its name."""
    if isinstance(x, float) and not np.isfinite(x):
        return str(x)
    return x


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return 'unknown'


def end_to_end(cell_run: CellRun, setup_s: float, peak_window: int) -> dict:
    values = {
        'setup_s': setup_s,
        'patients_per_s': cell_run.patients / cell_run.window_s,
        'peak_device_gib': peak_window / 2**30,
    }
    if cell_run.task_s:
        values['cohort_s_p95'] = float(np.percentile(cell_run.task_s, 95))
    return values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.load(Path.cwd(), args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA card(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' available: no result', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device('cuda', 0)
    card_line = card()
    print(f'card: {card_line}', file=sys.stderr)

    cell_run = CellRun(cell, args.seed, device)
    cell_run.setup()
    setup_s = perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    cell_run.window(args.seconds, bool(args.trace))
    peak_window = torch.cuda.max_memory_allocated(device)
    memory_peak = max(setup_peak, peak_window)
    cell_run.entry.hooks.kept.clear()
    torch.cuda.empty_cache()

    t_judge = perf_counter()
    readings = cell_run.judge()
    print(f'run: setup {setup_s:.3f} s, window {cell_run.window_s:.3f} s, '
          f'{cell_run.attempted} tasks, {len(cell_run.sample.kept)} judged in '
          f'{perf_counter() - t_judge:.3f} s', file=sys.stderr)
    if len(cell_run.task_s) >= 4:
        q = np.percentile(cell_run.task_s, [10, 50, 90, 100])
        k = len(cell_run.task_s) // 4
        print('tasks: s at p10 p50 p90 max ' +
              ' '.join(f'{x:.4f}' for x in q) + '; first and last quarter '
              f'means {np.mean(cell_run.task_s[:k]):.4f} '
              f'{np.mean(cell_run.task_s[-k:]):.4f}', file=sys.stderr)
    limits = cell.limits
    correct = cell_run.correct(readings)

    found = forbidden_modules()
    if found:
        print(f'loaded in the run: {", ".join(found)}: no result',
              file=sys.stderr)
        return 3

    device_info = {'platform': 'gpu',
                   'kind': torch.cuda.get_device_name(device),
                   'count': cell.chips, 'memory_peak_bytes': memory_peak}
    line = {'correct': bool(correct), 'attempted': cell_run.attempted,
            'failed': cell_run.failed}
    if args.trace:
        t = cell_run.trace
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m['name'])(t)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        device_info.update(busy_s=t['slice']['busy_s'],
                           window_s=t['slice']['window_s'])
        line.update(metrics=metrics, device=device_info,
                    breakdown={'device_ops': t['slice']['device_ops'],
                               'idle_gaps': t['slice']['idle_gaps']})
    else:
        values = end_to_end(cell_run, setup_s, peak_window)
        line.update(metrics={m['name']: {'value': values[m['name']],
                                         'unit': m['unit']}
                             for m in cell.end_to_end},
                    device=device_info)
    line['card'] = card_line
    checks = {k: {'value': _plain(readings.get(k)), 'limit': v}
              for k, v in limits.items()}
    line['checks'] = checks
    print(json.dumps(line), flush=True)
    for k, c in checks.items():
        print(f'check {k} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    return 0


if __name__ == '__main__':
    os.environ.setdefault('USE_FLAX', '0')
    sys.exit(main())
