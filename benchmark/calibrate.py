"""Readings from which a cell's limits are set: the numbers the cell
compares, for the program on ``--count`` seeds and for the control (the
plain reference in the program's place, computed in bfloat16) on
``--control`` seeds, each at the cell's own size, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seed <n>
                                   [--count 12] [--control 3]

One JSON line a reading; the benchmark's own runs do not run this. On a
machine without a CUDA card it runs on the CPU only with ``--patients``
(a tiny size, for tests)."""

from __future__ import annotations

import os

if __name__ == '__main__':
    # as `run.py`: one host thread for OpenMP and BLAS
    for _var in ('OMP_NUM_THREADS', 'OPENBLAS_NUM_THREADS',
                 'MKL_NUM_THREADS'):
        os.environ[_var] = '1'

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from time import perf_counter  # noqa: E402

from benchmark import cell as cells  # noqa: E402
from benchmark.run import WARM_INDEX, task_seed  # noqa: E402


def readings(workload: str, seed: int, count: int, control: int, device,
             patients=None, out=sys.stdout):
    import torch
    cell = cells.load(Path.cwd(), workload)
    entry = cell.entry().Entry(cell.config, cell.traffic, device, patients)
    rows = []
    with entry.hooks.installed():
        entry.task(task_seed(seed, WARM_INDEX))
        for i in range(count + control):
            s = task_seed(seed, i)
            t0 = perf_counter()
            if i < count:
                side = 'program'
                _, task_out, _ = entry.task(s)
            else:
                side = 'control'
                task_out = entry.control(s, torch.bfloat16)
            t1 = perf_counter()
            row = {'side': side, 'seed': s, 'task_s': t1 - t0,
                   **entry.judge(task_out)}
            row['judge_s'] = perf_counter() - t1
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--count', type=int, default=12)
    ap.add_argument('--control', type=int, default=3)
    ap.add_argument('--patients', type=int, default=None)
    args = ap.parse_args(argv)
    import torch
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device('cuda', 0)
    elif args.patients:
        device = torch.device('cpu')
    else:
        print('no CUDA card: give --patients for a CPU run at a tiny size',
              file=sys.stderr)
        return 2
    readings(args.workload, args.seed, args.count, args.control, device,
             args.patients)
    return 0


if __name__ == '__main__':
    sys.exit(main())
