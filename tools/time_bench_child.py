"""Wall time of the port's bench as a user starts it, from one or more
trees of the repository: ``python -m insite_tpu_torch.bench`` (fused,
10,000 patients, no BENCH_ setting) in a fresh interpreter, and ``python
-c 'import insite_tpu_torch.bench'``, the import alone. The trees take
turns, forward then in reverse, ``--reps`` times, so that each sees the
card in the same states; an untimed bench run per tree first builds its
kernels.

    python3 tools/time_bench_child.py [--reps 2] ROOT [ROOT ...]

Prints the card's name and power limit, each run's walls (seconds from
the child's start to its end), and last a JSON line with each tree's
walls and their medians. Needs a card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from time import perf_counter


def child_wall(root, args):
    """Seconds from the start to the end of ``python args`` in ``root``,
    which must exit 0."""
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    t0 = perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = perf_counter() - t0
    if out.returncode != 0:
        raise SystemExit(f'{root}: {args} exited {out.returncode}:\n'
                         f'{out.stderr[-4000:]}')
    return wall


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('roots', nargs='+', type=Path)
    p.add_argument('--reps', type=int, default=2)
    args = p.parse_args(argv)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    bench = ['-m', 'insite_tpu_torch.bench']
    imports = ['-c', 'import insite_tpu_torch.bench']
    for root in args.roots:
        print(f'{root}: warm-up (kernel build) {child_wall(root, bench):.4f}'
              ' s', flush=True)
    walls = {str(r): {'bench': [], 'import': []} for r in args.roots}
    for rep in range(args.reps):
        order = args.roots if rep % 2 == 0 else args.roots[::-1]
        for root in order:
            b, i = child_wall(root, bench), child_wall(root, imports)
            walls[str(root)]['bench'].append(b)
            walls[str(root)]['import'].append(i)
            print(f'{root}: bench child {b:.4f} s, import {i:.4f} s',
                  flush=True)
    print(json.dumps({root: {**w, 'bench_median': statistics.median(
        w['bench']), 'import_median': statistics.median(w['import'])}
        for root, w in walls.items()}))


if __name__ == '__main__':
    main()
