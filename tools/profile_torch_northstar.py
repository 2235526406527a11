#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's north star, on one NVIDIA
card.

    python3 tools/profile_torch_northstar.py [--trace northstar_trace.json]

After an untimed warm-up, runs the 10,000-patient EQ_4_D `fused_northstar`
once without the profiler (per-stage wall times) and once under
torch.profiler, and prints the card's name and power limit, device time by
kernel, and the device's busy and idle shares of the profiled run (the
union of device-event intervals over the run's wall time; the profiler's
own host overhead makes the idle share an upper bound).
"""

import argparse
import subprocess
import sys
from collections import defaultdict
from pathlib import Path
from time import perf_counter

# the repo root in place of tools/, whose queue.py shadows the stdlib's
sys.path[0] = str(Path(__file__).resolve().parent.parent)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from insite_tpu_torch.harness.northstar import fused_northstar  # noqa: E402

N_PATIENTS = 10_000
STAGES = ('t_sim_design', 't_stlsq', 't_finetune', 't_metric', 'total')


def busy_us(events):
    """Length of the union of the events' [start, end] intervals (us)."""
    total, end = 0.0, float('-inf')
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in events):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--trace', default=None,
                    help='write a Chrome trace of the profiled run here')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs an NVIDIA card', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())

    def run():
        return fused_northstar(N_PATIENTS, seed=0, equation_name='EQ_4_D',
                               projection_horizon=1, device=device)

    fused_northstar(64, seed=1, device=device)
    r = run()
    print('stages (s, no profiler): ' + ', '.join(
        f'{k} {r[k]:.4f}' for k in STAGES))

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall_us = (perf_counter() - t0) * 1e6
    print('stages (s, profiled):    ' + ', '.join(
        f'{k} {r[k]:.4f}' for k in STAGES))
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print('the profiler recorded no device events')
        return 1
    by_name = defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.end - e.time_range.start
    busy = busy_us(dev)
    print(f'profiled wall {wall_us / 1e3:.3f} ms; device busy '
          f'{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), idle '
          f'{100 * (1 - busy / wall_us):.1f} %')
    print(f'{"device ms":>10} {"calls":>6}  kernel')
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, us) in ranked[:20]:
        print(f'{us / 1e3:10.4f} {n:6d}  {name[:100]}')
    if args.trace:
        Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == '__main__':
    sys.exit(main())
