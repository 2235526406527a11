#!/usr/bin/env python3
"""The vectorized neural columns' times on one NVIDIA card, at the
reference's size and a few epochs: what `chip_smoke.py`'s phase-12 epochs
are set from.

    python3 tools/vectorized_neural_epoch_times.py [--epochs 2]
        [--methods ct crn edct rmsn gnet] [--datasets EQ_4_D]
        [--seeds 10] [--standard] [--profile DIR]

Runs the port's `vectorized_sweep` (f32, 1,000 / 100 / 100 patients, the
JAX package's config defaults, debug mode) one column at a time and prints
per column its wall time between device synchronisations, the seconds of
each stage's stacked fit (each network's; a fit's seconds over its epochs
is what an epoch takes, rmsn's encoder trains 3x the epochs) and the peak
of `torch.cuda.max_memory_allocated`. With ``--standard`` it also runs
one standard run per method on the first dataset at the same epochs
(`chip_smoke.run_sweep`), whose fits give the standard epoch to compare
with. Every method first runs one untimed small column (2 seeds, 40 / 4
/ 4 patients, 1 epoch), which loads the card's kernels. With ``--profile
DIR`` each column also runs under cProfile (the host's time by function:
the columns are host-bound), written to ``DIR/<dataset>_<method>.pstats``
with the 25 largest cumulative entries printed.
"""

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
from time import perf_counter

# the repository root in place of tools/ (whose queue.py would shadow the
# standard library's)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--epochs', type=int, default=2)
    ap.add_argument('--methods', nargs='+',
                    default=['ct', 'crn', 'edct', 'rmsn', 'gnet'])
    ap.add_argument('--datasets', nargs='+', default=['EQ_4_D'])
    ap.add_argument('--seeds', type=int, default=10)
    ap.add_argument('--standard', action='store_true')
    ap.add_argument('--profile', default=None)
    args = ap.parse_args()

    import torch

    from insite_tpu_torch.harness import vectorized_neural as vn
    from insite_tpu_torch.harness.config import RunConfig
    from insite_tpu_torch.harness.runner import vectorized_sweep
    if not torch.cuda.is_available():
        sys.exit('vectorized_neural_epoch_times: needs an NVIDIA card')
    dev = torch.device('cuda', 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          torch.version.cuda, flush=True)

    fits = []

    def timed(fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize(dev)
            t0 = perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            fits.append(round(perf_counter() - t0, 4))
            return out
        return wrapper

    for method in args.methods:
        vectorized_sweep(RunConfig(methods=(method,), datasets=('EQ_4_D',),
                                   seed_runs=2, epochs=1, train_samples=40,
                                   val_samples=4, test_samples=4,
                                   debug_mode=True), device=dev)
    vn._fit_br_stage = timed(vn._fit_br_stage)
    vn._fit_simple_stage = timed(vn._fit_simple_stage)
    for ds in args.datasets:
        for method in args.methods:
            cfg = RunConfig(methods=(method,), datasets=(ds,),
                            seed_runs=args.seeds, epochs=args.epochs,
                            debug_mode=True)
            fits.clear()
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            prof = cProfile.Profile() if args.profile else None
            t0 = perf_counter()
            if prof:
                prof.enable()
            rows, _ = vectorized_sweep(cfg, device=dev)
            torch.cuda.synchronize(dev)
            wall = perf_counter() - t0
            if prof:
                prof.disable()
                os.makedirs(args.profile, exist_ok=True)
                path = os.path.join(args.profile, f'{ds}_{method}.pstats')
                prof.dump_stats(path)
                pstats.Stats(path).sort_stats('cumulative').print_stats(25)
            one = sum(r['encoder_test_rmse_orig'] for r in rows) / len(rows)
            print(json.dumps({
                'column': f'{ds} {method}', 'seeds': args.seeds,
                'epochs': args.epochs, 'wall_s': round(wall, 4),
                'stage_fit_s': list(fits),
                'peak_mib': round(torch.cuda.max_memory_allocated(dev)
                                  / 2**20, 1),
                'mean_1_step': one}), flush=True)
    if args.standard:
        import chip_smoke as cs
        cs.run_sweep(dev, args.datasets[:1], 'standard', tuple(args.methods),
                     model_overrides={m: {'epochs': args.epochs}
                                      for m in args.methods})


if __name__ == '__main__':
    main()
