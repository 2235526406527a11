#!/usr/bin/env python3
"""Time the port's two rollout kernels at the main path's shapes on one
NVIDIA card.

    python3 tools/time_rollout_kernels.py [--root DIR]

Imports `insite_tpu_torch` from DIR (default: this checkout), so that an
unpacked older tree can be timed by the same script on the same card.
Shapes, f32: the north star (B=10,000, T=59, per-patient coefficients) and
the EQ_4 main table's n-step (B=59,000, T=64, per-row coefficients) and
1-step (B=11,800, T=59, shared coefficients) test sets, built as
`chip_smoke.py` builds them; with ``--family`` also the shapes of the rest
of the SINDy family (`chip_smoke.py::family_cases`: the folded one-ODE
models, a chunk of the degree-4 fine-tune, the recovery's validation
cohort, 100 coordinates in two groups). For each kernel and shape it
prints the device time of one call
(torch.profiler, median of 20 calls, one session for all shapes), the
bound and the call time (CUDA events, median of 20 calls), then one JSON
line that names the timed tree.
"""

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=str(REPO),
                    help='the tree whose insite_tpu_torch is timed')
    ap.add_argument('--family', action='store_true',
                    help="also the rest of the SINDy family's shapes")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    # the timed tree first; tools/ (whose queue.py shadows the stdlib's) out
    sys.path[0] = str(root)
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  REPO / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch
    if not torch.cuda.is_available():
        print('needs an NVIDIA card', file=sys.stderr)
        return 1
    import insite_tpu_torch
    from insite_tpu_torch.ops import build, rollout
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda', 0)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f'{smi}; timing {insite_tpu_torch.__file__}')
    build.load_library()

    n_step, one_step = cs.table_cases('EQ_4_D', device, (5, 6))
    cases = {'northstar': cs.eq4_case(cs.N_PATIENTS, 59, True, 0),
             'nstep_b59000_t64': n_step,
             '1step_shared_b11800_t59': one_step}
    if args.family:
        cases.update(cs.family_cases(device))
    result = {'root': str(root), 'card': smi}
    dev = cs.kernel_times(cases, device)
    for tag, case in cases.items():
        a = cs.tensors(case, torch.float32, device)
        act, clip = case['active_idx'], case['y_clip']
        calls = {'rollout': lambda: rollout.batched_rollout(*a, y_clip=clip),
                 'sens': lambda: rollout.rollout_with_sens(*a, act,
                                                           y_clip=clip)}
        for key, fn in calls.items():
            ms = cs.time_ms(fn)
            t = dev[tag]
            result[f'{key}_{tag}'] = {
                'ms': ms, 'device_ms': t[f'{key}_device_ms'],
                'bound_ms': t[f'{key}_bound_ms'],
                'bound_by': t[f'{key}_bound_by']}
            print(f'{tag:40s} {key:8s} call {ms:.4f} ms', flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
