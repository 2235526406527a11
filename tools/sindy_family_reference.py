#!/usr/bin/env python3
"""The JAX package's values for the rest of the SINDy family at one seed, in
float64 on the CPU: the accuracy anchors that `chip_smoke.py` phase 7 holds
the PyTorch port's card run to (`SINDY_FAMILY_REF` there).

    JAX_PLATFORMS=cpu python3 tools/sindy_family_reference.py [--seed 0] \
        [--groups wsindy one_ode degree4 recovery]

Runs `insite_tpu.harness.runner.run_experiment` at the reference's size
(1,000 / 100 / 100 patients, seq 60, horizon 5, gamma 2) for

- wsindy      MAIN_TABLE, method wsindy, on EQ_4_A..D, cancer_sim, EQ_5_A..D
- one_ode     ABLATION_ONE_ODE, sindy and insite, on EQ_4_D and cancer_sim
- degree4     ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS, sindy, on EQ_4_D
              (``--degree4-insite`` adds insite: its jvp-through-scan
              fine-tune of 70,800 rows took a CPU host about 3 of the
              whole command's 8 minutes)
- recovery    INSIGHT_RECOVER_PARAMETRIC_DIST, insite, on EQ_4_D

and prints one JSON object mapping "<experiment> <dataset> <method>" to the
1-step `encoder_test_rmse_orig`, the `decoder_test_rmse_6-step` (%), the
equation string, the `recover_arm<a>_pearson_r` values where the run has
them, and the run's wall time on the host. A run that raises is recorded
with its error.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

EQ4 = ('EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D')
TUMOR = ('cancer_sim', 'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D')
GROUPS = {
    'wsindy': [('MAIN_TABLE', ds, 'wsindy') for ds in EQ4 + TUMOR],
    'one_ode': [('ABLATION_ONE_ODE', ds, m)
                for ds in ('EQ_4_D', 'cancer_sim')
                for m in ('sindy', 'insite')],
    'degree4': [('ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS', 'EQ_4_D', 'sindy')],
    'recovery': [('INSIGHT_RECOVER_PARAMETRIC_DIST', 'EQ_4_D', 'insite')],
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--groups', nargs='+', default=list(GROUPS),
                   choices=list(GROUPS))
    p.add_argument('--degree4-insite', action='store_true')
    args = p.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import Experiment, run_experiment

    cells = [c for g in args.groups for c in GROUPS[g]]
    if args.degree4_insite:
        cells.append(('ABLATION_MORE_COMPLEX_BASIS_FUNCTIONS', 'EQ_4_D',
                      'insite'))
    out = {}
    for experiment, ds, method in cells:
        key = f'{experiment} {ds} {method}'
        t0 = time.perf_counter()
        try:
            row = run_experiment(ds, method, args.seed, 2.0,
                                 RunConfig(metrics_jsonl=''),
                                 Experiment[experiment])
            out[key] = {
                'encoder_test_rmse_orig':
                    float(row['encoder_test_rmse_orig']),
                'decoder_test_rmse_6-step':
                    float(row['decoder_test_rmse_6-step']),
                'global_equation_string': row['global_equation_string']}
            out[key].update({k: float(v) for k, v in row.items()
                             if k.endswith('pearson_r')})
        except Exception as e:
            out[key] = {'error': f'{type(e).__name__}: {e}'}
        out[key]['host_seconds'] = time.perf_counter() - t0
        print(f'{key}: {out[key]}', file=sys.stderr, flush=True)
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
