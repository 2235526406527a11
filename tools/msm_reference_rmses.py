#!/usr/bin/env python3
"""The JAX package's msm main table and its three INSIGHT sweeps at one
seed, in float64 on the CPU: the accuracy anchors that `chip_smoke.py`
phase 8 holds the PyTorch port's card run to (`MSM_REF`, `INSIGHT_REF`).

    JAX_PLATFORMS=cpu python3 tools/msm_reference_rmses.py [--seed 0]

Runs `insite_tpu.harness.runner.run_experiment` at the reference's size
(1,000 / 100 / 100 patients, seq 60, horizon 5) and prints one JSON object:

- ``"msm"``: "<dataset>" -> the msm run's 1-step `encoder_test_rmse_orig`
  and its `decoder_test_rmse_{2..6}-step` (%), on EQ_4_A..D, cancer_sim and
  EQ_5_A..D at gamma 2;
- ``"INSIGHT_CONFOUNDING"`` (EQ_4_D, gamma over `RunConfig.domain_confs`),
  ``"INSIGHT_NOISE"`` (EQ_4_B, `noise_scale` over `RunConfig.noise_scales`)
  and ``"INSIGHT_LESS_SAMPLES"`` (EQ_4_D, `train_samples` over
  `RunConfig.train_sample_grid`): "<setting> <method>" -> the same metrics
  for sindy, insite and msm, enumerated as the JAX sweep enumerates them.

Every entry carries the run's wall time on the host.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MSM_DATASETS = ('EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D', 'cancer_sim',
                'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D')
INSIGHT_METHODS = ('sindy', 'insite', 'msm')
METRICS = ('encoder_test_rmse_orig',) + tuple(
    f'decoder_test_rmse_{k}-step' for k in range(2, 7))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import Experiment, run_experiment

    base = RunConfig(metrics_jsonl='')

    def run(ds, method, gamma, experiment, **overrides):
        t0 = time.perf_counter()
        row = run_experiment(ds, method, args.seed, gamma,
                             dataclasses.replace(base, **overrides),
                             experiment)
        out = {m: float(row[m]) for m in METRICS}
        out['host_seconds'] = time.perf_counter() - t0
        return out

    def note(part, key, entry):
        print(f'{part} {key}: {entry}', file=sys.stderr, flush=True)
        return entry

    out = {'msm': {ds: note('msm', ds, run(ds, 'msm', base.domain_conf,
                                           Experiment.MAIN_TABLE))
                   for ds in MSM_DATASETS}}
    sweeps = (
        ('INSIGHT_CONFOUNDING', 'EQ_4_D', base.domain_confs,
         lambda g: (float(g), {})),
        ('INSIGHT_NOISE', 'EQ_4_B', base.noise_scales,
         lambda g: (base.domain_conf, {'noise_scale': g})),
        ('INSIGHT_LESS_SAMPLES', 'EQ_4_D', base.train_sample_grid,
         lambda g: (base.domain_conf, {'train_samples': g})))
    for name, ds, grid, setting in sweeps:
        out[name] = {}
        for g in grid:
            gamma, overrides = setting(g)
            for method in INSIGHT_METHODS:
                key = f'{g:g} {method}'
                out[name][key] = note(name, key, run(
                    ds, method, gamma, Experiment[name], **overrides))
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
