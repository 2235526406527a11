#!/usr/bin/env python3
"""The JAX package's vectorized seed columns on the CPU: the accuracy
anchors that `chip_smoke.py` phase 11 holds the PyTorch port's
`--vectorized` columns to (`VECTORIZED_REF`, `VECTORIZED_BANDS`).

    JAX_PLATFORMS=cpu python3 tools/vectorized_reference_rmses.py \\
        [--seeds 10] [--seed-chunk 2]

Runs, at phase 11's size (1,000 training / 100 test patients, seq 60,
horizon 5, gamma 2, JAX's default float32 on the CPU, as the columns run
in float32 on the card):

- `insite_tpu.harness.vectorized` on EQ_4_D for sindy, insite and wsindy
  (the program of `vectorized_eq4_sweep`, ``dedup_one_step=False``), on
  cancer_sim and EQ_5_D for sindy and insite (`vectorized_tumor_sweep`),
  and INSIGHT_CONFOUNDING for insite at gamma 0 and 4 (the program of
  `vectorized_confounding_sweep`, which fine-tunes the 1-step rows once
  per prefix);
- `insite_tpu.harness.vectorized_msm.vectorized_msm_sweep` on EQ_4_D and
  cancer_sim (host float64, 100 Newton iterations).

The EQ_4 programs run ``--seed-chunk`` seeds at a time (seeds never couple
in the vmap, so a chunk changes no number and bounds the host memory).

Prints two lines: ``VECTORIZED_REF = {...}``, by column, the per-seed
1-step `encoder_test_rmse_orig` and `decoder_test_rmse_{2..6}-step` (%),
their means and the column's wall time on the host; and
``VECTORIZED_BANDS = {...}``, by column, the two-sided (lower, upper)
factors on the mean at 1 step and at 2..6 steps, built as `chip_smoke.py`'s
neural bands are: the per-seed values as ratios to their column's mean,
half the lowest ratio rounded down to 0.05 and 1.25x the highest rounded
up to 0.5.
"""

import argparse
import json
import math
import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

METRICS = ('encoder_test_rmse_orig',) + tuple(
    f'decoder_test_rmse_{k}-step' for k in range(2, 7))
EQ4_COLUMNS = (('EQ_4_D', 'sindy'), ('EQ_4_D', 'insite'),
               ('EQ_4_D', 'wsindy'))
TUMOR_COLUMNS = (('cancer_sim', 'sindy'), ('cancer_sim', 'insite'),
                 ('EQ_5_D', 'sindy'), ('EQ_5_D', 'insite'))
MSM_COLUMNS = (('EQ_4_D', 'msm'), ('cancer_sim', 'msm'))
CONFOUNDING_GAMMAS = (0.0, 4.0)


def band(ratios):
    """(lower, upper) factors from per-seed ratios to their mean."""
    lo = math.floor(0.5 * ratios.min() / 0.05) * 0.05
    hi = math.ceil(1.25 * ratios.max() / 0.5) * 0.5
    return round(lo, 2), hi


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seeds', type=int, default=10)
    p.add_argument('--seed-chunk', type=int, default=2)
    args = p.parse_args(argv)
    import jax
    import jax.numpy as jnp
    import numpy as np
    jax.config.update('jax_platforms', 'cpu')
    from insite_tpu.harness.config import SINDY_ALPHA, sindy_params_for
    from insite_tpu.harness.vectorized import (_sweep_jit,
                                               vectorized_tumor_sweep)
    from insite_tpu.harness.vectorized_msm import vectorized_msm_sweep

    S, ph = args.seeds, 5
    n_train, n_test, seq_length = 1000, 100, 60
    ref = {}

    def eq4_program(method, gamma, dedup):
        thr, lam = sindy_params_for('EQ_4_D')
        parts = []
        for s0 in range(0, S, args.seed_chunk):
            keys = jnp.stack([jax.random.PRNGKey(s) for s in
                              range(s0, min(s0 + args.seed_chunk, S))])
            out = jax.device_get(_sweep_jit(
                keys, 'EQ_4_D', n_train, n_test, seq_length,
                float(gamma), float(thr), float(SINDY_ALPHA), float(lam),
                method == 'insite', 12, ph, noise_scale=1.0,
                wsindy=(method == 'wsindy'), dedup_one_step=dedup))
            parts.append(out)
        orig = np.concatenate([o[0] for o in parts])
        n_step = np.concatenate([o[3] for o in parts])
        return {METRICS[0]: orig,
                **{METRICS[1 + k]: n_step[:, k] for k in range(ph)}}

    def record(key, fn):
        t0 = time.perf_counter()
        r = fn()
        secs = time.perf_counter() - t0
        ref[key] = {'per_seed': {m: [float(v) for v in r[m]]
                                 for m in METRICS},
                    'mean': {m: float(np.mean(r[m])) for m in METRICS},
                    'host_seconds': secs}
        print(f'{key}: 1-step mean {ref[key]["mean"][METRICS[0]]:.6f} %, '
              f'6-step mean {ref[key]["mean"][METRICS[-1]]:.6f} % '
              f'({secs:.1f} s)', file=sys.stderr, flush=True)

    for ds, method in EQ4_COLUMNS:
        record(f'{ds} {method}',
               lambda method=method: eq4_program(method, 2.0, False))
    for ds, method in TUMOR_COLUMNS:
        thr, lam = sindy_params_for(ds)
        record(f'{ds} {method}', lambda ds=ds, method=method, thr=thr,
               lam=lam: vectorized_tumor_sweep(
                   ds, n_seeds=S, n_train=n_train, n_test=n_test,
                   seq_length=seq_length, coeff=2.0, threshold=thr,
                   alpha=SINDY_ALPHA, lam=lam, method=method))
    for ds, _ in MSM_COLUMNS:
        record(f'{ds} msm', lambda ds=ds: vectorized_msm_sweep(
            ds, n_seeds=S, num_patients={'train': n_train, 'val': n_test,
                                         'test': n_test},
            coeff=2.0, epochs=100))
    for gamma in CONFOUNDING_GAMMAS:
        record(f'INSIGHT_CONFOUNDING {gamma:g} insite',
               lambda gamma=gamma: eq4_program('insite', gamma, True))

    def ratios(r, metrics):
        return np.concatenate([np.asarray(r['per_seed'][m]) / r['mean'][m]
                               for m in metrics])

    bands = {key: {'1-step': band(ratios(r, METRICS[:1])),
                   'n-step': band(ratios(r, METRICS[1:]))}
             for key, r in ref.items()}
    print('VECTORIZED_REF = ' + json.dumps(ref))
    print('VECTORIZED_BANDS = ' + json.dumps(bands))
    return 0


if __name__ == '__main__':
    sys.exit(main())
