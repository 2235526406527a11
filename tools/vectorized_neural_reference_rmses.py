#!/usr/bin/env python3
"""The JAX package's vectorized neural columns on the CPU: the accuracy
anchors that `chip_smoke.py` phase 12 holds the PyTorch port's neural
`--vectorized` columns to (`VECTORIZED_NEURAL_REF`,
`VECTORIZED_NEURAL_BANDS`).

    JAX_PLATFORMS=cpu python3 tools/vectorized_neural_reference_rmses.py \\
        --column EQ_4_D ct 100 [--column cancer_sim gnet 100 ...] \\
        [--seeds 10]

Each ``--column DATASET METHOD EPOCHS`` runs
`insite_tpu.harness.vectorized_neural`'s column of METHOD (ct, crn, edct,
rmsn, gnet) on DATASET at phase 12's size (``--seeds`` seeds from 0,
1,000 / 100 / 100 patients, seq 60, horizon 5, gamma 2, the JAX package's
config defaults, gnet with 25 Monte-Carlo samples, JAX's default float32
on the CPU, as the port's columns run in float32 on the card) for EPOCHS
epochs.

Prints, per column, the per-seed 1-step `encoder_test_rmse_orig` and
`decoder_test_rmse_{2..6}-step` (%) with their means and the column's
wall time on the host (one JSON line a column, ``VECTORIZED_NEURAL_REF
<column> {...}``), and the two-sided (lower, upper) factors on the mean at
1 step and at 2..6 steps built as `chip_smoke.py`'s other bands are: the
per-seed values as ratios to their column's mean, half the lowest ratio
rounded down to 0.05 and 1.25x the highest rounded up to 0.5
(``VECTORIZED_NEURAL_BANDS <column> [...]``).
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


def band(ratios):
    """(lower, upper) factors from per-seed ratios to their mean."""
    lo = math.floor(0.5 * ratios.min() / 0.05) * 0.05
    hi = math.ceil(1.25 * ratios.max() / 0.5) * 0.5
    return round(lo, 2), hi


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--column', nargs=3, action='append', required=True,
                   metavar=('DATASET', 'METHOD', 'EPOCHS'))
    p.add_argument('--seeds', type=int, default=10)
    args = p.parse_args(argv)
    import jax
    import numpy as np
    jax.config.update('jax_platforms', 'cpu')
    from insite_tpu.harness import vectorized_neural as vn

    for ds, method, epochs in args.column:
        kw = dict(n_seeds=args.seeds,
                  num_patients={'train': 1000, 'val': 100, 'test': 100},
                  coeff=2.0, epochs=int(epochs))
        t0 = time.perf_counter()
        if method == 'ct':
            r = vn.vectorized_ct_sweep(ds, **kw)
        elif method in ('crn', 'edct'):
            r = vn.vectorized_enc_dec_sweep(method, ds, **kw)
        elif method == 'rmsn':
            r = vn.vectorized_rmsn_sweep(ds, **kw)
        elif method == 'gnet':
            r = vn.vectorized_gnet_sweep(ds, mc_samples=25, **kw)
        else:
            raise ValueError(f'no vectorized neural column for {method}')
        secs = time.perf_counter() - t0
        key = f'{ds} {method}'
        ref = {'epochs': int(epochs), 'seeds': args.seeds,
               'per_seed': {m: [float(v) for v in r[m]] for m in METRICS},
               'mean': [float(np.mean(r[m])) for m in METRICS],
               'host_seconds': round(secs, 1)}
        ratios = [np.concatenate([np.asarray(ref['per_seed'][m]) /
                                  np.mean(r[m]) for m in ms])
                  for ms in (METRICS[:1], METRICS[1:])]
        print(f'VECTORIZED_NEURAL_REF {key} ' + json.dumps(ref), flush=True)
        print(f'VECTORIZED_NEURAL_BANDS {key} ' +
              json.dumps([band(x) for x in ratios]), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
