#!/usr/bin/env python3
"""The JAX package's tumor main table at one seed, in float64 on the CPU:
the accuracy anchors that `chip_smoke.py` phase 6 holds the PyTorch port's
card run to.

    JAX_PLATFORMS=cpu python3 tools/tumor_reference_rmses.py [--seed 0] \
        [--datasets cancer_sim EQ_5_A ...]

Runs `insite_tpu.harness.runner.run_experiment` for sindy and insite on
cancer_sim and EQ_5_A..D at the reference's size (1,000 / 100 / 100
patients, seq 60, horizon 5, gamma 2) and prints one JSON object mapping
"<dataset> <method>" to its 1-step `encoder_test_rmse_orig` and its
`decoder_test_rmse_6-step` (%), plus each run's wall time on the host.

On EQ_5_A and EQ_5_B the JAX package's unbias refit raises `LinAlgError`:
their single patient type makes the 'u0' column of the library a copy of
'1'. Such a run is recorded with its error, and run again with the unbias
refit's minimum-norm least-squares solution in its place (the reference's,
and the PyTorch port's); those rows carry ``"min_norm_unbias": true``.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DATASETS = ('cancer_sim', 'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D')
METHODS = ('sindy', 'insite')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--datasets', nargs='+', default=DATASETS)
    args = p.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    import importlib

    import numpy as np
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import run_experiment
    # the module (the package re-exports a function of the same name)
    stlsq = importlib.import_module('insite_tpu.discovery.stlsq')
    stlsq_from_qr = stlsq.stlsq_from_qr

    def min_norm_unbias(R, qty, *a, **kw):
        coefs, mask = stlsq_from_qr(R, qty, *a, **dict(kw, unbias=False))
        coefs = np.zeros_like(coefs)
        R = np.asarray(R, np.float64)
        coefs[mask] = np.linalg.lstsq(R[:, mask], np.asarray(qty, np.float64),
                                      rcond=None)[0]
        return coefs, mask

    def run(ds, method):
        t0 = time.perf_counter()
        row = run_experiment(ds, method, args.seed, 2.0,
                             RunConfig(metrics_jsonl=''))
        return {'encoder_test_rmse_orig': float(row['encoder_test_rmse_orig']),
                'decoder_test_rmse_6-step':
                    float(row['decoder_test_rmse_6-step']),
                'host_seconds': time.perf_counter() - t0}

    out = {}
    for ds in args.datasets:
        for method in METHODS:
            key = f'{ds} {method}'
            try:
                out[key] = run(ds, method)
            except np.linalg.LinAlgError as e:
                stlsq.stlsq_from_qr = min_norm_unbias
                try:
                    out[key] = dict(run(ds, method), min_norm_unbias=True,
                                    error=f'{type(e).__name__}: {e}')
                finally:
                    stlsq.stlsq_from_qr = stlsq_from_qr
            print(f'{key}: {out[key]}', file=sys.stderr, flush=True)
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
