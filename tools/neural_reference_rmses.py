#!/usr/bin/env python3
"""The JAX package's neural rows at one seed on the CPU: the accuracy
anchors that `chip_smoke.py` phases 9 and 10 hold the PyTorch port's card
run to (`NEURAL_REF`, at seed 0); its rows at seeds 0-3 are the methods'
spread that `NEURAL_BANDS` is set from.

    JAX_PLATFORMS=cpu python3 tools/neural_reference_rmses.py [--seed 0] \\
        [--methods ct crn rmsn gnet edct] [--epochs 100] \\
        [--datasets EQ_4_D cancer_sim]

Runs `insite_tpu.harness.runner.run_experiment` for each method on EQ_4_D
and cancer_sim at the reference's size (1,000 / 100 / 100 patients, seq 60,
horizon 5, gamma 2; 100 epochs unless ``--epochs`` says otherwise, the
phases' `NEURAL_EPOCHS`) with JAX's default float32 throughout (the JAX
package fits its networks in float32 in any case), and prints one JSON
object "<dataset> <method>" -> the 1-step `encoder_test_rmse_orig` and the
`decoder_test_rmse_{2..6}-step` (%), with the run's wall time on the host
and its epochs.

CT predicts the n-step test set (~59,000 rows of 64 steps on EQ_4_D) in one
batch, which holds ~10 GB of attention scores; here its two prediction
methods, and the stage prediction of EDCT's transformer encoder and
decoder, run over chunks of rows. Rows are independent, so the chunks
change no number.
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

DATASETS = ('EQ_4_D', 'cancer_sim')
METHODS = ('ct', 'crn', 'rmsn', 'gnet', 'edct')
METRICS = ('encoder_test_rmse_orig',) + tuple(
    f'decoder_test_rmse_{k}-step' for k in range(2, 7))
CHUNK_ROWS = 4096


def _chunked(predict):
    """``predict(self, dataset)`` over chunks of the dataset's rows."""
    import numpy as np

    def inner(self, dataset):
        data = dataset.data
        n = next(iter(data.values())).shape[0]
        parts = [predict(self, SimpleNamespace(data={
            k: v[i:i + CHUNK_ROWS] for k, v in data.items()}))
            for i in range(0, n, CHUNK_ROWS)]
        return np.concatenate(parts, axis=0)
    return inner


def _chunked_stage(predict_all):
    """``predict_all(self, data)`` over chunks of the rows of ``data``."""
    import numpy as np

    def inner(self, data):
        n = next(iter(data.values())).shape[0]
        parts = [predict_all(self, {k: v[i:i + CHUNK_ROWS]
                                    for k, v in data.items()})
                 for i in range(0, n, CHUNK_ROWS)]
        return tuple(np.concatenate(p, axis=0) for p in zip(*parts))
    return inner


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--methods', nargs='+', choices=METHODS,
                   default=['ct', 'crn'])
    p.add_argument('--epochs', type=int, default=100)
    p.add_argument('--datasets', nargs='+', choices=DATASETS,
                   default=list(DATASETS))
    args = p.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from insite_tpu.harness.config import RunConfig
    from insite_tpu.harness.runner import Experiment, run_experiment
    from insite_tpu.models.crn import _Stage
    from insite_tpu.models.ct import CausalTransformer
    for name in ('get_predictions', 'get_autoregressive_predictions'):
        setattr(CausalTransformer, name,
                _chunked(getattr(CausalTransformer, name)))
    _Stage.predict_all = _chunked_stage(_Stage.predict_all)

    base = RunConfig(metrics_jsonl='', epochs=args.epochs)
    out = {}
    for ds in args.datasets:
        for method in args.methods:
            t0 = time.perf_counter()
            row = run_experiment(ds, method, args.seed, base.domain_conf,
                                 base, Experiment.MAIN_TABLE)
            entry = {m: float(row[m]) for m in METRICS}
            entry['host_seconds'] = time.perf_counter() - t0
            entry['epochs'] = args.epochs
            out[f'{ds} {method}'] = entry
            print(f'{ds} {method}: {entry}', file=sys.stderr, flush=True)
    print(json.dumps(out, indent=1))


if __name__ == '__main__':
    main()
