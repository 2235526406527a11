#!/usr/bin/env python3
"""A neural method (ct unless ``--method`` names another) on ONE EQ_4_D
cohort in both packages, over model seeds: the spread of the training draws
alone, and whether the PyTorch port's rows lie inside the JAX package's.

    JAX_PLATFORMS=cpu python3 tools/neural_same_cohort.py --package jax \\
        [--seeds 0 1 2 3] [--method ct] [--epochs 100]
    JAX_PLATFORMS=cpu python3 tools/neural_same_cohort.py --package port ...

The JAX package makes the cohort of seed 0 (1,000 / 100 / 100 patients,
gamma 2), the one `NEURAL_REF` was read on; ``--package port`` hands it
over to the port with `convert.collection_from_numpy`, as the CPU parity
tests do. Each run is
`run_experiment` at model seed s (initial weights, shuffles and dropout
masks), 100 epochs unless ``--epochs`` says otherwise, float32 on the host.
The two packages share no random stream, so only the distributions compare.
ct's and the encoder-decoder stages' predictions run over chunks of rows,
as in `neural_reference_rmses.py`. Prints one JSON line a run: the 1-step
and the 2..6-step RMSEs (%) and the host seconds.
"""

import argparse
import copy
import json
import os
import sys
import time

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
# the repository root in place of tools/ (whose queue.py would shadow the
# standard library's)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from tools.neural_reference_rmses import (METHODS, METRICS,  # noqa: E402
                                          _chunked, _chunked_stage)

DATASET, COHORT_SEED = 'EQ_4_D', 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--package', choices=('jax', 'port'), required=True)
    p.add_argument('--seeds', type=int, nargs='+', default=[0, 1, 2, 3])
    p.add_argument('--method', choices=METHODS, default='ct')
    p.add_argument('--epochs', type=int, default=100)
    args = p.parse_args(argv)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    from insite_tpu.data.collection import make_collection as jax_collection

    if args.package == 'jax':
        from insite_tpu.harness import runner
        from insite_tpu.harness.config import RunConfig
        from insite_tpu.models.crn import _Stage as Stage
        from insite_tpu.models.ct import CausalTransformer

        def make_collection(name, num_patients, seed, coeff, **kwargs):
            return jax_collection(name, num_patients, COHORT_SEED, coeff,
                                  **kwargs)

        def run(seed):
            return runner.run_experiment(
                DATASET, args.method, seed, 2.0,
                RunConfig(metrics_jsonl='', epochs=args.epochs),
                runner.Experiment.MAIN_TABLE)
    else:
        import torch
        torch.set_num_threads(2)
        from insite_tpu_torch import convert
        from insite_tpu_torch.data.collection import SUBSETS
        from insite_tpu_torch.harness import runner
        from insite_tpu_torch.harness.config import RunConfig
        from insite_tpu_torch.models.ct import CausalTransformer
        from insite_tpu_torch.models.nn.training import BRStage as Stage

        def make_collection(name, num_patients, seed, coeff, *, device,
                            dtype=None, **kwargs):
            ref = jax_collection(name, num_patients, COHORT_SEED, coeff,
                                 **kwargs)
            raw = {k: copy.deepcopy(getattr(ref, k).data) for k in SUBSETS}
            return convert.collection_from_numpy(
                raw, ref.train_scaling_params, name,
                projection_horizon=ref.projection_horizon,
                treatment_mode=kwargs['treatment_mode'], seed=COHORT_SEED)

        def run(seed):
            return runner.run_experiment(DATASET, args.method, seed, 2.0,
                                         RunConfig(epochs=args.epochs),
                                         device='cpu')
    runner.make_collection = make_collection
    for name in ('get_predictions', 'get_autoregressive_predictions'):
        setattr(CausalTransformer, name,
                _chunked(getattr(CausalTransformer, name)))
    Stage.predict_all = _chunked_stage(Stage.predict_all)

    for seed in args.seeds:
        t0 = time.perf_counter()
        row = run(seed)
        print(json.dumps({'package': args.package, 'method': args.method,
                          'epochs': args.epochs,
                          'cohort_seed': COHORT_SEED, 'seed': seed,
                          **{m: float(row[m]) for m in METRICS},
                          'host_seconds': time.perf_counter() - t0}),
              flush=True)


if __name__ == '__main__':
    main()
