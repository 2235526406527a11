"""Benchmark sweep CLI of the PyTorch port: all nine methods (``sindy``,
``wsindy``, ``insite``, ``msm``, ``ct``, ``crn``, ``rmsn``, ``gnet`` and
``edct``) on the EQ_4 family, cancer_sim and EQ_5, for the main table, the
one-ODE and degree-4 ablations, the parametric-distribution recovery and
the three robustness sweeps (INSIGHT_CONFOUNDING, INSIGHT_NOISE,
INSIGHT_LESS_SAMPLES, each on its own EQ_4 dataset).

Usage:
    python -m insite_tpu_torch.run --flush --datasets EQ_4_D \
        --methods sindy wsindy insite               # on the card
    python -m insite_tpu_torch.run --device cpu --flush --datasets \
        cancer_sim EQ_5_D --methods sindy insite    # on the host
    python -m insite_tpu_torch.run --experiment ABLATION_ONE_ODE \
        --datasets EQ_4_D cancer_sim --methods sindy insite
    python -m insite_tpu_torch.run --experiment INSIGHT_NOISE \
        --methods sindy insite msm --seeds 1
    python -m insite_tpu_torch.run --methods ct crn \
        --datasets EQ_4_D cancer_sim --seeds 1
    python -m insite_tpu_torch.run --methods rmsn gnet edct \
        --datasets EQ_4_D cancer_sim --seeds 1
    python -m insite_tpu_torch.run --vectorized --methods sindy insite \
        wsindy msm --datasets EQ_4_D cancer_sim     # 10-seed columns
    python -m insite_tpu_torch.run --vectorized --methods ct crn edct \
        rmsn gnet --datasets EQ_4_D

``msm`` is a host model in float64 whatever the device; ``--epochs`` bounds
the iterations of its propensity fits. The neural baselines, ``ct`` (the
Causal Transformer), ``crn``, ``rmsn``, ``gnet`` and ``edct``, train their
networks in float32 on the device for ``--epochs`` epochs (100 by default;
rmsn's encoder three times as many).

With ``--vectorized`` each (dataset, method) column of ``--seeds`` seeds
runs as one batch (sindy, insite and wsindy: every seed's test rows through
one fine-tune and one rollout, each row with its own seed's model; msm:
its solves batched over seeds; ct, crn, edct, rmsn and gnet: each network
of the method trained for all seeds as one seed-stacked fit) and logs one
row per seed, marked ``'vectorized': True``; wsindy's tumor-family columns
are skipped. ``--flush`` does not apply there, as in the JAX package.

Around the runs, with the JAX package's semantics: ``--config FILE`` loads
a YAML file of RunConfig fields (e.g. ``configs/ref_tuned.yaml``; needs
PyYAML), which the other flags override only where given; ``--tune``
tunes on the validation cohort (insite: the lam grid in one stacked
fine-tune; the neural methods: ``--tune-trials`` trials of a seeded grid
search, or successive halving with ``--tune-algo sha``); ``--cache`` keeps
the collections on disk; ``--resume LOG`` reuses the completed runs of an
earlier sweep's log; ``--isolate`` runs each run, or each ``--vectorized``
column, in a fresh interpreter and implies ``--no-debug``. Every run
writes its metrics to ``metrics_jsonl`` (``logs/metrics.jsonl``).

    python -m insite_tpu_torch.run --device cpu --tune --datasets EQ_4_D \
        --methods insite --seeds 1 --train-samples 40 --val-samples 4 \
        --test-samples 4
    python -m insite_tpu_torch.run --config configs/ref_tuned.yaml \
        --methods crn --datasets EQ_4_D --seeds 1

Each run logs an '[Exp evaluation complete] {...}' line into
``<log dir>/run-<timestamp>.txt`` (the results database, read back by
`insite_tpu_torch.harness.results.rows_from_log`), and the LaTeX main
tables are logged at the end.
"""

from __future__ import annotations

import argparse

import torch

from insite_tpu_torch.harness.config import RunConfig
from insite_tpu_torch.harness.logging_utils import (create_logger_in_process,
                                                    generate_log_file_path)
from insite_tpu_torch.harness.runner import (Experiment, sweep,
                                             vectorized_sweep)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--config', default=None,
                   help='YAML file of RunConfig fields (needs PyYAML; the '
                        'flags below override it where given)')
    p.add_argument('--methods', nargs='+', default=None,
                   help='of sindy, wsindy, insite, msm, ct, crn, rmsn, '
                        'gnet, edct (default: all nine)')
    p.add_argument('--datasets', nargs='+', default=None)
    p.add_argument('--seeds', type=int, default=None)
    p.add_argument('--seed-start', type=int, default=None)
    p.add_argument('--epochs', type=int, default=None)
    p.add_argument('--train-samples', type=int, default=None)
    p.add_argument('--val-samples', type=int, default=None)
    p.add_argument('--test-samples', type=int, default=None)
    p.add_argument('--domain-conf', type=float, default=None)
    p.add_argument('--experiment', default=None,
                   choices=[e.name for e in Experiment])
    p.add_argument('--flush', action='store_true',
                   help='fast path: 1 seed, 1000 / 10 / 10 patients')
    p.add_argument('--no-debug', action='store_true',
                   help='turn a failing run into an errored row instead of '
                        'raising')
    p.add_argument('--cache', action='store_true',
                   help='keep dataset collections on disk '
                        '($INSITE_TPU_TORCH_CACHE, default '
                        '.insite_torch_cache)')
    p.add_argument('--tune', action='store_true',
                   help='tune on the validation cohort (insite: the lam '
                        'grid in one fine-tune; neural: --tune-trials '
                        'trials of a seeded search)')
    p.add_argument('--tune-algo', choices=('grid', 'sha'), default=None,
                   help='neural tuner: the seeded subsampled grid (default) '
                        'or successive halving (small epoch budgets first, '
                        'survivors promoted)')
    p.add_argument('--tune-trials', type=int, default=None,
                   help='neural tuning trials subsampled from the grid')
    p.add_argument('--vectorized', action='store_true',
                   help='run each (dataset, method) column of seeds as one '
                        'batch (all nine methods)')
    p.add_argument('--isolate', action='store_true',
                   help='run each run (or column) in a fresh interpreter, '
                        'so a device-level failure cannot fail the rest of '
                        'the sweep; implies --no-debug')
    p.add_argument('--resume', default=None, metavar='LOG',
                   help='reuse the completed runs of an earlier sweep log '
                        'and run only the rest')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help='"cuda": the kernels on the first card (an error '
                        'without one); "cpu": their plain PyTorch versions')
    p.add_argument('--log-dir', default=None,
                   help='directory of the sweep log (default: logs)')
    args = p.parse_args(argv)
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda needs an NVIDIA card, and '
                           'torch.cuda.is_available() is false')
    device = torch.device('cuda', 0) if args.device == 'cuda' else \
        torch.device('cpu')

    cfg = RunConfig.from_yaml(args.config) if args.config else RunConfig()
    # a flag overrides the (possibly YAML-loaded) config only when given;
    # store_true flags can only enable
    if args.methods:
        cfg.methods = tuple(args.methods)
    if args.datasets:
        cfg.datasets = tuple(args.datasets)
    if args.seeds is not None:
        cfg.seed_runs = args.seeds
    for k in ('seed_start', 'epochs', 'train_samples', 'val_samples',
              'test_samples', 'domain_conf', 'log_dir', 'experiment'):
        v = getattr(args, k)
        if v is not None:
            setattr(cfg, k, v)
    if args.flush:
        cfg.flush_mode = True
    if args.no_debug:
        cfg.debug_mode = False
    if args.cache:
        cfg.load_from_cache = True
    if args.tune:
        cfg.tune_hparams = True
    if args.tune_trials is not None:
        cfg.tune_trials = args.tune_trials
    if args.tune_algo is not None:
        cfg.tune_algo = args.tune_algo
    if args.isolate:
        cfg.isolate_runs = True
        # a child's failure becomes an errored row, not the sweep's end
        cfg.debug_mode = False
    if args.resume:
        cfg.resume_log = args.resume

    log_path = generate_log_file_path('run', cfg.log_dir)
    logger = create_logger_in_process(log_path)
    logger.info(f'Starting sweep | log at {log_path} | device={device}')
    if args.vectorized:
        _, tables = vectorized_sweep(cfg, log=logger, device=device)
    else:
        _, tables = sweep(cfg, Experiment[cfg.experiment], log=logger,
                          device=device)
    for metric, table in tables.items():
        logger.info(f'Latex Table:: {metric}\n{table}')
    logger.info(f'[Log found at] {log_path}')
    return log_path


if __name__ == '__main__':
    main()
