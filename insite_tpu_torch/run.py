"""Benchmark sweep CLI of the PyTorch port: the main table for the
``sindy`` and ``insite`` methods on the EQ_4 family, cancer_sim and EQ_5.

Usage:
    python -m insite_tpu_torch.run --flush --datasets EQ_4_D \
        --methods sindy insite                      # on the card
    python -m insite_tpu_torch.run --device cpu --flush --datasets \
        cancer_sim EQ_5_D --methods sindy insite    # on the host

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
from insite_tpu_torch.harness.runner import Experiment, sweep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--methods', nargs='+', default=None)
    p.add_argument('--datasets', nargs='+', default=None)
    p.add_argument('--seeds', type=int, default=None)
    p.add_argument('--seed-start', type=int, default=None)
    p.add_argument('--train-samples', type=int, default=None)
    p.add_argument('--val-samples', type=int, default=None)
    p.add_argument('--test-samples', type=int, default=None)
    p.add_argument('--domain-conf', type=float, default=None)
    p.add_argument('--flush', action='store_true',
                   help='fast path: 1 seed, 1000 / 10 / 10 patients')
    p.add_argument('--no-debug', action='store_true',
                   help='turn a failing run into an errored row instead of '
                        'raising')
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

    cfg = RunConfig()
    if args.methods:
        cfg.methods = tuple(args.methods)
    if args.datasets:
        cfg.datasets = tuple(args.datasets)
    if args.seeds is not None:
        cfg.seed_runs = args.seeds
    for k in ('seed_start', 'train_samples', 'val_samples', 'test_samples',
              'domain_conf', 'log_dir'):
        v = getattr(args, k)
        if v is not None:
            setattr(cfg, k, v)
    if args.flush:
        cfg.flush_mode = True
    if args.no_debug:
        cfg.debug_mode = False

    log_path = generate_log_file_path('run', cfg.log_dir)
    logger = create_logger_in_process(log_path)
    logger.info(f'Starting sweep | log at {log_path} | device={device}')
    _, tables = sweep(cfg, Experiment[cfg.experiment], log=logger,
                      device=device)
    for metric, table in tables.items():
        logger.info(f'Latex Table:: {metric}\n{table}')
    logger.info(f'[Log found at] {log_path}')
    return log_path


if __name__ == '__main__':
    main()
