"""Figure CLI: the paper's insight figures from sweep logs and result
JSONs, without pandas. The port of the repository's `make_figures.py`,
with the same arguments, file names and output lines.

    python -m insite_tpu_torch.make_figures --nstep logs/run-*.txt \\
        [--datasets EQ_4_D ...] --out figures/
    python -m insite_tpu_torch.make_figures --confounding logs/conf10.json \\
        [--metrics all] --out figures/
    python -m insite_tpu_torch.make_figures --recover logs/recover_dist.json \\
        --out figures/
    python -m insite_tpu_torch.make_figures --less-samples logs/run-*.txt \\
        --out figures/

Each figure has a function that makes the rows (or the per-arm data) its
plot draws, without matplotlib, and a function that draws them with
`harness/plots.py` (which imports matplotlib when it draws).
"""

from __future__ import annotations

import argparse
import json
import os

from insite_tpu_torch.harness import plots
from insite_tpu_torch.harness.results import (_is_missing, concat_rows,
                                              rows_from_log)


def nstep_rows(log_paths, datasets=None) -> list:
    """The rows of the n-step figure: the logs' completed rows (a row
    without an ``errored`` mark in a frame that has one is left out, as
    pandas reads NaN as true), of ``datasets`` where given."""
    rows = plots._plotted_rows(
        concat_rows(rows_from_log(p) for p in log_paths))
    if datasets:
        rows = [r for r in rows if r['dataset_name'] in datasets]
    return rows


def nstep_figure(log_paths, out_dir, datasets=None):
    out = os.path.join(out_dir, 'n_step_rmse.png')
    plots.plot_n_step_rmses(nstep_rows(log_paths, datasets), out)
    return out


def confounding_rows(json_path) -> tuple:
    """(rows, metrics) of a vectorized-confounding JSON ({method:
    {gammas, <metric>: [n_gamma][n_seed]}}): a row per method, gamma and
    seed, and every metric column of the JSON, in the order the JAX
    script lists them."""
    with open(json_path) as f:
        grid = json.load(f)
    rows = []
    all_metrics = []
    for method, d in grid.items():
        cols = {k: v for k, v in d.items() if k != 'gammas'}
        all_metrics = [k for k in cols if k not in all_metrics] + \
            [k for k in all_metrics]
        for gi, gamma in enumerate(d['gammas']):
            n_seeds = len(next(iter(cols.values()))[gi])
            for s in range(n_seeds):
                rows.append({'method_name': method, 'domain_conf': gamma,
                             'seed': s,
                             **{k: v[gi][s] for k, v in cols.items()}})
    return concat_rows([rows]), all_metrics


def confounding_figure(json_path, out_dir,
                       metrics=('encoder_test_rmse_orig',)):
    """One figure a requested metric (the reference's overlap graph emits
    one a horizon); ``metrics=['all']`` takes every metric of the JSON."""
    rows, all_metrics = confounding_rows(json_path)
    if list(metrics) == ['all']:
        metrics = all_metrics
    outs = []
    for metric in metrics:
        suffix = '' if metric == 'encoder_test_rmse_orig' else f'_{metric}'
        out = os.path.join(out_dir, f'confounding_sweep{suffix}.png')
        plots.plot_confounding_sweep(rows, out, metric=metric)
        outs.append(out)
    return outs


def less_samples_rows(log_paths) -> list:
    """The rows of the sample-efficiency figure: the completed rows of
    INSIGHT_LESS_SAMPLES logs that carry ``train_samples``."""
    rows = plots._plotted_rows(
        concat_rows(rows_from_log(p) for p in log_paths))
    return [r for r in rows if not _is_missing(r.get('train_samples'))]


def less_samples_figure(log_paths, out_dir):
    out = os.path.join(out_dir, 'sample_efficiency.png')
    plots.plot_sample_efficiency(less_samples_rows(log_paths), out)
    return out


def recover_data(json_path) -> dict:
    """The arms of a recovered-vs-true decay-constant JSON ({arm: {true:
    [...], recovered: [...]}}, from `harness.insights`) that hold the true
    values."""
    with open(json_path) as f:
        rec = json.load(f)
    return {arm: d for arm, d in rec.items() if 'true' in d}


def recover_figure(json_path, out_dir):
    out = os.path.join(out_dir, 'recovered_dist.png')
    plots.plot_recovered_dist(recover_data(json_path), out)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--nstep', nargs='*', default=[],
                    help='sweep logs for the n-step RMSE panels')
    ap.add_argument('--datasets', nargs='*', default=None,
                    help='restrict n-step panels to these datasets')
    ap.add_argument('--confounding', default=None,
                    help='vectorized confounding-grid JSON')
    ap.add_argument('--metrics', nargs='*',
                    default=['encoder_test_rmse_orig'],
                    help="confounding-figure metrics ('all' = every "
                         'metric column in the JSON, one panel each)')
    ap.add_argument('--recover', default=None,
                    help='recovered-parametric-dist JSON (insights.py)')
    ap.add_argument('--less-samples', nargs='*', default=[],
                    help='INSIGHT_LESS_SAMPLES sweep logs for the '
                         'sample-efficiency figure')
    ap.add_argument('--out', default='figures')
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    made = []
    if args.nstep:
        made.append(nstep_figure(args.nstep, args.out, args.datasets))
    if args.confounding:
        made.extend(confounding_figure(args.confounding, args.out,
                                       metrics=args.metrics))
    if args.recover:
        made.append(recover_figure(args.recover, args.out))
    if args.less_samples:
        made.append(less_samples_figure(args.less_samples, args.out))
    for p in made:
        print('wrote', p)
    if not made:
        print('nothing to do (pass --nstep and/or --confounding)')


if __name__ == '__main__':
    main()
