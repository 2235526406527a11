"""The figures of a sweep log, the port of `insite_tpu.harness.plots`:
n-step RMSE curves, the confounding and sample-size sweeps, and the
recovered parametric distribution, in plain matplotlib, from the log's
rows (`results.rows_from_log`) where the JAX package takes pandas frames.

`_agg` computes what the JAX `_agg` does with pandas: per group of the
given columns, the mean (NaN skipped) and the 95 % t-interval (or the
standard deviation) of every numeric column, a column being numeric when
every value the log holds for it is a number. matplotlib is imported
inside the plotting functions only: the card machine has none, and
nothing else in the port needs it.
"""

from __future__ import annotations

import math

import numpy as np

from insite_tpu_torch.harness.results import (DATASET_NAME_MAP,
                                              METHOD_NAME_MAP, _is_missing,
                                              _mean, _std, _unique, ci)


def _numeric_columns(rows) -> list:
    """The columns, in order of first appearance, whose every logged value
    is an int or a float (not a bool): a frame's numeric dtypes."""
    columns = _unique(k for r in rows for k in r)
    return [c for c in columns
            if all(isinstance(r[c], (int, float))
                   and not isinstance(r[c], bool) for r in rows if c in r)]


def _plotted_rows(rows) -> list:
    """The rows a plot draws: with an ``errored`` column, those whose mark
    is false (a missing or non-boolean mark excludes the row, as pandas'
    ``astype(bool)`` reads it)."""
    if not any('errored' in r for r in rows):
        return list(rows)
    return [r for r in rows if not r.get('errored', True)]


def _agg(rows, group_cols, use_95_ci=True, numeric=None):
    """(means, errs, 'ci' or 'std'): for each group of ``group_cols``
    values (rows missing one are left out), {key tuple: {column: value}}
    over the numeric columns other than ``group_cols`` (``numeric``: those
    of ``rows`` unless given), keys sorted. A value a row lacks counts as
    NaN: means skip it, a 95 % interval over a group holding one is NaN."""
    numeric = _numeric_columns(rows) if numeric is None else numeric
    value_cols = [c for c in numeric if c not in group_cols]
    groups = {}
    for r in rows:
        key = tuple(r.get(c) for c in group_cols)
        if not any(_is_missing(k) for k in key):
            groups.setdefault(key, []).append(r)
    err = ci if use_95_ci else _std
    means, errs = {}, {}
    for key in sorted(groups):
        vals = {c: [float(r.get(c, math.nan)) for r in groups[key]]
                for c in value_cols}
        means[key] = {c: _mean(v) for c, v in vals.items()}
        errs[key] = {c: float(err(v)) for c, v in vals.items()}
    return means, errs, ('ci' if use_95_ci else 'std')


def _label(method):
    return METHOD_NAME_MAP.get(method, method).replace(r'\bf ', '')


def _pyplot():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _step(col) -> int:
    return int(col.split('_')[-1].split('-')[0])


def plot_n_step_rmses(rows, out_path: str, use_95_ci=True, logy=True,
                      domain_conf=None):
    """One panel per dataset: mean +- CI of the 1..6-step RMSE per method,
    horizon on the x axis (the reference's n-step overlap graph): the
    1-step point is ``encoder_test_rmse_orig``, y is log-scale, and with a
    ``domain_conf`` (or when several gammas are present, gamma = 2, the
    benchmark default) only that confounding level is plotted."""
    numeric = _numeric_columns(rows)
    columns = _unique(k for r in rows for k in r)
    rows = _plotted_rows(rows)
    if 'domain_conf' in columns:
        gammas = _unique(r['domain_conf'] for r in rows
                         if not _is_missing(r.get('domain_conf')))
        if domain_conf is None and len(gammas) > 1:
            domain_conf = 2.0
        if domain_conf is not None:
            rows = [r for r in rows
                    if r.get('domain_conf') == float(domain_conf)]
    step_cols = sorted([c for c in columns if 'decoder_test_rmse' in c],
                       key=_step)
    if not step_cols:
        raise ValueError('no decoder_test_rmse_<k>-step columns found')
    steps = [_step(c) for c in step_cols]
    if 'encoder_test_rmse_orig' in columns:     # the 1-step-ahead point
        step_cols = ['encoder_test_rmse_orig'] + step_cols
        steps = [1] + steps
    datasets = _unique(r.get('dataset_name') for r in rows)
    methods = _unique(r.get('method_name') for r in rows)

    means, errs, _ = _agg(rows, ['dataset_name', 'method_name'], use_95_ci,
                          numeric)
    plt = _pyplot()
    fig, axes = plt.subplots(1, len(datasets),
                             figsize=(4 * len(datasets), 3.2), squeeze=False)
    for ax, ds in zip(axes[0], datasets):
        for method in methods:
            cell_m, cell_e = means.get((ds, method)), errs.get((ds, method))
            if cell_m is None or any(c not in cell_m for c in step_cols):
                continue
            m = np.array([cell_m[c] for c in step_cols], float)
            e = np.nan_to_num(np.array([cell_e[c] for c in step_cols],
                                       float))
            ax.plot(steps, m, '--o', label=_label(method))
            ax.fill_between(steps, m - e, m + e, alpha=0.25)
        ax.set_title(DATASET_NAME_MAP.get(ds, ds))
        ax.set_xlabel(r'$\tau$-step ahead prediction')
        ax.set_ylabel('normalized RMSE (%)')
        ax.set_xticks(steps)
        if logy:
            ax.set_yscale('log')
    axes[0][0].legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def _sweep_series(rows, x_col, metric, use_95_ci):
    """{method: (x [n], mean [n], err [n])} of ``metric`` against
    ``x_col``, x ascending, over the completed rows."""
    numeric = _numeric_columns(rows)
    rows = _plotted_rows(rows)
    means, errs, _ = _agg(rows, ['method_name', x_col], use_95_ci, numeric)
    out = {}
    for method in _unique(r.get('method_name') for r in rows):
        keys = [k for k in means if k[0] == method]
        out[method] = (np.array([k[1] for k in keys], float),
                       np.array([means[k][metric] for k in keys], float),
                       np.nan_to_num(np.array([errs[k][metric]
                                               for k in keys], float)))
    return out


def plot_confounding_sweep(rows, out_path: str,
                           metric='encoder_test_rmse_orig', use_95_ci=True,
                           logy=False):
    """RMSE against the confounding strength gamma (the
    INSIGHT_CONFOUNDING figure), one line per method."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for method, (x, m, e) in _sweep_series(rows, 'domain_conf', metric,
                                           use_95_ci).items():
        ax.plot(x, m, '--o', label=_label(method))
        ax.fill_between(x, m - e, m + e, alpha=0.25)
    ax.set_xlabel(r'confounding strength $\gamma$')
    ax.set_ylabel(f'{metric} (%)')
    if logy:
        ax.set_yscale('log')
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_sample_efficiency(rows, out_path: str,
                           metric='encoder_test_rmse_orig', use_95_ci=True):
    """RMSE against the training-cohort size (the INSIGHT_LESS_SAMPLES
    figure; its rows carry ``train_samples``)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for method, (x, m, e) in _sweep_series(rows, 'train_samples', metric,
                                           use_95_ci).items():
        ax.plot(x, m, '--o', label=_label(method))
        ax.fill_between(x, m - e, m + e, alpha=0.25)
    ax.set_xlabel('training patients')
    ax.set_ylabel(f'{metric} (%)')
    ax.set_xscale('log')
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_recovered_dist(rec_data: dict, out_path: str):
    """INSIGHT_RECOVER_PARAMETRIC_DIST figure: recovered against true
    hidden decay constants (`harness/insights.py`). Left: per-patient
    scatter against the identity line with Pearson r in the legend; right:
    the two distributions overlaid (true filled, recovered outlined).
    ``rec_data`` maps arm name -> {'true': [...], 'recovered': [...]}."""
    plt = _pyplot()
    fig, (ax_sc, ax_hi) = plt.subplots(1, 2, figsize=(8.4, 3.4))
    lo = min(float(np.min(d['true'])) for d in rec_data.values())
    hi = max(float(np.max(d['true'])) for d in rec_data.values())
    pad = 0.08 * (hi - lo + 1e-12)
    lo, hi = lo - pad, hi + pad
    ax_sc.plot([lo, hi], [lo, hi], color='0.6', lw=1, zorder=1)
    bins = np.linspace(lo, hi, 24)
    for i, (arm, d) in enumerate(sorted(rec_data.items())):
        t = np.asarray(d['true'], float)
        r = np.asarray(d['recovered'], float)
        color = f'C{i}'
        corr = np.corrcoef(t, r)[0, 1] if t.size > 1 else np.nan
        ax_sc.scatter(t, r, s=14, alpha=0.7, color=color, zorder=2,
                      label=f'{arm} (r={corr:.3f})')
        ax_hi.hist(t, bins=bins, alpha=0.35, color=color,
                   label=f'{arm} true')
        ax_hi.hist(r, bins=bins, histtype='step', lw=1.8, color=color,
                   label=f'{arm} recovered')
    ax_sc.set_xlabel('true hidden decay constant C')
    ax_sc.set_ylabel('recovered C (INSITE fine-tune)')
    ax_sc.legend(fontsize=8)
    ax_hi.set_xlabel('decay constant C')
    ax_hi.set_ylabel('patients')
    ax_hi.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path
