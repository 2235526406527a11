"""Results tools without pandas: the sweep log's rows back as dicts, the
95 % t-interval, and the LaTeX main table, whose text is that of
`insite_tpu.harness.results.generate_main_results_table` on the same
rows."""

from __future__ import annotations

import ast
import math

import numpy as np
from scipy import stats

METHOD_NAME_MAP = {'sindy': 'A-SINDy', 'wsindy': 'A-WSINDy',
                   'te-cde': 'TE-CDE', 'insite': r'\bf INSITE',
                   'crn': 'CRN', 'msm': 'MSM', 'gnet': 'G-Net',
                   'rmsn': 'RMSN', 'ct': 'CT', 'edct': 'EDCT'}
DATASET_NAME_ORDERING = {'cancer_sim': -1, 'EQ_4_A': 0, 'EQ_4_B': 1,
                         'EQ_4_C': 2, 'EQ_4_D': 3, 'EQ_5_A': 4, 'EQ_5_B': 5,
                         'EQ_5_C': 6, 'EQ_5_D': 7}
METHOD_NAME_ORDERING = {'msm': 0, 'rmsn': 1, 'crn': 2, 'gnet': 3,
                        'te-cde': 4, 'ct': 5, 'edct': 6, 'sindy': 7,
                        'wsindy': 8, 'insite': 9}
DATASET_NAME_MAP = {'EQ_4_A': 'Eq.4.A', 'EQ_4_B': 'Eq.4.B',
                    'EQ_4_C': 'Eq.4.C', 'EQ_4_D': 'Eq.4.D',
                    'EQ_5_A': 'Eq.5.A', 'EQ_5_B': 'Eq.5.B',
                    'EQ_5_C': 'Eq.5.C', 'EQ_5_D': 'Eq.5.D',
                    'cancer_sim': 'Cancer PKPD'}
TAG = '[Exp evaluation complete] '


def ci(data, confidence=0.95, axis=0):
    """95 % t-interval half-width."""
    a = 1.0 * np.array(data)
    n = a.shape[axis]
    se = stats.sem(a, axis=axis)
    return se * stats.t.ppf((1 + confidence) / 2.0, n - 1)


def custom_format(number, threshold=1e-2):
    if abs(number) < threshold:
        return '0.00' if number == 0 else f'{number:.2e}'
    return f'{number:.2f}'


def rows_from_log(path) -> list:
    """The '[Exp evaluation complete] {...}' lines of a sweep log, as
    dicts."""
    rows = []
    with open(path) as f:
        for line in f:
            if TAG + '{' in line:
                payload = line.split(TAG)[1].strip()
                payload = payload.replace('nan', "'nan'")
                payload = payload.replace('array', '')
                rows.append(ast.literal_eval(payload))
    return rows


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _mean(values) -> float:
    """Mean over the non-NaN values (NaN if none), summed with Kahan
    compensation in row order."""
    total, comp, n = 0.0, 0.0, 0
    for v in values:
        if _is_nan(v):
            continue
        n += 1
        y = v - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total / n if n else math.nan


def _ordered(key):
    ds, m = key
    d_ord = DATASET_NAME_ORDERING.get(ds)
    m_ord = METHOD_NAME_ORDERING.get(m)
    # unknown names sort last
    return (d_ord is None, d_ord or 0, m_ord is None, m_ord or 0)


def _unique(seq) -> list:
    return list(dict.fromkeys(seq))


def generate_main_results_table(rows) -> dict:
    """LaTeX table per n-step metric and for the 1-step
    ``encoder_test_rmse_orig``: per (dataset, method), the mean over seeds
    and its 95 % t-interval (0.00 where the interval is NaN, n = 1)."""
    columns = [c for c in _unique(k for r in rows for k in r)
               if c != 'errored']
    rows = [r for r in rows
            if _is_nan(r.get('errored', False)) or not r.get('errored')]
    rmse_cols = [c for c in columns if 'rmse' in c]
    if not rows or 'dataset_name' not in columns or not rmse_cols:
        return {}   # nothing completed: no tables to emit
    groups = {}
    for r in rows:
        key = (r.get('dataset_name'), r.get('method_name'))
        if None not in key:
            groups.setdefault(key, []).append(r)
    stats_of = {}
    for key in sorted(groups):
        # a metric a row lacks (or logged as 'nan') counts as NaN
        vals = {c: [float(g.get(c, math.nan)) for g in groups[key]]
                for c in rmse_cols}
        stats_of[key] = {c: (_mean(v), ci(v)) for c, v in vals.items()}
    order = sorted(stats_of, key=_ordered)       # stable: ties keep a-z
    datasets = _unique(ds for ds, _ in order)
    methods = _unique(m for _, m in order)

    metrics = [c for c in columns if 'decoder_test_rmse' in c] + \
        [c for c in columns if c == 'encoder_test_rmse_orig']
    tables = {}
    for metric in metrics:
        lines = [r'\begin{tabular}{@{}l' + 'c' * len(datasets) + '}',
                 r'\toprule',
                 r'Method &' + '&'.join(DATASET_NAME_MAP.get(dn, dn)
                                        for dn in datasets) + r'\\',
                 r'\midrule']
        for method_name in methods:
            line = METHOD_NAME_MAP.get(method_name, method_name)
            for dataset_name in datasets:
                cell_stats = stats_of.get((dataset_name, method_name))
                if cell_stats is None or math.isnan(cell_stats[metric][0]):
                    line += r'& NA'
                    continue
                mean, err = cell_stats[metric]
                cell = (custom_format(mean) + r'$\pm$' +
                        custom_format(0.0 if np.isnan(err) else err))
                line += (r'& \textbf{' + cell + '}'
                         if method_name == 'insite' else '&' + cell)
            lines.append(line + r'\\')
        lines += [r'\bottomrule', r'\end{tabular}']
        tables[metric] = '\n'.join(lines)
    return tables
