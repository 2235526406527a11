"""Results tools without pandas: the sweep log's rows back as dicts (with
each line's logging timestamp if asked) and its sweep configurations,
several logs' rows as one frame, the 95 % t-interval, the LaTeX main table
and the paper's, and the markdown parity table, whose texts are those of
`insite_tpu.harness.results`'s `generate_main_results_table`,
`generate_main_results_table_paper_format` and `parity_table` on the same
rows."""

from __future__ import annotations

import ast
import json
import math
from datetime import datetime

import numpy as np

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
    # scipy.stats takes seconds to import, and only the tables need it
    from scipy import stats
    a = 1.0 * np.array(data)
    n = a.shape[axis]
    se = stats.sem(a, axis=axis)
    return se * stats.t.ppf((1 + confidence) / 2.0, n - 1)


def custom_format(number, threshold=1e-2):
    if abs(number) < threshold:
        return '0.00' if number == 0 else f'{number:.2e}'
    return f'{number:.2f}'


# what `_log_ts` holds for a line whose timestamp cannot be parsed
EPOCH = datetime(1970, 1, 1)


def _line_ts(line: str) -> datetime:
    """The logging timestamp that starts ``line``, read as the JAX
    package's `df_from_log` reads it (the text before ' INFO' or ' DEBUG',
    ',' taken as the decimal point); `EPOCH` where it cannot be parsed."""
    try:
        return datetime.fromisoformat(
            line.split(' INFO')[0].split(' DEBUG')[0].replace(',', '.')
            .strip())
    except ValueError:
        return EPOCH


def rows_from_log(path, with_ts=False) -> list:
    """The '[Exp evaluation complete] {...}' lines of a sweep log, as
    dicts. ``with_ts``: each row also carries ``_log_ts``, its line's
    logging timestamp (a `datetime`), so that rows of the same cell from
    several logs can be ordered by when they were written."""
    rows = []
    with open(path) as f:
        for line in f:
            if TAG + '{' in line:
                payload = line.split(TAG)[1].strip()
                payload = payload.replace('nan', "'nan'")
                payload = payload.replace('array', '')
                row = ast.literal_eval(payload)
                if with_ts:
                    row['_log_ts'] = _line_ts(line)
                rows.append(row)
    return rows


def _read_sweep_fingerprints(log_path: str) -> list:
    """Every distinct '[Sweep config] {json}' of a sweep log (a log can
    hold several appended sweeps, each writing rows under its own config);
    [] for a log without one or a path that cannot be read."""
    tag = '[Sweep config] '
    fps = []
    try:
        with open(log_path) as f:
            for line in f:
                if tag in line:
                    try:
                        fp = json.loads(line.split(tag, 1)[1])
                    except json.JSONDecodeError:
                        continue
                    if fp not in fps:
                        fps.append(fp)
    except OSError:
        return []
    return fps


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _is_missing(v) -> bool:
    """None or NaN: what pandas' ``isna`` finds missing."""
    return v is None or _is_nan(v)


def concat_rows(row_lists) -> list:
    """Several logs' rows as one frame, as `pandas.concat` of their
    frames makes it: every row carries every column, in order of first
    appearance, NaN where its log has none."""
    rows = [r for rows in row_lists for r in rows]
    columns = _unique(k for r in rows for k in r)
    return [{c: r.get(c, math.nan) for c in columns} for r in rows]


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


def _std(values) -> float:
    """Population standard deviation over the non-NaN values (NaN if
    none), as pandas aggregates with `np.std`."""
    v = np.asarray([x for x in values if not math.isnan(x)], float)
    return float(np.std(v)) if v.size else math.nan


def _completed(rows) -> list:
    """The rows not marked errored (a NaN mark counts as not errored)."""
    return [r for r in rows
            if _is_nan(r.get('errored', False)) or not r.get('errored')]


def _cell_stats(rows, use_95_ci=True):
    """(columns, {(dataset, method): {rmse column: (mean, error)}}, the
    cells in table order) of the completed rows, or None where no table
    can be made; the error is the 95 % t-interval or, without
    ``use_95_ci``, the standard deviation. Column order is first
    appearance; cells sort by the dataset and method orderings, unknown
    names last; rows with a missing or NaN name are left out."""
    columns = [c for c in _unique(k for r in rows for k in r)
               if c != 'errored']
    rows = _completed(rows)
    rmse_cols = [c for c in columns if 'rmse' in c]
    if not rows or 'dataset_name' not in columns or not rmse_cols:
        return None   # nothing completed: no tables to emit
    groups = {}
    for r in rows:
        key = (r.get('dataset_name'), r.get('method_name'))
        if not any(_is_missing(k) for k in key):
            groups.setdefault(key, []).append(r)
    err = ci if use_95_ci else _std
    stats_of = {}
    for key in sorted(groups):
        # a metric a row lacks (or logged as 'nan') counts as NaN
        vals = {c: [float(g.get(c, math.nan)) for g in groups[key]]
                for c in rmse_cols}
        stats_of[key] = {c: (_mean(v), err(v)) for c, v in vals.items()}
    order = sorted(stats_of, key=_ordered)       # stable: ties keep a-z
    return columns, stats_of, order


def _cell(stats, metric):
    """(mean, error) strings of a cell, or None where it has no mean."""
    if stats is None or math.isnan(stats[metric][0]):
        return None
    mean, err = stats[metric]
    return custom_format(mean), custom_format(0.0 if np.isnan(err) else err)


def generate_main_results_table(rows, use_95_ci=True) -> dict:
    """LaTeX table per n-step metric and for the 1-step
    ``encoder_test_rmse_orig``: per (dataset, method), the mean over seeds
    and its 95 % t-interval (0.00 where the interval is NaN, n = 1), or
    without ``use_95_ci`` its standard deviation."""
    agg = _cell_stats(rows, use_95_ci)
    if agg is None:
        return {}
    columns, stats_of, order = agg
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
                cell = _cell(stats_of.get((dataset_name, method_name)),
                             metric)
                if cell is None:
                    line += r'& NA'
                    continue
                cell = cell[0] + r'$\pm$' + cell[1]
                line += (r'& \textbf{' + cell + '}'
                         if method_name == 'insite' else '&' + cell)
            lines.append(line + r'\\')
        lines += [r'\bottomrule', r'\end{tabular}']
        tables[metric] = '\n'.join(lines)
    return tables


ODE_METHODS = ('sindy', 'wsindy', 'insite')


def generate_main_results_table_paper_format(rows, use_95_ci=True) -> dict:
    """The paper's LaTeX tables, one per n-step metric: a tabularx layout
    with \\cref dataset headers, the learned-treatment-effect (LTE) and
    ODE-discovery (ODE-D) method groups, and the INSITE row shaded and in
    bold. A group with no method in the rows emits nothing. The ± is the
    95 % t-interval or, without ``use_95_ci``, the standard deviation."""
    agg = _cell_stats(rows, use_95_ci)
    if agg is None:
        return {}
    columns, stats_of, order = agg
    datasets = _unique(ds for ds, _ in order)
    methods = _unique(m for _, m in order)
    eq4, eq5 = r'{\bf\cref{eq:one-compartment-pkpd}', r'{\bf\cref{eq:tumor}'
    name_map = {f'EQ_4_{v}': f'{eq4}.{v}' + r'}' for v in 'ABCD'}
    name_map.update({f'EQ_5_{v}': f'{eq5}.{v}' + r'}' for v in 'ABCD'})
    name_map['cancer_sim'] = 'Cancer PKPD'
    lte_methods = [m for m in methods if m not in ODE_METHODS]
    oded_methods = [m for m in methods if m in ODE_METHODS]

    tables = {}
    for metric in [c for c in columns if 'decoder_test_rmse' in c]:
        lines = [r'\begin{tabularx}{\textwidth}{cr | *{' +
                 f'{len(datasets)}' + r'}{X}}', r'\toprule',
                 r'&{\bf Method}&' + '&'.join(
                     name_map.get(dn, dn) for dn in datasets) + r'\\',
                 r'\midrule']
        # a rotated group label spans exactly its group's rows
        if lte_methods:
            lines.append(r'\multirow{' + str(len(lte_methods)) +
                         r'}{*}{\rotatebox{90}{\bf LTE}}')
        ode_group_started = False
        for method_name in lte_methods + oded_methods:
            if method_name in ODE_METHODS and not ode_group_started:
                if lte_methods:
                    lines.append(r'\midrule')
                lines.append(r'\multirow{' + str(len(oded_methods)) +
                             r'}{*}{\rotatebox{90}{\bf ODE-D}}')
                ode_group_started = True
            is_insite = method_name == 'insite'
            line = (r'& \CC{black!5} INSITE' if is_insite else
                    '&' + METHOD_NAME_MAP.get(method_name, method_name))
            for dataset_name in datasets:
                cell = _cell(stats_of.get((dataset_name, method_name)),
                             metric)
                if cell is None:
                    line += r'& NA'
                elif is_insite:
                    line += (r'& \CC{black!5} {\bf ' + cell[0] + r'} ' +
                             r'{\footnotesize $\pm$' + cell[1] + r'}')
                else:
                    line += ('&' + cell[0] + r'{\footnotesize $\pm$' +
                             cell[1] + r'}')
            lines.append(line + r'\\')
        lines += [r'\bottomrule', r'\end{tabularx}']
        tables[metric] = '\n'.join(lines)
    return tables


def parity_table(rows_ours, rows_ref,
                 metrics=('encoder_test_rmse_orig',
                          'decoder_test_rmse_6-step')) -> str:
    """Side-by-side ours-vs-reference markdown table of two lists of rows
    (each as `rows_from_log` reads a sweep log). Cells are mean±std
    (ddof 0, NaN skipped) over seeds; '**' marks the better mean (ours
    on a tie)."""
    def agg(rows):
        present = set(k for r in rows for k in r)
        groups = {}
        for r in _completed(rows):
            groups.setdefault((r['dataset_name'], r['method_name']),
                              []).append(r)
        out = {}
        for key in sorted(groups):
            g = groups[key]
            out[key] = {}
            for k in metrics:
                if k not in present:
                    continue
                v = np.array([float(r.get(k, math.nan)) for r in g])
                v = v[~np.isnan(v)]
                out[key][k] = ((v.mean(), v.std(), len(g)) if len(v)
                               else (math.nan, math.nan, len(g)))
        return out

    ours, ref = agg(rows_ours), agg(rows_ref)
    keys = sorted(set(ours) & set(ref))
    if not keys:
        return '(no overlapping (dataset, method) cells)'
    head = '| dataset | method | n | ' + ' | '.join(
        f'{m} ours | ref' for m in metrics) + ' |'
    sep = '|' + '---|' * (3 + 2 * len(metrics))
    lines = [head, sep]
    for ds, m in keys:
        cells = [ds, m, str(ours[(ds, m)][metrics[0]][2])]
        for metric in metrics:
            o = ours[(ds, m)].get(metric)
            r = ref[(ds, m)].get(metric)
            if o is None or r is None:
                cells += ['—', '—']
                continue
            o_s = f'{o[0]:.3f}±{o[1]:.3f}'
            r_s = f'{r[0]:.3f}±{r[1]:.3f}'
            if o[0] <= r[0]:
                o_s = f'**{o_s}**'
            else:
                r_s = f'**{r_s}**'
            cells += [o_s, r_s]
        lines.append('| ' + ' | '.join(cells) + ' |')
    return '\n'.join(lines)
