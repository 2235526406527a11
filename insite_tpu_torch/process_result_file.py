"""Regenerate the paper's tables from sweep logs, without pandas: the
port of the repository's `process_result_file.py`, with the same
arguments and the same output.

    python -m insite_tpu_torch.process_result_file logs/run-*.txt \\
        [--protocol] [--csv OUT] [--std] [--paper] [--plots DIR] \\
        [--vs-reference REF_LOG]

The rows of all the logs form one frame. Where several rows describe the
same cell (dataset, method, seed, gamma, and the noise scale or training
cohort size of an INSIGHT sweep), the one logged last wins, by the rows'
logging timestamps, not by the order of the arguments. ``--protocol``
skips every log with a sweep configuration off the main table's protocol
and keeps the rows at gamma 2 without a noise-scale or cohort-size
override. ``--csv`` writes the frame, ``--vs-reference`` prints a
side-by-side markdown table against another log, ``--paper`` prints the
paper's table layout, ``--std`` puts the standard deviation where the 95 %
t-interval stands, and ``--plots`` draws the n-step figure (and the
confounding one when the rows hold several gammas; needs matplotlib).
"""

from __future__ import annotations

import argparse
import csv
import math
import os

from insite_tpu_torch.harness import plots
from insite_tpu_torch.harness.results import (
    _is_missing, _read_sweep_fingerprints, _unique, concat_rows,
    generate_main_results_table, generate_main_results_table_paper_format,
    parity_table, rows_from_log)

# the main table's sweep settings
PROTOCOL = {'epochs': 100, 'train_samples': 1000, 'val_samples': 100,
            'test_samples': 100}
# the columns that name a cell; the last logged row of a cell wins
KEY_COLUMNS = ('dataset_name', 'method_name', 'seed', 'domain_conf',
               'noise_scale', 'train_samples')


def _cell_key(row, key) -> tuple:
    """``row``'s values of ``key``, every missing value one and the same
    (pandas finds NaN keys equal)."""
    return tuple(None if _is_missing(row[c]) else row[c] for c in key)


def newest_per_cell(rows) -> list:
    """The rows ordered by ``_log_ts`` (a stable sort), each cell's last
    one kept, ``_log_ts`` dropped: pandas' ``sort_values('_log_ts',
    kind='stable').drop_duplicates(key, keep='last')``."""
    key = [c for c in KEY_COLUMNS if rows and c in rows[0]]
    ordered = sorted(rows, key=lambda r: r['_log_ts'])
    last = {_cell_key(r, key): i for i, r in enumerate(ordered)}
    return [{c: v for c, v in r.items() if c != '_log_ts'}
            for i, r in enumerate(ordered) if last[_cell_key(r, key)] == i]


def on_protocol(row) -> bool:
    """A main-table row: gamma 2, no noise scale but 1, no cohort-size
    override (the INSIGHT sweeps' rows)."""
    if not float(row.get('domain_conf', math.nan)) == 2.0:
        return False
    noise = row.get('noise_scale', math.nan)
    if not (_is_missing(noise) or noise == 1.0):
        return False
    return _is_missing(row.get('train_samples', math.nan))


def off_protocol_configs(fps) -> list:
    """The sweep configurations among ``fps`` that are off the protocol:
    another scale or epoch count, or a hyperparameter variant (non-empty
    ``model_overrides``)."""
    return [fp for fp in fps
            if any(fp.get(k) != v for k, v in PROTOCOL.items())
            or fp.get('model_overrides')]


def _off_protocol(path) -> bool:
    """Print and return True where ``path`` holds a sweep configuration
    off the protocol (`off_protocol_configs`)."""
    fps = _read_sweep_fingerprints(path)
    bad = off_protocol_configs(fps)
    if bad:
        print(f'[protocol] skipping {path}: {len(bad)} of {len(fps)} sweep '
              f'config(s) off-protocol, e.g. '
              f'{ {k: bad[0].get(k) for k in PROTOCOL} }')
        return True
    if not fps:
        print(f'[protocol] {path}: no [Sweep config] fingerprint '
              f'(pre-fingerprint log) — rows kept unverified')
    return False


def _csv_value(v):
    """A cell as pandas' ``to_csv`` writes it: NaN as an empty field."""
    return '' if _is_missing(v) else v


def write_csv(rows, path) -> None:
    """The frame, one line a row, the columns in order of first
    appearance."""
    columns = _unique(k for r in rows for k in r)
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(columns)
        for r in rows:
            w.writerow([_csv_value(r.get(c, math.nan)) for c in columns])


def _n_unique(rows, column) -> int:
    return len({r[column] for r in rows if not _is_missing(r.get(column))})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('log_path', nargs='+', help='sweep log(s) containing '
                   '"[Exp evaluation complete] {...}" lines')
    p.add_argument('--protocol', action='store_true',
                   help='keep only main-table protocol rows: gamma == 2 '
                        'and no noise_scale / train_samples override '
                        'columns set')
    p.add_argument('--csv', default=None,
                   help='also write the parsed runs to CSV')
    p.add_argument('--std', action='store_true',
                   help='report std instead of the default 95%% t-CI')
    p.add_argument('--paper', action='store_true',
                   help='emit the paper-format tabularx tables (grouped '
                        'LTE/ODE-D rows, shaded INSITE) instead of the '
                        'plain tabular layout')
    p.add_argument('--plots', default=None, metavar='DIR',
                   help='also render n-step (and, when multiple '
                        'domain_conf values exist, confounding) figures')
    p.add_argument('--vs-reference', default=None, metavar='REF_LOG',
                   help='side-by-side markdown table against a reference '
                        'sweep log')
    args = p.parse_args(argv)

    logs = []
    for path in args.log_path:
        if not os.path.exists(path):
            raise SystemExit(f'log file not found: {path}')
        if args.protocol and _off_protocol(path):
            continue
        rows = rows_from_log(path, with_ts=True)
        if rows:
            logs.append(rows)
    if not logs:
        raise SystemExit(f'no completed runs found in {args.log_path}')
    rows = newest_per_cell(concat_rows(logs))
    if args.protocol:
        rows = [r for r in rows if on_protocol(r)]
    print(f'parsed {len(rows)} completed runs '
          f'({_n_unique(rows, "dataset_name")} datasets x '
          f'{_n_unique(rows, "method_name")} methods)')
    if args.csv:
        write_csv(rows, args.csv)
        print(f'wrote {args.csv}')
    if args.vs_reference:
        print(parity_table(rows, rows_from_log(args.vs_reference)))
    table_fn = (generate_main_results_table_paper_format if args.paper
                else generate_main_results_table)
    for metric, table in table_fn(rows, use_95_ci=not args.std).items():
        print(f'\nLatex Table:: {metric}\n{table}')

    if args.plots:
        os.makedirs(args.plots, exist_ok=True)
        print('wrote', plots.plot_n_step_rmses(
            rows, os.path.join(args.plots, 'n_step_rmse.png'),
            use_95_ci=not args.std))
        if _n_unique(rows, 'domain_conf') > 1:
            print('wrote', plots.plot_confounding_sweep(
                rows, os.path.join(args.plots, 'confounding.png'),
                use_95_ci=not args.std))


if __name__ == '__main__':
    main()
