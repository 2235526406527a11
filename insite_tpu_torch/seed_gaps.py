"""Per-cell seed counts of the main table over the sweep logs, without
pandas: the port of the repository's `tools/seed_gaps.py`, with the same
flags, marker files and output.

    python -m insite_tpu_torch.seed_gaps                     # the gap table
    python -m insite_tpu_torch.seed_gaps --method ct --list  # its datasets
                                                             # with gaps
    python -m insite_tpu_torch.seed_gaps --method ct --plan  # "dataset
                                                             # start count"
    python -m insite_tpu_torch.seed_gaps --next-cell         # the thinnest
                                                             # cell
    [--target N] [--logs 'logs/run-*.txt']

A cell is a (method, dataset) of the main table; its count is the number
of distinct seeds among its protocol rows. Those are the rows of the logs
whose sweep configurations are all on the protocol (epochs 100, 1,000 /
100 / 100 patients, no ``model_overrides``), each cell's row logged last
kept, by logging timestamp (`process_result_file.newest_per_cell`), then
those at gamma 2 without a noise-scale or cohort-size override and not
errored. ``--next-cell`` reads three marker files relative to the working
directory: ``logs/markers/priority_cells`` (dispatch lines, one consumed
by each read, that come before any count), ``vectorized_exclude`` (methods
whose cells run seed by seed: mode ``std``) and ``parked/<method>.<dataset>``
(a cell left out).
"""

from __future__ import annotations

import argparse
import glob
import os

from insite_tpu_torch.harness.results import (_completed, _is_missing,
                                              _read_sweep_fingerprints,
                                              concat_rows, rows_from_log)
from insite_tpu_torch.process_result_file import (newest_per_cell,
                                                  off_protocol_configs,
                                                  on_protocol)

DATASETS = ('cancer_sim', 'EQ_5_A', 'EQ_5_B', 'EQ_5_C', 'EQ_5_D',
            'EQ_4_A', 'EQ_4_B', 'EQ_4_C', 'EQ_4_D')
METHODS = ('insite', 'sindy', 'wsindy', 'crn', 'msm', 'gnet', 'ct',
           'rmsn', 'edct')
# --next-cell's order among equally thin cells
TIE_ORDER = ('insite', 'sindy', 'wsindy', 'crn', 'msm', 'gnet', 'rmsn',
             'ct', 'edct')
PRIORITY_CELLS = 'logs/markers/priority_cells'
VECTORIZED_EXCLUDE = 'logs/markers/vectorized_exclude'
PARKED = 'logs/markers/parked'


def protocol_rows(log_glob='logs/run-*.txt') -> list:
    """The protocol rows of the logs that match ``log_glob``, as dicts."""
    logs = []
    for path in sorted(glob.glob(log_glob)):
        if off_protocol_configs(_read_sweep_fingerprints(path)):
            continue
        rows = rows_from_log(path, with_ts=True)
        if rows:
            logs.append(rows)
    if not logs:
        return []
    return _completed([r for r in newest_per_cell(concat_rows(logs))
                       if on_protocol(r)])


def seeds(rows, method, dataset) -> set:
    """The distinct seeds of one cell's rows."""
    return {int(r['seed']) for r in rows
            if r['method_name'] == method and r['dataset_name'] == dataset
            and not _is_missing(r['seed'])}


def counts(rows) -> dict:
    """{(method, dataset): its number of distinct seeds} over every main
    table cell, wsindy's tumor-family cells included."""
    return {(m, ds): len(seeds(rows, m, ds))
            for m in METHODS for ds in DATASETS}


def missing_runs(have, target) -> list:
    """The seeds below ``target`` not in ``have``, as (start, count) runs
    of consecutive seeds."""
    missing = [s for s in range(target) if s not in have]
    runs = []
    while missing:
        start, k = missing[0], 1
        while k < len(missing) and missing[k] == start + k:
            k += 1
        runs.append((start, k))
        missing = missing[k:]
    return runs


def _marker_lines(path) -> set:
    """The non-empty lines of a marker file; none where it cannot be
    read."""
    try:
        with open(path) as f:
            return {line.strip() for line in f if line.strip()}
    except OSError:
        return set()


def _pop_priority_cell():
    """The first line of `PRIORITY_CELLS`, removed from the file; None
    where it holds none."""
    if not os.path.exists(PRIORITY_CELLS):
        return None
    with open(PRIORITY_CELLS) as f:
        lines = [line.strip() for line in f if line.strip()]
    if not lines:
        return None
    with open(PRIORITY_CELLS, 'w') as f:
        for line in lines[1:]:
            f.write(line + '\n')
    return lines[0]


def next_cell(rows, c, target) -> str | None:
    """``"method dataset n mode start k"`` for the thinnest cell below
    ``target`` (insite's cells count 2 less; ties in `TIE_ORDER`, then
    dataset order), parked cells left out: mode ``std`` for a method in
    `VECTORIZED_EXCLUDE` and for wsindy off the EQ_4 family (no
    vectorized column), else ``vec``; start and k the first run of missing
    seeds. None where every cell is full."""
    excl = _marker_lines(VECTORIZED_EXCLUDE)
    cells = [(c[(m, ds)] - (2 if m == 'insite' else 0), TIE_ORDER.index(m),
              DATASETS.index(ds), m, ds, c[(m, ds)])
             for m in TIE_ORDER for ds in DATASETS
             if c[(m, ds)] < target
             and not os.path.exists(f'{PARKED}/{m}.{ds}')]
    if not cells:
        return None
    _, _, _, m, ds, n = min(cells)
    mode = 'std' if (m in excl or (m == 'wsindy' and 'EQ_4' not in ds)) \
        else 'vec'
    start, k = missing_runs(seeds(rows, m, ds), target)[0]
    return f'{m} {ds} {n} {mode} {start} {k}'


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--target', type=int, default=10)
    p.add_argument('--method', default=None, choices=METHODS)
    p.add_argument('--list', action='store_true',
                   help='print only gap datasets, space-separated')
    p.add_argument('--plan', action='store_true',
                   help='print "dataset seed_start count" lines covering '
                        'the missing seeds of --method (for standard-path '
                        'top-up loops)')
    p.add_argument('--next-cell', action='store_true',
                   help='print the globally thinnest incomplete main-table '
                        'cell as "method dataset n mode start k": mode is '
                        '"std" for methods quarantined in logs/markers/'
                        'vectorized_exclude (start/k = first missing seed '
                        'range), else "vec". Empty output = all cells full.')
    p.add_argument('--logs', default='logs/run-*.txt')
    args = p.parse_args(argv)

    if args.next_cell:
        line = _pop_priority_cell()
        if line is not None:
            print(line)
            return
    rows = protocol_rows(args.logs)
    c = counts(rows)
    if args.next_cell:
        line = next_cell(rows, c, args.target)
        if line is not None:
            print(line)
        return
    if args.plan:
        if not args.method:
            raise SystemExit('--plan requires --method')
        # thinnest cells first (a stable sort: dataset order among ties)
        for ds in sorted(DATASETS, key=lambda ds: c[(args.method, ds)]):
            for start, k in missing_runs(seeds(rows, args.method, ds),
                                         args.target):
                print(f'{ds} {start} {k}')
        return
    if args.list:
        if not args.method:
            raise SystemExit('--list requires --method')
        if args.method in _marker_lines(VECTORIZED_EXCLUDE):
            print('')
            return
        gaps = [ds for ds in DATASETS if c[(args.method, ds)] < args.target]
        gaps.sort(key=lambda ds: c[(args.method, ds)])
        print(' '.join(gaps))
        return
    methods = [args.method] if args.method else list(METHODS)
    w = max(len(ds) for ds in DATASETS) + 2
    print('method'.ljust(8) + ''.join(ds.ljust(w) for ds in DATASETS))
    total = 0
    for m in methods:
        row = m.ljust(8)
        for ds in DATASETS:
            row += str(c[(m, ds)]).ljust(w)
            total += max(0, args.target - c[(m, ds)])
        print(row)
    print(f'missing seed-runs to n={args.target}: {total}')


if __name__ == '__main__':
    # queue scripts pipe the output into head or tail: a closed pipe ends
    # the process quietly
    import signal
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
    main()
