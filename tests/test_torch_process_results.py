"""The results CLI: the port's `python -m
insite_tpu_torch.process_result_file` against the repository's
`process_result_file.py` (pandas) on the tracked sweep logs, in every
mode, stdout compared line for line and the CSVs value for value; and the
two results features it rests on, `rows_from_log(with_ts=True)` and the
tables' `use_95_ci=False`, against the JAX package's."""

import csv
import glob
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from insite_tpu.harness import results as jax_results
from insite_tpu_torch import process_result_file
from insite_tpu_torch.harness import results
from insite_tpu_torch.harness.results import EPOCH, TAG, rows_from_log

ROOT = Path(__file__).resolve().parent.parent
# every tracked sweep log: 1,500-odd rows, cells logged more than once
# across logs (newest wins), logs off the protocol, INSIGHT rows with
# noise_scale or train_samples
LOGS = sorted(glob.glob(str(ROOT / 'logs' / 'run-*.txt')))
REFERENCE = str(ROOT / 'logs' / 'run-20260818-130816.txt')
JAX_CLI_TIMEOUT_S = 300
CSV_RTOL = 1e-12
CASES = {'plain': [], 'protocol': ['--protocol'], 'std': ['--std'],
         'paper': ['--paper'], 'vs-reference': ['--vs-reference', REFERENCE],
         'csv': ['--csv', '{csv}']}


def _jax_cli(args):
    proc = subprocess.run([sys.executable, 'process_result_file.py', *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=JAX_CLI_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _values(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def _as_float(cell):
    if cell == '':
        return math.nan
    try:
        return float(cell)
    except ValueError:
        return None


def _assert_same_csv(got_path, want_path):
    got, want = _values(got_path), _values(want_path)
    assert got[0] == want[0]                       # the columns, in order
    assert len(got) == len(want)
    for row_g, row_w in zip(got[1:], want[1:]):
        assert len(row_g) == len(row_w)
        for g, w in zip(row_g, row_w):
            fg, fw = _as_float(g), _as_float(w)
            if fg is None or fw is None:
                assert g == w
            else:
                np.testing.assert_allclose(fg, fw, rtol=CSV_RTOL, atol=0,
                                           equal_nan=True)


def test_the_logs_hold_cells_logged_twice():
    """Newest-wins decides on these logs: fewer rows are kept than read."""
    rows = [r for p in LOGS for r in rows_from_log(p)]
    kept = process_result_file.newest_per_cell(results.concat_rows(
        [rows_from_log(p, with_ts=True) for p in LOGS]))
    assert len(LOGS) >= 2 and len(kept) < len(rows)


@pytest.mark.parametrize('case', list(CASES))
def test_cli_matches_process_result_file(case, tmp_path, capsys):
    args = [a.replace('{csv}', str(tmp_path / 'jax.csv'))
            for a in CASES[case]]
    want = _jax_cli(LOGS + args)
    port_args = [a.replace('{csv}', str(tmp_path / 'port.csv'))
                 for a in CASES[case]]
    process_result_file.main(LOGS + port_args)
    got = capsys.readouterr().out
    if case == 'csv':
        got = got.replace('port.csv', 'jax.csv')
        _assert_same_csv(tmp_path / 'port.csv', tmp_path / 'jax.csv')
    assert got.splitlines() == want.splitlines()
    assert 'Latex Table:: ' in got


def test_rows_from_log_with_ts_match_df_from_log(tmp_path):
    """Every tracked log's timestamps, and a line without one (epoch 0 in
    both), as pandas parses them."""
    odd = tmp_path / 'odd.txt'
    odd.write_text(
        '2026-01-02 03:04:05,678 INFO ' + TAG + "{'seed': 0}\n"
        + TAG + "{'seed': 1}\n"
        + 'not a time DEBUG ' + TAG + "{'seed': 2}\n")
    for path in LOGS + [str(odd)]:
        rows = rows_from_log(path, with_ts=True)
        df = jax_results.df_from_log(path, with_ts=True)
        want = df['_log_ts'] if len(df) else []    # a log without rows
        assert [r['_log_ts'] for r in rows] == \
            [t.to_pydatetime() for t in want]
    assert [r['_log_ts'] for r in rows_from_log(odd, with_ts=True)][1:] == \
        [EPOCH, EPOCH]
    assert '_log_ts' not in rows_from_log(odd)[0]


@pytest.mark.parametrize('paper', [False, True], ids=['plain', 'paper'])
def test_tables_with_std_match_jax(paper):
    logs = LOGS[:40]
    rows = [r for p in logs for r in rows_from_log(p)]
    df = pd.concat([jax_results.df_from_log(p) for p in logs],
                   ignore_index=True)
    if paper:
        ours = results.generate_main_results_table_paper_format(
            rows, use_95_ci=False)
        ref = jax_results.generate_main_results_table_paper_format(
            df, use_95_ci=False)
    else:
        ours = results.generate_main_results_table(rows, use_95_ci=False)
        ref = jax_results.generate_main_results_table(df, use_95_ci=False)
    assert ours == ref and ours
    with_ci = (results.generate_main_results_table_paper_format if paper
               else results.generate_main_results_table)(rows)
    assert with_ci != ours


def test_plots_write_the_same_files(tmp_path, capsys):
    """``--plots DIR``: the same figures, named alike, as the JAX
    script's."""
    logs = LOGS[:40]
    want = _jax_cli(logs + ['--plots', str(tmp_path / 'jax')])
    process_result_file.main(logs + ['--plots', str(tmp_path / 'port')])
    got = capsys.readouterr().out
    assert got.replace(str(tmp_path / 'port'), 'OUT').splitlines() == \
        want.replace(str(tmp_path / 'jax'), 'OUT').splitlines()
    names = sorted(p.name for p in (tmp_path / 'port').iterdir())
    assert names == sorted(p.name for p in (tmp_path / 'jax').iterdir())
    assert 'n_step_rmse.png' in names
