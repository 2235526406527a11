"""`python -m insite_tpu_torch.seed_gaps` against the repository's
`tools/seed_gaps.py`: the same protocol rows and counts on every tracked
sweep log, the same bytes on stdout for every flag, the same use of the
marker files; and the JAX tool's own four cases, on plain rows."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from insite_tpu_torch import seed_gaps as port

ROOT = Path(__file__).resolve().parent.parent
LOGS = str(ROOT / 'logs' / 'run-*.txt')

spec = importlib.util.spec_from_file_location(
    'jax_seed_gaps', ROOT / 'tools' / 'seed_gaps.py')
jax_tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(jax_tool)


@pytest.fixture(scope='module')
def tracked():
    """Both tools' protocol rows of every tracked log, read once, and the
    JAX tool's counts of them (pandas takes ~0.15 s for those)."""
    df = jax_tool.protocol_df(LOGS)
    return df, port.protocol_rows(LOGS), jax_tool.counts(df)


def _read_once(monkeypatch, tracked):
    """Both tools' `main` on the rows read once."""
    df, rows, counts = tracked
    monkeypatch.setattr(jax_tool, 'protocol_df', lambda logs: df)
    monkeypatch.setattr(jax_tool, 'counts', lambda d: counts)
    monkeypatch.setattr(port, 'protocol_rows', lambda logs: rows)


def _jax_out(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, 'argv', ['seed_gaps.py'] + argv)
    jax_tool.main()
    return capsys.readouterr().out


def _port_out(argv, capsys):
    port.main(argv)
    return capsys.readouterr().out


def _both(argv, capsys, monkeypatch, tracked=None):
    """Both tools' stdout for ``argv``; on the rows read once where
    ``tracked`` is given, else reading the logs themselves."""
    if tracked is not None:
        _read_once(monkeypatch, tracked)
    return _jax_out(argv, capsys, monkeypatch), _port_out(argv, capsys)


def test_protocol_rows_match_jax(tracked):
    df, rows, counts = tracked
    assert len(rows) == len(df) > 0
    assert {(r['method_name'], r['dataset_name'], int(r['seed']))
            for r in rows} == set(zip(df.method_name, df.dataset_name,
                                      df.seed.astype(int)))
    assert port.counts(rows) == counts


def test_default_table_reads_the_logs_as_jax(capsys, monkeypatch):
    ref, ours = _both(['--logs', LOGS], capsys, monkeypatch)
    assert ours == ref
    assert ours.startswith('method  cancer_sim')
    assert ours.splitlines()[-1].startswith('missing seed-runs to n=10: ')


ARGVS = [['--target', '12'], ['--method', 'edct'], ['--next-cell'],
         ['--next-cell', '--target', '3'], ['--target', '0']] + \
    [['--method', m, flag] for m in port.METHODS
     for flag in ('--list', '--plan')] + \
    [['--method', 'edct', '--plan', '--target', '12']]


@pytest.mark.parametrize('argv', ARGVS, ids=' '.join)
def test_stdout_matches_jax(argv, tracked, capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)         # no marker files
    ref, ours = _both(argv, capsys, monkeypatch, tracked)
    assert ours == ref


def _markers(path, priority=None, exclude=None, parked=()):
    os.makedirs(path / 'logs' / 'markers' / 'parked')
    if priority is not None:
        (path / 'logs/markers/priority_cells').write_text(priority)
    if exclude is not None:
        (path / 'logs/markers/vectorized_exclude').write_text(exclude)
    for cell in parked:
        (path / 'logs/markers/parked' / cell).write_text('')


@pytest.mark.parametrize('exclude,parked', [
    (None, ()), ('edct\n', ()), ('edct\ngnet\n', ('edct.EQ_4_A',)),
    (None, tuple(f'edct.{ds}' for ds in port.DATASETS)),
    ('\nwsindy\n', tuple(f'{m}.{ds}' for m in ('edct', 'gnet')
                         for ds in port.DATASETS))])
def test_next_cell_markers_match_jax(exclude, parked, tracked, capsys,
                                     monkeypatch, tmp_path):
    """The vectorized quarantine and parked cells, for --next-cell and
    --list, in two copies of one marker directory."""
    outs = []
    for tool in ('jax', 'port'):
        (tmp_path / tool).mkdir()
        _markers(tmp_path / tool, exclude=exclude, parked=parked)
        monkeypatch.chdir(tmp_path / tool)
        got = []
        for argv in (['--next-cell'], ['--next-cell', '--target', '11'],
                     ['--method', 'edct', '--list'],
                     ['--method', 'gnet', '--list']):
            ref, ours = _both(argv, capsys, monkeypatch, tracked)
            got.append(ref if tool == 'jax' else ours)
        outs.append(got)
    assert outs[0] == outs[1]


def test_priority_cells_are_consumed_once_as_jax(tracked, capsys,
                                                 monkeypatch, tmp_path):
    """Each --next-cell read takes the first priority line and removes it
    from the file; once none is left, the thinnest cell comes."""
    seen = {}
    for tool in ('jax', 'port'):
        (tmp_path / tool).mkdir()
        _markers(tmp_path / tool,
                 priority='ct EQ_4_D 8 std 5 2\n\nedct cancer_sim 2 std 2 3\n')
        monkeypatch.chdir(tmp_path / tool)
        _read_once(monkeypatch, tracked)
        got = []
        for _ in range(3):
            got.append(_jax_out(['--next-cell'], capsys, monkeypatch)
                       if tool == 'jax' else
                       _port_out(['--next-cell'], capsys))
            got.append((tmp_path / tool /
                        'logs/markers/priority_cells').read_text())
        seen[tool] = got
    assert seen['port'] == seen['jax']
    assert seen['port'][:4] == ['ct EQ_4_D 8 std 5 2\n',
                                'edct cancer_sim 2 std 2 3\n',
                                'edct cancer_sim 2 std 2 3\n', '']
    assert seen['port'][4] == 'edct EQ_4_A 2 vec 0 2\n'


def test_python_m_prints_the_jax_tools_table(tracked, capsys, monkeypatch,
                                             tmp_path):
    """The module run as a program, from another working directory,
    prints the JAX tool's table of the rows read once."""
    out = subprocess.run(
        [sys.executable, '-m', 'insite_tpu_torch.seed_gaps', '--logs', LOGS],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ, 'PYTHONPATH': str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    _read_once(monkeypatch, tracked)
    assert out.stdout == _jax_out([], capsys, monkeypatch)


# ---------------------------------------------------------------------------
# tests/test_seed_gaps.py's cases, on plain rows

def test_counts_include_wsindy_tumor_cells():
    c = port.counts([{'method_name': 'wsindy', 'dataset_name': 'EQ_4_A',
                      'seed': 0}])
    assert c[('wsindy', 'cancer_sim')] == 0
    assert c[('wsindy', 'EQ_4_A')] == 1


def test_next_cell_consumes_priority_lines_one_shot(tmp_path, capsys,
                                                    monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs('logs/markers')
    with open('logs/markers/priority_cells', 'w') as f:
        f.write('ct EQ_4_D 8 std 5 2\nedct cancer_sim 2 std 2 3\n')
    port.main(['--next-cell'])
    assert capsys.readouterr().out.strip() == 'ct EQ_4_D 8 std 5 2'
    port.main(['--next-cell'])
    assert capsys.readouterr().out.strip() == 'edct cancer_sim 2 std 2 3'
    with open('logs/markers/priority_cells') as f:
        assert f.read() == ''            # both lines consumed


def test_plan_groups_consecutive_missing_runs(capsys, monkeypatch):
    rows = [{'method_name': 'crn', 'dataset_name': 'EQ_4_A', 'seed': s}
            for s in (2, 3, 7)]
    monkeypatch.setattr(port, 'protocol_rows', lambda logs: rows)
    port.main(['--method', 'crn', '--plan'])
    out = [line for line in capsys.readouterr().out.splitlines()
           if line.startswith('EQ_4_A')]
    # missing: 0-1, 4-6, 8-9 -> three consecutive ranges
    assert out == ['EQ_4_A 0 2', 'EQ_4_A 4 3', 'EQ_4_A 8 2']


def test_protocol_rows_reject_hparam_variant_sweeps(tmp_path):
    """A sweep whose configuration carries non-empty model_overrides is
    not main-table evidence, even at the protocol's scale."""
    row = ("{'encoder_test_rmse_orig': 0.5, 'method': 'ct', 'seed': 0, "
           "'errored': False, 'dataset_name': 'EQ_4_D', "
           "'method_name': 'ct', 'domain_conf': 2.0}")
    proto = ('{"epochs": 100, "train_samples": 1000, "val_samples": 100, '
             '"test_samples": 100, "model_overrides": %s}')
    for name, mo in (('plain', '{}'),
                     ('variant', '{"ct": {"alpha": 0.001}}')):
        with open(tmp_path / f'run-{name}.txt', 'w') as f:
            f.write(f'2026-08-20 10:00:00,000 INFO [Sweep config] '
                    f'{proto % mo}\n')
            f.write(f'2026-08-20 10:00:01,000 INFO '
                    f'[Exp evaluation complete] {row}\n')
    rows = port.protocol_rows(log_glob=str(tmp_path / 'run-*.txt'))
    assert len(rows) == 1          # only the default-hparam sweep survives
