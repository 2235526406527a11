"""The figure CLI: the port's `python -m insite_tpu_torch.make_figures`
against the repository's `make_figures.py` (pandas) on tracked logs and
result JSONs: the same files written and the same lines printed, and the
rows each of the port's row functions hands to its plot against the frame
the JAX script hands to the same plot, through the plots' `_agg`
(per-group means and errors, rtol 1e-12)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import make_figures as jax_make_figures
from insite_tpu.harness import plots as jax_plots
from insite_tpu_torch import make_figures
from insite_tpu_torch.harness import plots

ROOT = Path(__file__).resolve().parent.parent
LOGS = ROOT / 'logs'
# n-step panels: sindy, insite and wsindy on EQ_4_D and cancer_sim (with
# errored rows), EQ_4_A, and ct on EQ_4_D
NSTEP_LOGS = [str(LOGS / f'run-{ts}.txt') for ts in
              ('20260817-094542', '20260818-221220', '20260819-151918')]
# INSIGHT_LESS_SAMPLES sweeps (rows carry train_samples) and a log whose
# rows do not
LESS_LOGS = [str(LOGS / f'run-{ts}.txt') for ts in
             ('20260817-135200', '20260818-135414', '20260819-180551')]
CONFOUNDING = str(LOGS / 'conf10.json')
RECOVER = str(LOGS / 'recover_dist.json')
RTOL = 1e-12
JAX_CLI_TIMEOUT_S = 300
ARGS = ['--nstep', *NSTEP_LOGS, '--confounding', CONFOUNDING, '--metrics',
        'all', '--recover', RECOVER, '--less-samples', *LESS_LOGS]


def test_clis_write_the_same_files(tmp_path, capsys):
    jax_out, port_out = tmp_path / 'jax', tmp_path / 'port'
    proc = subprocess.run([sys.executable, 'make_figures.py', *ARGS,
                           '--out', str(jax_out)], cwd=ROOT,
                          capture_output=True, text=True,
                          timeout=JAX_CLI_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-2000:]
    make_figures.main([*ARGS, '--out', str(port_out)])
    got = capsys.readouterr().out.replace(str(port_out), 'OUT')
    assert got.splitlines() == \
        proc.stdout.replace(str(jax_out), 'OUT').splitlines()
    names = sorted(p.name for p in port_out.iterdir())
    assert names == sorted(p.name for p in jax_out.iterdir())
    assert {'n_step_rmse.png', 'confounding_sweep.png', 'recovered_dist.png',
            'sample_efficiency.png'} <= set(names)
    for name in names:
        assert (port_out / name).read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'


def test_nothing_to_do(tmp_path, capsys):
    make_figures.main(['--out', str(tmp_path)])
    assert capsys.readouterr().out == \
        'nothing to do (pass --nstep and/or --confounding)\n'


def _jax_frame(monkeypatch, plot_name, build):
    """The frame (or data) the JAX script hands to ``plot_name``."""
    seen = []
    monkeypatch.setattr(jax_plots, plot_name,
                        lambda data, out, **kw: seen.append(data) or out)
    build()
    return seen[0]


def _assert_same_agg(rows, df, group_cols):
    for use_95_ci in (True, False):
        means, errs, label = plots._agg(rows, group_cols, use_95_ci)
        ref_m, ref_e, ref_label = jax_plots._agg(df, group_cols, use_95_ci)
        assert label == ref_label
        assert list(means) == [k if isinstance(k, tuple) else (k,)
                               for k in ref_m.index]
        cols = list(next(iter(means.values())))
        assert cols == list(ref_m.columns)
        for key in means:
            for got, ref in ((means, ref_m), (errs, ref_e)):
                np.testing.assert_allclose(
                    [got[key][c] for c in cols],
                    ref.loc[key].to_numpy(float), rtol=RTOL, atol=0,
                    equal_nan=True)


@pytest.mark.parametrize('datasets', [None, ['EQ_4_D', 'EQ_4_A']],
                         ids=['all', 'two'])
def test_nstep_rows_match_jax(datasets, monkeypatch, tmp_path):
    df = _jax_frame(monkeypatch, 'plot_n_step_rmses',
                    lambda: jax_make_figures.nstep_figure(
                        NSTEP_LOGS, str(tmp_path), datasets))
    rows = make_figures.nstep_rows(NSTEP_LOGS, datasets)
    assert len(rows) == len(df)
    assert [r['dataset_name'] for r in rows] == list(df.dataset_name)
    _assert_same_agg(rows, df, ['dataset_name', 'method_name'])


def test_confounding_rows_match_jax(monkeypatch, tmp_path):
    df = _jax_frame(monkeypatch, 'plot_confounding_sweep',
                    lambda: jax_make_figures.confounding_figure(
                        CONFOUNDING, str(tmp_path)))
    rows, metrics = make_figures.confounding_rows(CONFOUNDING)
    assert len(rows) == len(df) and 'decoder_test_rmse_6-step' in metrics
    _assert_same_agg(rows, df, ['method_name', 'domain_conf'])


def test_less_samples_rows_match_jax(monkeypatch, tmp_path):
    df = _jax_frame(monkeypatch, 'plot_sample_efficiency',
                    lambda: jax_make_figures.less_samples_figure(
                        LESS_LOGS, str(tmp_path)))
    rows = make_figures.less_samples_rows(LESS_LOGS)
    assert len(rows) == len(df) and len(rows) > 0
    _assert_same_agg(rows, df, ['method_name', 'train_samples'])


def test_recover_data_matches_jax(monkeypatch, tmp_path):
    ref = _jax_frame(monkeypatch, 'plot_recovered_dist',
                     lambda: jax_make_figures.recover_figure(
                         RECOVER, str(tmp_path)))
    assert make_figures.recover_data(RECOVER) == ref
