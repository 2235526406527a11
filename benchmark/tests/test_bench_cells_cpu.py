"""Each cell driven through the harness at a tiny size on the CPU, where
the port runs its kernels' plain versions: set-up, the closed loop and the
judgement against the plain reference (a control-flow check, which also
shows reference and port agreeing on tiny cohorts); the bfloat16 control
and each fault a cell can have read as not correct; and the measuring
command refuses to report without a card."""

import contextlib
import io

import pytest
import torch

from benchmark import cell as cells
from benchmark import run
from benchmark.tests.conftest import ROOT, cells as cell_names

TINY = {'fused_northstar': 48,
        'main_run': {'train': 40, 'val': 4, 'test': 4},
        'column': {'train': 20, 'test': 3, 'seeds': 2}}
CPU = torch.device('cpu')


def tiny_run(workload, seed=123_456_789_012):
    c = cells.load(ROOT, workload)
    return run.CellRun(c, seed, CPU, patients=TINY[c.traffic['entry']])


@pytest.mark.parametrize('workload', cell_names())
def test_cell_runs_and_agrees_with_the_reference(workload):
    s = tiny_run(workload)
    s.setup()
    s.window(0.0, trace=False)
    assert s.attempted == 1 and s.failed == 0
    readings = s.judge()
    assert set(readings) == set(s.cell.limits)
    assert s.correct(readings), readings


@pytest.mark.parametrize('workload', cell_names())
def test_bfloat16_control_is_not_correct(workload):
    s = tiny_run(workload)
    for k in range(3):
        out = s.entry.control(run.task_seed(7, k), torch.bfloat16)
        readings = s.entry.judge(out)
        assert not all(readings[k] <= v for k, v in s.cell.limits.items()), \
            readings


def _state_unchanged(monkeypatch):
    from insite_tpu_torch.models import sindy
    monkeypatch.setattr(sindy, '_levenberg_marquardt',
                        lambda pb, *a, **k: pb.g_red.expand(pb.B, pb.Kr))


def _half_batch(monkeypatch):
    from insite_tpu_torch.harness import northstar
    rmse = northstar._factual_rmse

    def half(preds, vol, lengths):
        n = preds.shape[0] // 2
        return rmse(preds[:n], vol[:n], lengths[:n])
    monkeypatch.setattr(northstar, '_factual_rmse', half)


def _answer_altered(monkeypatch):
    from insite_tpu_torch.harness import northstar
    fine_tune = northstar.insite_gn_finetune_predict

    def altered(*args, **kwargs):
        preds, coefs = fine_tune(*args, **kwargs)
        preds = preds.clone()
        preds[0, 3] += 0.5
        return preds, coefs
    monkeypatch.setattr(northstar, 'insite_gn_finetune_predict', altered)


def _half_batch_main(monkeypatch):
    from insite_tpu_torch.models import base
    rmse = base.normalised_masked_rmse

    class Half:
        def __init__(self, ds):
            n = len(ds.data['active_entries']) // 2
            self.data = {k: v[:n] if hasattr(v, 'shape') and
                         v.shape[:1] == (2 * n,) else v
                         for k, v in ds.data.items()}
            self.scaling_params, self.norm_const = (ds.scaling_params,
                                                    ds.norm_const)

    def half(ds, outputs, **kw):
        return rmse(Half(ds), outputs[:len(outputs) // 2], **kw)
    monkeypatch.setattr(base, 'normalised_masked_rmse', half)


def _answer_altered_main(monkeypatch):
    from insite_tpu_torch.models.sindy import SINDyRegressor
    predict = SINDyRegressor.get_predictions

    def altered(self, ds):
        preds = predict(self, ds).copy()
        preds[0, 0, 0] += 0.5
        return preds
    monkeypatch.setattr(SINDyRegressor, 'get_predictions', altered)


def _half_batch_column(monkeypatch):
    from insite_tpu_torch.harness import vectorized
    rmses = vectorized._one_step_rmses

    def half(preds, rows, lengths, valid, S, norm_c):
        valid = valid.clone().reshape(S, -1)
        valid[:, valid.shape[1] // 2:] = 0
        return rmses(preds, rows, lengths, valid.reshape(-1), S, norm_c)
    monkeypatch.setattr(vectorized, '_one_step_rmses', half)


def _answer_altered_column(monkeypatch):
    from insite_tpu_torch.harness import vectorized
    predict = vectorized._predict

    def altered(*args, **kwargs):
        # 50 cm^3 on one 1-step prediction: 4 % of the death volume that
        # normalises the tumour family's errors
        preds = predict(*args, **kwargs).clone()
        preds[0, 0] += 50.0
        return preds
    monkeypatch.setattr(vectorized, '_predict', altered)


FAULTS = {'fused_northstar': [_state_unchanged, _half_batch,
                              _answer_altered],
          'main_run': [_state_unchanged, _half_batch_main,
                       _answer_altered_main],
          'column': [_state_unchanged, _half_batch_column,
                     _answer_altered_column]}


@pytest.mark.parametrize('workload, fault', [
    (w, f) for w in cell_names()
    for f in FAULTS[cells.load(ROOT, w).traffic['entry']]],
    ids=lambda x: getattr(x, '__name__', x))
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    fault(monkeypatch)
    s = tiny_run(workload)
    s.window(0.0, trace=False)
    assert not s.correct(s.judge())


def test_the_command_refuses_without_a_card(at_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(['--workload', cell_names()[0], '--seed', '1',
                       '--seconds', '1', '--trace', '0'])
    assert rc != 0 and out.getvalue() == ''
    assert 'CUDA' in err.getvalue()


def test_task_seeds_are_distinct_and_32_bit():
    seeds = {run.task_seed(2**31 + 5, i) for i in range(1000)}
    warm = {run.task_seed(2**31 + 5, run.WARM_INDEX + k) for k in range(4)}
    assert len(seeds) == 1000 and not seeds & warm
    assert all(0 <= s < 2**32 for s in seeds)
    assert run.task_seed(-3, 0) == run.task_seed(2**64 - 3, 0)


def test_sample_is_uniform_and_seeded():
    counts = [0] * 10
    for seed in range(2000):
        s = run.Sample(2, seed)
        for i in range(10):
            s.offer(i)
        for i in s.kept:
            counts[i] += 1
    assert min(counts) > 300 and max(counts) < 500
    a, b = run.Sample(2, 9), run.Sample(2, 9)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.kept == b.kept
