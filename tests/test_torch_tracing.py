"""The port's tracer (`utils/profiling.py`) on the CPU: spans nest, keep
their parent and their self time; nothing is recorded unless a profiler
records; under `profiling.trace` the spans are on the Chrome trace and in
`totals`, which `trace` clears on entry; the crossing helpers return what
``.cpu()`` and ``torch.as_tensor`` return and count only while recording;
and the north star's stage times are its spans' durations."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from insite_tpu_torch.harness.northstar import fused_northstar
from insite_tpu_torch.utils import profiling

N_TINY = 48


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.reset()
    yield
    profiling.reset()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


class OnDevice:
    """A host tensor that reports a device other than the host: what
    `to_host` counts, on a machine without a card."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device('meta')

    def nelement(self):
        return self.t.nelement()

    def element_size(self):
        return self.t.element_size()

    def cpu(self):
        return self.t


def test_spans_nest_and_record_their_parent():
    with profiling.span('outer') as outer:
        with profiling.span('inner') as inner:
            with profiling.span('leaf') as leaf:
                pass
        with profiling.span('sibling') as sibling:
            pass
    assert outer.parent is None
    assert inner.parent is outer and sibling.parent is outer
    assert leaf.parent is inner
    assert outer.start <= inner.start <= leaf.start <= leaf.end <= \
        inner.end <= sibling.start <= sibling.end <= outer.end
    assert outer.seconds >= inner.seconds + sibling.seconds


def test_self_time_is_duration_less_children():
    with recording():
        with profiling.span('outer') as outer:
            time.sleep(0.01)
            with profiling.span('child') as a:
                time.sleep(0.01)
            with profiling.span('child') as b:
                with profiling.span('grandchild'):
                    time.sleep(0.01)
    t = profiling.totals()
    assert t['outer']['calls'] == 1 and t['child']['calls'] == 2
    assert t['outer']['host_s'] == pytest.approx(outer.seconds)
    assert t['child']['host_s'] == pytest.approx(a.seconds + b.seconds)
    assert t['outer']['self_s'] == pytest.approx(
        outer.seconds - a.seconds - b.seconds)
    assert t['child']['self_s'] == pytest.approx(
        t['child']['host_s'] - t['grandchild']['host_s'])
    assert t['outer']['self_s'] >= 0.009


def test_a_span_inside_its_own_name_records_nothing_of_its_own():
    with recording():
        with profiling.span('fit') as outer:
            with profiling.span('fit') as inner:
                with profiling.span('fit.qr') as qr:
                    time.sleep(0.002)
    t = profiling.totals()
    assert inner.parent is outer and qr.parent is inner
    assert t['fit']['calls'] == 1
    assert t['fit']['host_s'] == pytest.approx(outer.seconds)
    assert t['fit']['self_s'] == pytest.approx(outer.seconds - qr.seconds)


def test_the_decorator_form_is_a_span_of_each_call():
    @profiling.span('stage')
    def stage(x, scale=1):
        """Doubles."""
        return 2 * x * scale

    assert stage.__name__ == 'stage' and stage.__doc__ == 'Doubles.'
    assert stage(3) == 6
    assert profiling.totals() == {}
    with recording():
        assert stage(3, scale=2) == 12
        stage(1)
    assert profiling.totals()['stage']['calls'] == 2


def test_nothing_is_recorded_without_a_profiler():
    x = torch.arange(6.0)
    with profiling.span('stage', device='cpu') as s:
        profiling.count('things', 3)
        profiling.to_host(OnDevice(x))
        profiling.to_device(np.ones(4), 'meta')
    assert s.seconds >= 0.0
    assert profiling.totals() == {}


def test_spans_are_on_the_chrome_trace_and_in_totals(tmp_path):
    with profiling.trace(tmp_path / 'tb'):
        with profiling.span('stage.outer'):
            with profiling.span('stage.inner'):
                torch.randn(8, 8).sum()
        profiling.count('things', 2)
        profiling.count('things')
    events = json.loads((tmp_path / 'tb' / profiling.TRACE_FILE)
                        .read_text())['traceEvents']
    names = {e.get('name') for e in events}
    assert {'stage.outer', 'stage.inner'} <= names
    t = profiling.totals()
    assert set(t) == {'stage.outer', 'stage.inner', 'things'}
    assert t['things'] == 3
    assert t['stage.inner']['calls'] == 1


def test_trace_resets_on_entry(tmp_path):
    with recording():
        with profiling.span('before'):
            pass
    assert 'before' in profiling.totals()
    with profiling.trace(tmp_path / 'tb'):
        with profiling.span('during'):
            pass
    assert set(profiling.totals()) == {'during'}


def test_to_host_returns_cpu_and_counts_reads_while_recording():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert torch.equal(profiling.to_host(x), x.cpu())
    assert torch.equal(profiling.to_host(OnDevice(x)), x)
    assert profiling.totals() == {}
    with recording():
        profiling.to_host(x)                 # on the host: no crossing
        profiling.to_host(OnDevice(x))
        profiling.to_host(OnDevice(x[:, :2].double()))
    t = profiling.totals()
    assert t[profiling.D2H_READS] == 2
    assert t[profiling.D2H_BYTES] == 12 * 4 + 6 * 8


def test_to_device_returns_as_tensor_and_counts_bytes_while_recording():
    a = np.arange(5.0)
    for args in ((a, 'cpu'), (a, 'cpu', torch.float32),
                 ([1, 2, 3], 'cpu'), ((0.5, 1.5), 'cpu', torch.float64),
                 (2.5, 'cpu', torch.float32)):
        got = profiling.to_device(*args)
        want = torch.as_tensor(args[0], dtype=(args[2] if len(args) > 2
                                               else None), device=args[1])
        assert got.dtype == want.dtype and torch.equal(got, want)
    on_meta = profiling.to_device(a, 'meta', torch.float32)
    assert on_meta.device.type == 'meta' and on_meta.shape == (5,)
    assert profiling.totals() == {}
    with recording():
        profiling.to_device(a, 'cpu')            # stays on the host
        profiling.to_device(a, 'meta', torch.float32)
        profiling.to_device([1, 2, 3], 'meta')
        profiling.to_device(on_meta, 'meta')     # already there
    t = profiling.totals()
    assert t[profiling.H2D_COPIES] == 2
    assert t[profiling.H2D_BYTES] == 5 * 4 + 3 * 8
    assert profiling.D2H_READS not in t


def test_device_seconds_are_none_on_the_cpu():
    with recording():
        with profiling.span('on.host', device='cpu'):
            pass
        with profiling.span('no.device'):
            pass
    t = profiling.totals()
    assert t['on.host']['device_s'] is None
    assert t['no.device']['device_s'] is None


def test_northstar_stage_times_are_its_spans():
    r = fused_northstar(N_TINY, seed=3, device='cpu')
    for k in ('t_sim_design', 't_stlsq', 't_finetune', 't_metric', 'total'):
        assert r[k] >= 0.0
    # with no profiler running nothing is kept
    assert profiling.totals() == {}

    with recording():
        r = fused_northstar(N_TINY, seed=3, device='cpu')
    t = profiling.totals()
    assert {'collection', 'fit', 'fit.qr', 'fit.stlsq', 'predict',
            'predict.lm', 'metric'} <= set(t)
    # both arms' QR reductions are one call (`_qr_reduce_arms`)
    assert t['fit']['calls'] == 2 and t['fit.qr']['calls'] == 1
    assert r['t_finetune'] == t['predict']['host_s']
    assert r['t_metric'] == t['metric']['host_s']
    assert r['t_sim_design'] + r['t_stlsq'] == pytest.approx(
        t['collection']['host_s'] + t['fit']['host_s'], rel=1e-12)
    assert r['total'] == pytest.approx(
        sum(t[k]['host_s'] for k in ('collection', 'fit', 'predict',
                                     'metric')), rel=1e-12)
    assert all(v['device_s'] is None for v in t.values()
               if isinstance(v, dict))
    # the host holds the cohort: no crossing is counted
    assert profiling.D2H_READS not in t and profiling.H2D_COPIES not in t
