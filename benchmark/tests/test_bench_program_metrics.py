"""The six readers of the program's own tracer (`metrics/_program.py`):
each divides a total of `insite_tpu_torch.utils.profiling.totals()` by the
profiled slice's tasks, and gives nothing where the span or counter did
not run, where the slice held no task, or where the program has no
tracer; on the card, a short traced run of the north star prints all
six."""

import json
import subprocess
import sys

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import cell as cells
from benchmark.metrics import _program
from benchmark.tests.conftest import ROOT

SIX = ('qr_device_ms', 'stlsq_host_ms', 'lm_host_ms', 'lm_device_ms',
       'd2h_reads', 'copy_mib')
TOTALS = {
    'fit.qr': {'calls': 8, 'host_s': 0.004, 'self_s': 0.004,
               'device_s': 0.024},
    'fit.stlsq': {'calls': 8, 'host_s': 0.002, 'self_s': 0.002,
                  'device_s': None},
    'predict.lm': {'calls': 4, 'host_s': 0.08, 'self_s': 0.08,
                   'device_s': 0.082},
    'd2h.reads': 24, 'd2h.bytes': 3 * 2**20, 'h2d.bytes': 2**20,
}


def trace(tasks):
    return {'tasks': tasks + 3, 'layer_s': {}, 'slice': {'tasks': tasks}}


def read(name, t):
    return cells.metric_reader(name)(t)


@pytest.fixture
def tracer_totals(monkeypatch):
    def use(totals):
        monkeypatch.setattr(_program, 'totals', lambda: totals)
    return use


def test_each_reader_is_its_total_a_task(tracer_totals):
    tracer_totals(TOTALS)
    t = trace(4)
    assert read('qr_device_ms', t) == pytest.approx(6.0)
    assert read('stlsq_host_ms', t) == pytest.approx(0.5)
    assert read('lm_host_ms', t) == pytest.approx(20.0)
    assert read('lm_device_ms', t) == pytest.approx(20.5)
    assert read('d2h_reads', t) == pytest.approx(6.0)
    assert read('copy_mib', t) == pytest.approx(1.0)


@pytest.mark.parametrize('name', SIX)
def test_nothing_where_the_span_or_counter_did_not_run(name, tracer_totals):
    tracer_totals({})
    assert read(name, trace(4)) is None
    tracer_totals(TOTALS)
    assert read(name, trace(0)) is None


def test_nothing_of_a_span_with_no_device_time(tracer_totals):
    totals = dict(TOTALS)
    totals['fit.qr'] = dict(TOTALS['fit.qr'], device_s=None)
    totals['predict.lm'] = dict(TOTALS['predict.lm'], device_s=None)
    tracer_totals(totals)
    assert read('qr_device_ms', trace(2)) is None
    assert read('lm_device_ms', trace(2)) is None
    assert read('lm_host_ms', trace(2)) == pytest.approx(40.0)


def test_copy_mib_takes_whichever_direction_counted(tracer_totals):
    tracer_totals({'h2d.bytes': 2**21})
    assert read('copy_mib', trace(2)) == pytest.approx(1.0)
    assert read('d2h_reads', trace(2)) is None


def test_a_program_without_a_tracer_gives_nothing(monkeypatch):
    from insite_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, 'totals')
    assert _program.totals() == {}
    for name in SIX:
        assert read(name, trace(3)) is None


def test_the_readers_read_the_programs_tracer():
    from insite_tpu_torch.utils import profiling
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                with profiling.span('fit.stlsq'):
                    pass
                with profiling.span('predict.lm', device='cpu'):
                    pass
        t = trace(2)
        want = 1e3 * profiling.totals()['fit.stlsq']['host_s'] / 2
        assert read('stlsq_host_ms', t) == pytest.approx(want)
        assert read('lm_host_ms', t) > 0.0
        # on the host: no device time, no crossing
        assert read('lm_device_ms', t) is None
        assert read('d2h_reads', t) is None
    finally:
        profiling.reset()


def test_the_six_are_declared_for_the_cells_that_run_them():
    with open(ROOT / 'BENCHMARK.json') as f:
        per_layer = {m['name']: m for m in json.load(f)['per_layer']}
    fit_cells = {'eq4d_insite.fused_10k', 'eq4d_insite.main_run',
                 'cancer_sim_insite.main_run'}
    for name in ('qr_device_ms', 'stlsq_host_ms'):
        assert set(per_layer[name]['workloads']) == fit_cells
    for name in ('lm_host_ms', 'lm_device_ms', 'd2h_reads', 'copy_mib'):
        assert 'workloads' not in per_layer[name]
    assert all(per_layer[n]['moves'] == 'patients_per_s' for n in SIX)


@pytest.mark.cuda
def test_a_short_traced_north_star_prints_all_six(cuda_device):
    out = subprocess.run(
        [sys.executable, '-m', 'benchmark.run', '--workload',
         'eq4d_insite.fused_10k', '--seed', str(2**33 + 5), '--seconds',
         '5', '--trace', '1'], cwd=ROOT, capture_output=True, text=True,
        timeout=600, check=True).stdout
    line = json.loads(out.strip().splitlines()[-1])
    assert set(SIX) <= set(line['metrics']), line['metrics']
    assert all(line['metrics'][n]['value'] >= 0 for n in SIX)
