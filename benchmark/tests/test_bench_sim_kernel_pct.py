"""The reader of `sim_kernel_pct` (`metrics/sim_kernel_pct.py`): the
program's counters 'sim.kernel_cores' over 'sim.cores', in %; nothing
where no core ran, where the slice held no task, or where the program has
no such counter; declared for the two cells whose collection runs the
tumour simulator."""

import json

import pytest

from benchmark import cell as cells
from benchmark.metrics import _program
from benchmark.tests.conftest import ROOT


def trace(tasks):
    return {'tasks': tasks + 3, 'layer_s': {}, 'slice': {'tasks': tasks}}


def read(t):
    return cells.metric_reader('sim_kernel_pct')(t)


@pytest.fixture
def tracer_totals(monkeypatch):
    def use(totals):
        monkeypatch.setattr(_program, 'totals', lambda: totals)
    return use


@pytest.mark.parametrize('totals,want', [
    ({'sim.cores': 8, 'sim.kernel_cores': 8}, 100.0),
    ({'sim.cores': 8}, 0.0),
    ({'sim.cores': 8, 'sim.kernel_cores': 2}, 25.0),
])
def test_the_share_of_cores_the_kernel_ran(totals, want, tracer_totals):
    tracer_totals(totals)
    assert read(trace(4)) == pytest.approx(want)


def test_nothing_where_no_core_ran(tracer_totals):
    tracer_totals({})
    assert read(trace(4)) is None
    tracer_totals({'lm.chains': 13})
    assert read(trace(4)) is None
    tracer_totals({'sim.cores': 8, 'sim.kernel_cores': 8})
    assert read(trace(0)) is None


def test_declared_for_the_cells_that_simulate_tumours():
    with open(ROOT / 'BENCHMARK.json') as f:
        per_layer = {m['name']: m for m in json.load(f)['per_layer']}
    m = per_layer['sim_kernel_pct']
    assert set(m['workloads']) == {'cancer_sim_insite.main_run',
                                   'cancer_sim_insite.column_10seed'}
    assert (m['layer'], m['moves'], m['source']) == (
        'collection', 'patients_per_s', 'program_counter')
