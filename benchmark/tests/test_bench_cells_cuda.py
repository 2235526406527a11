"""On the card: each cell through the harness at a reduced size, judged
against the plain reference, and its bfloat16 control judged not correct
(`python3 -m pytest benchmark/tests -m cuda` on a machine with a card;
skipped elsewhere)."""

import pytest
import torch

from benchmark import cell as cells
from benchmark import run
from benchmark.tests.conftest import ROOT, cells as cell_names

SMALL = {'fused_northstar': 2000,
         'main_run': {'train': 200, 'val': 20, 'test': 20},
         'column': {'train': 200, 'test': 20, 'seeds': 2}}


@pytest.mark.cuda
@pytest.mark.parametrize('workload', cell_names())
def test_cell_on_the_card(workload, cuda_device):
    c = cells.load(ROOT, workload)
    s = run.CellRun(c, 2**31 + 11, cuda_device,
                    patients=SMALL[c.traffic['entry']])
    s.setup()
    s.window(1.0, trace=False)
    readings = s.judge()
    assert s.correct(readings), readings
    out = s.entry.control(run.task_seed(3, 0), torch.bfloat16)
    control = s.entry.judge(out)
    assert not all(control[k] <= v for k, v in c.limits.items()), control
