"""The frozen kernel bound reproduces the bounds of the port's kernel
table (the north-star, EQ_4 n-step and cancer_sim shapes, float32, a
model a row where the fine-tune has one), and the per-layer readers turn
a trace into the numbers they name."""

import numpy as np
import pytest

from benchmark import cell as cells
from benchmark.yardstick import (Launch, finetune_work, gaps, kernel_bound_s,
                                 union_length)

EQ4 = (0, 1, 0, 0, 1, 1, 0)           # y's exponent in [1, y, c0, c1, ...]
TUMOR = (0, 1, 0, 1)                  # [1, y, u, y u]


@pytest.mark.parametrize('launch, table_us', [
    (Launch('rollout', 10_000, 59, 2, 7, 2, 10_000, EQ4), 1.61),
    (Launch('sens', 10_000, 59, 2, 7, 2, 10_000, EQ4, (1, 4, 8)), 3.73),
    (Launch('rollout', 59_000, 64, 2, 7, 2, 59_000, EQ4), 10.21),
    (Launch('sens', 59_000, 64, 2, 7, 2, 59_000, EQ4, (1, 4, 8, 12)), 28.25),
    (Launch('rollout', 23_000, 59, 4, 4, 1, 1, TUMOR), 3.30),
    (Launch('sens', 23_000, 59, 4, 4, 1, 1, TUMOR, tuple(range(16))), 29.22),
    (Launch('sens', 55_327, 64, 4, 4, 1, 55_327, TUMOR, tuple(range(16))),
     77.29),
    (Launch('rollout', 590_000, 64, 2, 7, 2, 590_000, EQ4), 102.1),
])
def test_kernel_bound_matches_the_kernel_table(launch, table_us):
    seconds, by = kernel_bound_s(launch)
    assert by == 'bytes'
    # the table prints three or four significant digits
    assert seconds * 1e6 == pytest.approx(table_us, rel=5e-3)


def test_operations_bound_a_long_recurrence():
    # a quartic in y and fifty sub-steps a step: the operations outweigh
    # the 8 bytes a step moves
    seconds, by = kernel_bound_s(Launch('rollout', 1, 10_000, 1, 5, 0, 1,
                                        (0, 1, 2, 3, 4), substeps=50))
    assert by == 'operations' and seconds > 0


def test_union_and_gaps():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    assert union_length(iv) == 4.0
    assert gaps(iv, -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]


def trace(**slice_overrides):
    launch = Launch('rollout', 10_000, 59, 2, 7, 2, 10_000, EQ4)
    p = {'window_s': 2.0, 'busy_s': 0.5, 'wall_s': 2.0,
         'kernel_s': {'rollout': 2 * 8.5e-6}, 'kernel_n': {'rollout': 2},
         'launches': [launch, launch], 'work': [launch] * 4}
    p.update(slice_overrides)
    return {'tasks': 4, 'layer_s': {'fit': 0.2, 'predict': 0.4},
            'slice': p}


def test_readers():
    t = trace()
    assert cells.metric_reader('fit_ms')(t) == pytest.approx(50.0)
    assert cells.metric_reader('predict_ms')(t) == pytest.approx(100.0)
    assert cells.metric_reader('collection_ms')(t) is None
    assert cells.metric_reader('device_idle_pct')(t) == pytest.approx(75.0)
    share = cells.metric_reader('rollout_roofline_pct')(t)
    assert share == pytest.approx(100 * 1.612e-6 / 8.5e-6, rel=1e-3)
    assert cells.metric_reader('sens_roofline_pct')(t) is None
    mfu = cells.metric_reader('task_mfu')(t)
    assert mfu == pytest.approx(100 * 4 * 1.612e-6 / 2.0, rel=1e-3)


def test_roofline_silent_when_launches_and_trace_disagree():
    t = trace(kernel_n={'rollout': 3})
    assert cells.metric_reader('rollout_roofline_pct')(t) is None


def test_finetune_work_counts_the_north_stars_passes():
    from benchmark.reference import eq4
    cfg = {'library': {'n_inputs': 3}, 'dtype': 'float32', 'gn_iters': 12}
    coefs = np.zeros((2, 7))
    coefs[0, 1], coefs[0, 4], coefs[1, 1] = -1.05, -0.14, -1.02
    work = finetune_work(cfg, eq4, coefs, [(10_000, 59)])
    assert [x.kind for x in work] == ['sens'] * 13 + ['rollout']
    assert work[0].active == (1, 4, 8)
    total = sum(kernel_bound_s(x)[0] for x in work)
    assert total * 1e6 == pytest.approx(13 * 3.73 + 1.61, rel=5e-3)
    assert [x.kind for x in finetune_work(cfg, eq4, np.zeros((2, 7)),
                                          [(10, 59)])] == ['rollout']
