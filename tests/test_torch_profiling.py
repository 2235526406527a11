"""The port's tracing and timing tools (`utils/profiling.py`) on the CPU:
`time_blocked` times warm calls and returns the last result, `trace`
writes a Chrome trace that names the block's operators, and
`wall_clock_logger` logs its stage as the JAX package's does."""

import json
import logging

import pytest
import torch

from insite_tpu.utils import profiling as jax_profiling
from insite_tpu_torch.utils import profiling


def test_time_blocked_counts_calls_and_returns_the_last_result():
    calls = []

    def fn(x, scale=1.0):
        calls.append(x)
        return {'y': (torch.full((3,), float(len(calls))) * scale,)}

    secs, result = profiling.time_blocked(fn, 7, reps=3, warmup=2,
                                          scale=2.0)
    assert calls == [7] * 5
    assert torch.equal(result['y'][0], torch.full((3,), 10.0))
    assert secs >= 0.0
    secs, result = profiling.time_blocked(lambda: 1, reps=0, warmup=0)
    assert result is None and secs < 1.0


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(tmp_path / 'tb') as prof:
        (a @ a).sum()
    path = tmp_path / 'tb' / profiling.TRACE_FILE
    events = json.loads(path.read_text())['traceEvents']
    names = {e.get('name') for e in events}
    assert 'aten::mm' in names and 'aten::sum' in names
    assert any(e.key == 'aten::mm' for e in prof.key_averages())


@pytest.mark.parametrize('module', [profiling, jax_profiling],
                         ids=['port', 'jax'])
def test_wall_clock_logger_logs_the_stage(module, caplog):
    log = logging.getLogger('test_torch_profiling')
    with caplog.at_level(logging.INFO, logger=log.name):
        with module.wall_clock_logger('fit', log=log):
            sum(range(1000))
    assert len(caplog.records) == 1
    msg = caplog.records[0].getMessage()
    assert msg.startswith('[fit] ') and msg.endswith('s')
    float(msg[len('[fit] '):-1])
