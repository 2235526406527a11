"""Host milliseconds a task of the Levenberg-Marquardt loop (the
program's span 'predict.lm', around `models/sindy.py::
_levenberg_marquardt`): the time the host spends issuing the loop. Near
`lm_device_ms` the loop is bound by its launches; far under it, by the
device."""

from benchmark.metrics._program import span_ms


def read(trace):
    return span_ms(trace, 'predict.lm', 'host_s')
