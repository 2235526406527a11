"""MiB a task copied between host and device through the program's
crossing helpers, both ways (its counters 'd2h.bytes' and 'h2d.bytes',
kept by `utils/profiling.py::to_host` and `to_device`)."""

from benchmark.metrics._program import counter


def read(trace):
    value = counter(trace, 'd2h.bytes', 'h2d.bytes')
    return None if value is None else value / 2**20
