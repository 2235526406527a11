"""Device-to-host reads a task (the program's counter 'd2h.reads', kept by
`utils/profiling.py::to_host`): each one waits for the device's stream to
reach it."""

from benchmark.metrics._program import counter


def read(trace):
    return counter(trace, 'd2h.reads')
