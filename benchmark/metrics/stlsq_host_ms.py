"""Host milliseconds a task of the float64 STLSQ thresholding (the
program's span 'fit.stlsq', `discovery/stlsq.py::stlsq_from_qr`)."""

from benchmark.metrics._program import span_ms


def read(trace):
    return span_ms(trace, 'fit.stlsq', 'host_s')
