"""Device milliseconds a task of the QR reductions (the program's span
'fit.qr', `discovery/stlsq.py::_qr_reduce`): from a CUDA event before the
reduction's first operation to one after its last."""

from benchmark.metrics._program import span_ms


def read(trace):
    return span_ms(trace, 'fit.qr', 'device_s')
