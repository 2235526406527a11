"""Device milliseconds a task of the Levenberg-Marquardt loop (the
program's span 'predict.lm'): from a CUDA event before the loop's first
operation on the stream to one after its last."""

from benchmark.metrics._program import span_ms


def read(trace):
    return span_ms(trace, 'predict.lm', 'device_s')
