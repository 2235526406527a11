"""The share of the profiled slice in which no operation ran on the
device: 1 - (union of the device's operation intervals) / (the slice's
length), from the profiler's trace."""


def read(trace):
    p = trace['slice']
    if not p['window_s']:
        return None
    return 100.0 * (1.0 - p['busy_s'] / p['window_s'])
