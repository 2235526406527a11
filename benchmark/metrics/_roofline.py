"""A kernel's share of its roofline over the profiled slice: the sum of
the least time of each launch (`yardstick.kernel_bound_s` at the
launch's logical shapes) over the kernel's device time in the trace.
Nothing where the kernel did not run, or where the profiler holds another
number of its launches than were recorded."""

import sys

from benchmark.yardstick import kernel_bound_s


def share(trace, kind):
    p = trace['slice']
    launches = [x for x in p['launches'] if x.kind == kind]
    n_traced = p['kernel_n'].get(kind, 0)
    if not launches or not n_traced:
        return None
    if len(launches) != n_traced:
        print(f'{kind}: {len(launches)} launches recorded, {n_traced} in '
              'the trace: no roofline', file=sys.stderr)
        return None
    return 100.0 * sum(kernel_bound_s(x)[0] for x in launches) / \
        p['kernel_s'][kind]
