"""The whole task's share of the card's peak, in the roofline sense: the
least time the card needs for the ODE passes the profiled tasks' rows
require (the entry's `work`: rows, steps, features, the fitted support
and the sub-steps, whatever implements them) over the profiled slice's
wall time."""

from benchmark.yardstick import kernel_bound_s


def read(trace):
    p = trace['slice']
    if not p['work'] or not p['wall_s']:
        return None
    return 100.0 * sum(kernel_bound_s(x)[0] for x in p['work']) / p['wall_s']
