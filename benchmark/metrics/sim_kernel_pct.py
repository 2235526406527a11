"""The share, in %, of the tumour simulator's day-loop cores that ran as
one kernel launch (the program's counters 'sim.kernel_cores' over
'sim.cores', kept by `sim/tumor.py::factual_core` and `cf_factual_core`):
100 where every core of the slice ran on the card's kernel, 0 where each
took the Python loop over days. Nothing where no core ran, or where the
program has no such counter."""

from benchmark.metrics._program import counter


def read(trace):
    cores = counter(trace, 'sim.cores')
    if not cores:
        return None
    return 100.0 * (counter(trace, 'sim.kernel_cores') or 0.0) / cores
