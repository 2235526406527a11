"""The share, in %, of the Levenberg-Marquardt chain's links that ran from
a CUDA graph captured in an earlier call (the program's counters
'lm.graph_hits' over 'lm.chains', kept by `models/sindy.py::
_levenberg_marquardt`): 100 where every fine-tune of the slice replays its
chain, 0 where none does. Nothing where no chain ran, or where the program
has no such counter."""

from benchmark.metrics._program import counter


def read(trace):
    chains = counter(trace, 'lm.chains')
    if not chains:
        return None
    return 100.0 * (counter(trace, 'lm.graph_hits') or 0.0) / chains
