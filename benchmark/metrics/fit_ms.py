"""Milliseconds a completed task spent in the fit layer's spans, summed
over the traced window; nothing where the cell has no such span."""


def read(trace):
    seconds = trace['layer_s'].get('fit')
    if seconds is None or not trace['tasks']:
        return None
    return 1e3 * seconds / trace['tasks']
