"""`rollout_kernel`'s share of its roofline (`_roofline.share`)."""

from benchmark.metrics._roofline import share


def read(trace):
    return share(trace, 'rollout')
