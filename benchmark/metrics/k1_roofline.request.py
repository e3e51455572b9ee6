"""k1_roofline.request: % of K1's bound (the attention forward, flash_fwd
kernels) over its device time: the bound of every call from its shapes
and valid keys."""

from benchmark.readers import roofline


def compute(rec):
    return roofline(rec, "request", "K1")
