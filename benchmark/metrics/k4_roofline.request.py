"""k4_roofline.request: % of K4's bound (the VAE upsample conv) over
its device time."""

from benchmark.readers import roofline


def compute(rec):
    return roofline(rec, "request", "K4")
