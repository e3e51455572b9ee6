"""k3_roofline.request: % of K3's bound (the VAE resblock conv, its
pre-pass included) over its device time."""

from benchmark.readers import roofline


def compute(rec):
    return roofline(rec, "request", "K3")
