"""k2_roofline.train: % of K2's bound (the attention backward,
flash_bwd) over its device time."""

from benchmark.readers import roofline


def compute(rec):
    return roofline(rec, "train_step", "K2")
