"""train_step_s: seconds per training step, the whole window over every
step completed in it."""

from benchmark.readers import per_unit


def compute(rec):
    return per_unit(rec, "train_step")
