"""step_s: seconds per denoise step, the whole window over every step
completed in it."""

from benchmark.readers import per_unit


def compute(rec):
    return per_unit(rec, "cfg_step")
