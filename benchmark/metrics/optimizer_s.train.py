"""optimizer_s.train: host seconds, synchronised on both sides, around
the AdamW update and the EMA of each step (timed by the driver), mean
per step."""

from benchmark.readers import stage_mean


def compute(rec):
    return stage_mean(rec, "train_step", "optimizer_s")
