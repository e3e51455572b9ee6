"""mfu.step: % of the bf16 peak (989 TFLOP/s): the model FLOPs of the
units completed (benchmark/flops.py) over the traced window."""

from benchmark.readers import mfu


def compute(rec):
    return mfu(rec, "cfg_step")
