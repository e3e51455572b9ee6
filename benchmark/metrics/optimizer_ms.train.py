"""optimizer_ms.train: device ms per training step of the kernels inside
the `optimizer` span: AdamW and the EMA (program spans; the host time
around them is `optimizer_s.train`)."""

from benchmark.spans import device_ms_per_unit


def compute(rec):
    return device_ms_per_unit(rec, "train_step", ("optimizer",))
