"""host_wait_ms.train: device-idle ms per training step that lie inside
one of the program's spans on the host: the card waiting on host work
the step does (program spans; `idle_share.train` counts all idle)."""

from benchmark.spans import idle_ms_per_unit


def compute(rec):
    return idle_ms_per_unit(rec, "train_step")
