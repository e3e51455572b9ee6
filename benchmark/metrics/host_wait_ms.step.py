"""host_wait_ms.step: device-idle ms per denoise step that lie inside one
of the program's spans on the host: the card waiting on host work the
step does, such as the RoPE tables built in `pack` (program spans;
`idle_share.step` counts all idle)."""

from benchmark.spans import idle_ms_per_unit


def compute(rec):
    return idle_ms_per_unit(rec, "cfg_step")
