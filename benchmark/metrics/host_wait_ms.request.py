"""host_wait_ms.request: device-idle ms per request that lie inside one
of the program's spans on the host: the card waiting on host work the
request does (program spans; `idle_share.request` counts all idle)."""

from benchmark.spans import idle_ms_per_unit


def compute(rec):
    return idle_ms_per_unit(rec, "request")
