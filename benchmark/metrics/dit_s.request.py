"""dit_s.request: the generator's own stage seconds
(`timings["dit_s"]`, host clock, ended by a synchronise), mean per
request."""

from benchmark.readers import stage_mean


def compute(rec):
    return stage_mean(rec, "request", "dit_s")
