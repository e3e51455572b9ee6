"""text_encode_s.request: the generator's own stage seconds
(`timings["text_encode_s"]`, host clock, ended by a synchronise), mean per
request."""

from benchmark.readers import stage_mean


def compute(rec):
    return stage_mean(rec, "request", "text_encode_s")
