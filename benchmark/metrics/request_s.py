"""request_s: seconds per one-step request, the whole window over every
request completed in it, back to back."""

from benchmark.readers import per_unit


def compute(rec):
    return per_unit(rec, "request")
