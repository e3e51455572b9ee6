"""setup_s: seconds from the process's start to the window's start:
imports, weights drawn on the card, warm-up (and, in a first run, the
kernels' build)."""


def compute(rec):
    return rec["setup_s"]
