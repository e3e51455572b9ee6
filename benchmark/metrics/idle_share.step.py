"""idle_share.step: % of the traced window with nothing on the card
(the union of every kernel's, copy's and set's interval)."""

from benchmark.readers import idle_share


def compute(rec):
    return idle_share(rec, "cfg_step")
