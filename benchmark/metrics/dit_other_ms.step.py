"""dit_other_ms.step: device ms per step in kernels that are neither K1
nor cuBLAS GEMMs: elementwise work, norms, copies (and the solver's few
multiply-adds)."""

from benchmark.readers import group_ms_per_unit


def compute(rec):
    return group_ms_per_unit(rec, "cfg_step", "other")
