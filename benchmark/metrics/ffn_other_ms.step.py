"""ffn_other_ms.step: device ms per step inside the DiT's `ffn` spans in
kernels that are not cuBLAS GEMMs: the GELU and casts (program spans)."""

from benchmark.spans import device_ms_per_unit


def compute(rec):
    return device_ms_per_unit(rec, "cfg_step", ("ffn",), skip=("GEMM",))
