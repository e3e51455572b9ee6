"""attn_other_ms.step: device ms per step inside the DiT's `self_attn` and
`cross_attn` spans in kernels that are neither K1 nor cuBLAS GEMMs: the
q / k RMSNorms, RoPE, casts and layout copies (program spans)."""

from benchmark.spans import device_ms_per_unit


def compute(rec):
    return device_ms_per_unit(rec, "cfg_step", ("self_attn", "cross_attn"),
                              skip=("K1", "GEMM"))
