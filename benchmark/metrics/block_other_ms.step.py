"""block_other_ms.step: device ms per step inside the DiT's `block` spans
but outside their child spans, in kernels that are neither K1 nor cuBLAS
GEMMs: the LayerNorms, AdaLN modulation, gates and residual adds
(program spans)."""

from benchmark.spans import device_ms_per_unit


def compute(rec):
    return device_ms_per_unit(rec, "cfg_step", ("block",),
                              skip=("K1", "GEMM"))
