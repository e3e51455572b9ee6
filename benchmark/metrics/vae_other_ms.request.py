"""vae_other_ms.request: device ms per request inside the `vae_decode`
span in kernels that are neither K3 (with its pre-pass) nor K4: the
norms, activations, caches' copies and cuDNN's remaining convolutions
(program spans)."""

from benchmark.spans import device_ms_per_unit


def compute(rec):
    return device_ms_per_unit(rec, "request", ("vae_decode",),
                              skip=("K3", "K4"))
