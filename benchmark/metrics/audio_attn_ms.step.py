"""audio_attn_ms.step: device ms per step inside the DiT's `audio_attn`
spans, every kernel: the audio adapters' q / k / v / o GEMMs, their q /
k RMSNorms, K1 at the audio tokens' length and the casts (program spans;
the adapter's two residual sites run in block_norm under `block`)."""

from benchmark.spans import device_ms_per_unit


def compute(rec):
    return device_ms_per_unit(rec, "cfg_step", ("audio_attn",))
