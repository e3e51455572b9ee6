"""pose_guider_ms.step: device ms per step inside the `pose_guider` span
of the conditional forward: the pose guider's three fp32 convolutions
with their ReLUs and padding, and `pose_proj` (program spans)."""

from benchmark.spans import device_ms_per_unit


def compute(rec):
    return device_ms_per_unit(rec, "cfg_step", ("pose_guider",))
