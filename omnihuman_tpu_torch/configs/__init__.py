"""Named model registry (port of omnihuman_tpu/configs/__init__.py)."""

from omnihuman_tpu_torch.configs.wan import (
    I2V_14B,
    T2I_14B,
    T2V_14B,
    T2V_1_3B,
    T2V_1_3B_SMALL,
    TINY_TEST,
    TINY_TEST_HD128,
    CLIPConfig,
    DTypePolicy,
    T5Config,
    VAEConfig,
    WanConfig,
    WanModelConfig,
)

WAN_CONFIGS = {
    "t2v-14B": T2V_14B,
    "tiny-test": TINY_TEST,
    "t2v-1.3B": T2V_1_3B,
    "t2v-1.3B-small": T2V_1_3B_SMALL,
    "i2v-14B": I2V_14B,
    "t2i-14B": T2I_14B,
}

SIZE_CONFIGS = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
    "1024*1024": (1024, 1024),
}

MAX_AREA_CONFIGS = {
    "720*1280": 720 * 1280,
    "1280*720": 1280 * 720,
    "480*832": 480 * 832,
    "832*480": 832 * 480,
}

SUPPORTED_SIZES = {
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "tiny-test": tuple(SIZE_CONFIGS.keys()),
    "t2v-1.3B": ("480*832", "832*480"),
    "t2v-1.3B-small": ("480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2i-14B": tuple(SIZE_CONFIGS.keys()),
}

__all__ = [
    "WAN_CONFIGS", "SIZE_CONFIGS", "MAX_AREA_CONFIGS", "SUPPORTED_SIZES",
    "WanConfig", "WanModelConfig", "VAEConfig", "T5Config", "CLIPConfig",
    "DTypePolicy", "TINY_TEST", "TINY_TEST_HD128",
]
