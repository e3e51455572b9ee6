"""What the drivers share: the port's configuration checked against the
cell's file, the request's draws from the seed, and the DiT made from
the seed."""

from __future__ import annotations

import dataclasses

import torch

from benchmark import weights


def port_config(config: dict):
    """The port's registry entry named by the configuration file, after
    checking that its sizes are the file's (a later change to the
    registry shows here, not as a silently different cell)."""
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    cfg = WAN_CONFIGS[config["registry"]]
    for part in ("model", "t5", "vae"):
        if part not in config:
            continue
        have = dataclasses.asdict(getattr(cfg, part))
        for k, want in config[part].items():
            got = have[k]
            got = list(got) if isinstance(got, tuple) else got
            if got != want:
                raise ValueError(f"{config['registry']}.{part}.{k} is {got} "
                                 f"in the port, {want} in the cell's file")
    return cfg


def salted(seed: int, salt: int) -> int:
    """A second seed from the run's seed, for another independent draw."""
    return (int(seed) * 1_000_003 + salt) % (2 ** 63)


def device_gen(seed: int, device, salt: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(salted(seed, salt))


def text_context(rng, gen, lo: int, hi: int, length: int, dim: int,
                 device):
    """A context of umT5's output shape [length, dim] for a prompt of
    rng-drawn lo..hi tokens: normal rows, zeros past the prompt (umT5
    masks its output). Returns (context fp32, tokens)."""
    n = int(rng.integers(lo, hi + 1))
    ctx = torch.zeros((length, dim), dtype=torch.float32, device=device)
    ctx[:n] = torch.randn((n, dim), generator=gen, device=device)
    return ctx, n


def make_dit(m: dict, cfg_model, seed: int, device, dtype=torch.bfloat16,
             trainable: bool = False):
    """(the port's WanModel with seeded weights, the weights by reference
    name): built on the meta device, its parameters the weights' views."""
    from omnihuman_tpu_torch.models.wan_dit import WanModel
    with torch.device("meta"):
        model = WanModel(cfg_model)
    sd = weights.make_weights(weights.shapes_of(model), seed, device, dtype)
    weights.adaln_outliers(sd, salted(seed, 5))
    model = weights.load_into(model, sd)
    if trainable:
        return model.train().requires_grad_(True), sd
    return model.eval().requires_grad_(False), sd
