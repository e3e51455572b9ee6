"""Random weights from the seed, made on the card in the type they are
served in: one draw into one flat buffer, then a scale (and an offset for
norm weights) per leaf. The tensors are views of that buffer; the program
gets them through `load_state_dict(..., assign=True)` under the reference
parameter names, and the reference reads the same tensors."""

from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]


def leaf_init(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of a leaf by its reference name: norm weights and VAE
    gammas near 1, biases small, Wan's AdaLN tables at 1/sqrt(dim),
    token embeddings unit normal, umT5's queries at 1/sqrt(fan_in * 64),
    every other matrix or conv kernel at 1/sqrt(fan_in) so that
    activations keep their scale through depth."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "gamma" or (leaf == "weight" and len(shape) == 1):
        return 1.0, 0.1                      # RMS / layer norm weights
    if leaf == "bias":
        return 0.0, 0.02
    if leaf == "modulation":
        return 0.0, shape[-1] ** -0.5
    if name.endswith("token_embedding.weight"):
        return 0.0, 1.0
    if name.endswith("pos_embedding.embedding.weight"):
        return 0.0, 0.1
    if re.search(r"(^|\.)blocks\.\d+\.attn\.q\.weight$", name):
        # umT5's attention has no 1/sqrt(d) scaling: its queries carry it
        return 0.0, (shape[1] * 64) ** -0.5
    return 0.0, math.prod(shape[1:]) ** -0.5


def make_weights(shapes: Shapes, seed: int, device, dtype: torch.dtype
                 ) -> Dict[str, torch.Tensor]:
    """{name: tensor} views of one normal draw from a generator on
    `device` seeded with `seed`, scaled per leaf by `leaf_init`."""
    sizes = {n: math.prod(s) for n, s in shapes.items()}
    flat = torch.empty(sum(sizes.values()), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    with torch.no_grad():
        flat.normal_(generator=gen)
        out, off = {}, 0
        for n, s in shapes.items():
            t = flat[off:off + sizes[n]].view(s)
            mean, std = leaf_init(n, s)
            t.mul_(std)
            if mean:
                t.add_(mean)
            out[n] = t
            off += sizes[n]
    return out


def adaln_outliers(sd: Dict[str, torch.Tensor], seed: int,
                   share: float = 0.01, scale: float = 64.0) -> None:
    """Give the DiT's AdaLN tables the outlier channels trained DiTs have
    ("massive activations"): in every block, for the same `share` of the
    channels, drawn from the seed, the scale entries that multiply the
    self-attention's and the FFN's normalised inputs (chunks 1 and 4 of
    `modulation`) are drawn with std `scale`. The GEMM inputs then carry a
    few channels far larger than the rest, as in a trained model; a
    quantiser with one step per token loses the small channels there,
    where a floating-point type keeps their relative precision."""
    mods = [t for n, t in sd.items() if n.startswith("blocks.")
            and n.endswith(".modulation")]
    if not mods:
        return
    dim = mods[0].shape[-1]
    gen = torch.Generator(device=mods[0].device).manual_seed(
        seed % (2 ** 63))
    chans = torch.randperm(dim, generator=gen, device=mods[0].device)[
        :max(1, int(share * dim))]
    with torch.no_grad():
        for t in mods:
            for chunk in (1, 4):
                vals = torch.randn((len(chans),), generator=gen,
                                   device=t.device) * scale
                t[0, chunk, chans] = vals.to(t.dtype)


def shapes_of(module: torch.nn.Module) -> Shapes:
    """{name: shape} of a module's parameters (build it on the meta
    device: nothing is allocated)."""
    return {n: tuple(p.shape) for n, p in module.named_parameters()}


def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor]
              ) -> torch.nn.Module:
    """The meta-device module with `sd`'s tensors as its parameters."""
    module.load_state_dict(sd, strict=True, assign=True)
    return module
