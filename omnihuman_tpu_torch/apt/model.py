"""Seaweed-APT model wrappers: one-step generator, discriminator, R1
(port of omnihuman_tpu/apt/model.py).

Reference seaweed_apt/model.py:
  - WanAPTGenerator (":189-221"): x = z - model(z, t=T_final, ctx).
  - WanAPTDiscriminator (":86-186"): a frozen Wan backbone, learnable-query
    cross-attention probes on intermediate blocks, LayerNorm + Linear to
    a scalar logit. The timestep shift (s=1 images, s=12 videos) is
    applied by the caller.
  - approximated_r1_loss (":224-251"): E[(D(x) - D(x + sigma*eps))^2].

The backbone's block outputs come from `WanModel.forward(collect_layers=)`
(the JAX package's taps; the reference reads them with forward hooks).
With `stop_features` the backbone runs under `torch.no_grad`, the
gradient cut of JAX's `stop_gradient` (and no activations are kept).

Tap layers: (15, 25, 35) at 40 layers, the same depth fractions otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
from omnihuman_tpu_torch.models.wan_dit import WanModel, _linear
from omnihuman_tpu_torch.ops.norms import layer_norm

Tensors = Dict[str, torch.Tensor]


def default_tap_layers(num_layers: int) -> Tuple[int, ...]:
    """(15, 25, 35) at 40 layers; proportional otherwise."""
    if num_layers >= 36:
        return (15, 25, 35)
    fr = (15 / 40, 25 / 40, 35 / 40)
    return tuple(min(num_layers - 1, int(round(f * num_layers))) for f in fr)


def timestep_shift(t: torch.Tensor, s: float) -> torch.Tensor:
    """s*t / (1 + (s-1)*t) on normalised t in [0, 1]."""
    return s * t / (1.0 + (s - 1.0) * t)


# ---------------------------------------------------------------------------
# generator


def apt_generator_forward(model: WanModel, z, context, *, seq_len: int,
                          rope_sin, rope_cos, final_timestep: float = 1000.0,
                          policy: DTypePolicy = DTypePolicy(), remat=False
                          ) -> torch.Tensor:
    """One-step generation: x = z - v(z, T_final) (model.py:199-221)."""
    t = torch.full((z.shape[0],), final_timestep, dtype=torch.float32,
                   device=z.device)
    v = model(z, t, context, seq_len=seq_len, rope_sin=rope_sin,
              rope_cos=rope_cos, policy=policy, remat=remat)
    return z - v


# ---------------------------------------------------------------------------
# discriminator


class _Norm(nn.Module):
    """LayerNorm weight and bias, applied by `ops.norms.layer_norm`."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


class Probe(nn.Module):
    """Learnable-query cross-attention probe (reference
    WanCrossAttentionDiscriminatorBlock, model.py:19-83)."""

    def __init__(self, dim: int):
        super().__init__()
        self.query_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.norm = _Norm(dim)
        self.q, self.k = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.v, self.o = nn.Linear(dim, dim), nn.Linear(dim, dim)
        self.q_norm, self.k_norm = _Norm(dim), _Norm(dim)


class APTDiscriminator(nn.Module):
    """`backbone` (a WanModel, frozen) + one probe per tap layer
    (`probes["15"]`, ...) + `final_norm` and `final_proj` to one logit."""

    def __init__(self, backbone: WanModel, taps: Sequence[int]):
        super().__init__()
        dim = backbone.cfg.dim
        self.backbone = backbone
        self.probes = nn.ModuleDict({str(t): Probe(dim) for t in taps})
        self.final_norm = _Norm(dim * len(taps))
        self.final_proj = nn.Linear(dim * len(taps), 1)

    @property
    def taps(self) -> Tuple[int, ...]:
        return tuple(sorted(int(k) for k in self.probes))


def init_apt_discriminator(backbone: WanModel,
                           generator: Optional[torch.Generator] = None
                           ) -> APTDiscriminator:
    """Discriminator around `backbone`, which is frozen in place
    (requires_grad False: pass a copy of a model that is also trained);
    the probes and the head are fresh fp32 trainables on the backbone's
    device, drawn from `generator` as the JAX init draws them
    (model.py:86-121): normal / sqrt(dim) query tokens and weights, zero
    biases, unit norms."""
    cfg = backbone.cfg
    taps = tuple(sorted(set(default_tap_layers(cfg.num_layers))))
    backbone.requires_grad_(False)
    dev = next(backbone.parameters()).device
    disc = APTDiscriminator(backbone, taps)
    for name, m in disc.named_children():
        if name != "backbone":
            m.to(device=dev, dtype=torch.float32)
    dim = cfg.dim
    with torch.no_grad():
        for p in disc.probes.values():
            p.query_token.normal_(0.0, dim ** -0.5, generator=generator)
            for lin in (p.q, p.k, p.v, p.o):
                lin.weight.normal_(0.0, dim ** -0.5, generator=generator)
                lin.bias.zero_()
        width = dim * len(taps)
        disc.final_proj.weight.normal_(0.0, width ** -0.5,
                                       generator=generator)
        disc.final_proj.bias.zero_()
    return disc


def _probe_forward(p: Probe, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, dim] block output -> [B, dim]: one learned query attends over
    the tokens (plain softmax attention: one query row)."""
    b, l, dim = x.shape
    hd = dim // num_heads
    xn = p.norm(x)
    query = p.query_token.expand(b, 1, dim)
    q = p.q_norm(_linear(p.q, query)).reshape(b, 1, num_heads, hd)
    k = p.k_norm(_linear(p.k, xn)).reshape(b, l, num_heads, hd)
    v = _linear(p.v, xn).reshape(b, l, num_heads, hd)
    logits = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
    attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", attn, v).reshape(b, 1, dim)
    return _linear(p.o, out)[:, 0]


def apt_discriminator_forward(disc: APTDiscriminator, x, t, context, *,
                              seq_len: int, rope_sin, rope_cos,
                              policy: DTypePolicy = DTypePolicy(),
                              stop_features: bool = True, remat=False):
    """Scalar real/fake logit [B, 1] (model.py:123-186) at the (already
    shifted) raw timestep t [B].

    stop_features: cut gradients at the taps (the backbone runs under
    no_grad) - right for the D update, where only the probes and head
    train. The G update passes False, so the generator's adversarial
    gradient flows through the frozen backbone into its input (the
    reference's no_grad there zeroes it); pass remat=True with it."""
    taps = disc.taps
    fwd = dict(seq_len=seq_len, rope_sin=rope_sin, rope_cos=rope_cos,
               policy=policy, remat=remat, collect_layers=taps)
    if stop_features:
        with torch.no_grad():
            _, feats = disc.backbone(x, t, context, **fwd)
    else:
        _, feats = disc.backbone(x, t, context, **fwd)
    cfg: WanModelConfig = disc.backbone.cfg
    probe_outs = [_probe_forward(disc.probes[str(tl)], feats[tl],
                                 cfg.num_heads) for tl in taps]
    h = disc.final_norm(torch.cat(probe_outs, dim=-1))
    return _linear(disc.final_proj, h)


def approximated_r1_loss(disc_fn, real_samples, noise,
                         sigma: float = 0.01) -> torch.Tensor:
    """E[(D(x) - D(x + sigma*eps))^2] (model.py:224-251), eps = `noise`
    (the caller draws it: the JAX function draws it from a key)."""
    real_pred = disc_fn(real_samples)
    perturbed_pred = disc_fn(real_samples + sigma * noise)
    return torch.mean(torch.square(real_pred - perturbed_pred))


@torch.no_grad()
def ema_update(ema: Tensors, params: Tensors, decay: float = 0.995) -> None:
    """ema <- ema * decay + p * (1 - decay) in place: computed in fp32 and
    rounded once to the EMA's dtype, as the fused JAX update rounds."""
    for n, e in ema.items():
        e.copy_(e.float() * decay + params[n].to(e.dtype).float()
                * (1.0 - decay))
