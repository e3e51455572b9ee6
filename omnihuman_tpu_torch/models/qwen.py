"""Qwen2 / 2.5 causal decoder, the local LLM of the prompt expander (port
of omnihuman_tpu/models/qwen.py).

Architecture (Qwen2 family, HF `Qwen2ForCausalLM`): pre-RMSNorm blocks,
rotate-half rotary embeddings, grouped-query attention with q / k / v bias
and a bias-free o_proj, SwiGLU MLP, final RMSNorm, and an LM head tied to
the embedding at 3B and below (7B and up carry their own `lm_head`). The
module tree carries the HF names (`model.layers.{i}.self_attn.q_proj`, ...),
so an HF state dict loads with `load_state_dict`.

Everything computes in fp32, as the JAX package's converted parameters do.
Prompt-expansion sequences are short (under 1k tokens), so attention is a
dense masked softmax in torch ops, as JAX leaves it to XLA: no Pallas
kernel is on this path.

Generation: one prefill over the right-padded prompts, then single-token
decode steps against a static [layers, B, L0 + T, kv_heads, head_dim] KV
cache, greedy or sampled from an explicit `torch.Generator`. On the card
the decode step is captured once as a CUDA graph and replayed, the
counterpart of JAX's one jitted `lax.scan`: eager, its ~50 small kernels a
layer leave the card idle between launches. Three faults
of the JAX module are not copied (ROADMAP C, "Known in the reference"
2-3): the k-th generated token is written at position prompt_len + k - 1
(JAX writes it one further, `qwen.py:265`), and `infer_qwen_config` takes
the head count from the table of released sizes or requires it (JAX
guesses head_dim 64 at dim 1536, where Qwen2.5-1.5B has 128).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from omnihuman_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class QwenConfig:
    """Qwen2 / 2.5 decoder hyperparameters (HF Qwen2Config names)."""

    vocab_size: int = 151936
    dim: int = 2048                      # hidden_size
    ffn_dim: int = 11008                 # intermediate_size
    num_layers: int = 36
    num_heads: int = 16
    num_kv_heads: int = 2
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


# Qwen2.5-Instruct released sizes (config.json values)
QWEN_CONFIGS = {
    "qwen2.5-0.5b": QwenConfig(dim=896, ffn_dim=4864, num_layers=24,
                               num_heads=14, num_kv_heads=2),
    "qwen2.5-1.5b": QwenConfig(dim=1536, ffn_dim=8960, num_layers=28,
                               num_heads=12, num_kv_heads=2),
    "qwen2.5-3b": QwenConfig(dim=2048, ffn_dim=11008, num_layers=36,
                             num_heads=16, num_kv_heads=2),
    "qwen2.5-7b": QwenConfig(dim=3584, ffn_dim=18944, num_layers=28,
                             num_heads=28, num_kv_heads=4,
                             tie_embeddings=False),
    "qwen2.5-14b": QwenConfig(dim=5120, ffn_dim=13824, num_layers=48,
                              num_heads=40, num_kv_heads=8,
                              tie_embeddings=False),
}
# hidden size -> attention heads of the released sizes
RELEASED_HEADS = {c.dim: c.num_heads for c in QWEN_CONFIGS.values()}


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class QwenAttention(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        d, kv = cfg.dim, cfg.num_kv_heads * cfg.head_dim
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, kv)
        self.v_proj = nn.Linear(d, kv)
        self.o_proj = nn.Linear(d, d, bias=False)


class QwenMLP(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.gate_proj = nn.Linear(cfg.dim, cfg.ffn_dim, bias=False)
        self.up_proj = nn.Linear(cfg.dim, cfg.ffn_dim, bias=False)
        self.down_proj = nn.Linear(cfg.ffn_dim, cfg.dim, bias=False)


class QwenLayer(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.dim)
        self.self_attn = QwenAttention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.dim)
        self.mlp = QwenMLP(cfg)


class QwenBody(nn.Module):
    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.dim)
        self.layers = nn.ModuleList(QwenLayer(cfg)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.dim)


class Qwen(nn.Module):
    """`Qwen2ForCausalLM`'s module tree: `model.*` and, untied, `lm_head`."""

    def __init__(self, cfg: QwenConfig):
        super().__init__()
        self.cfg = cfg
        self.model = QwenBody(cfg)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Linear(cfg.dim, cfg.vocab_size, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """JAX `init_qwen`'s rule: normal(0, 0.02) embedding, linears
        normal / sqrt(fan_in), zero biases, unit norms."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
        self.model.embed_tokens.weight.normal_(0.0, 0.02, generator=generator)


def build_qwen(cfg: QwenConfig, device, dtype: torch.dtype = torch.float32,
               seed: Optional[int] = 0) -> Qwen:
    """Allocate the decoder on `device` in `dtype` and, with `seed`, fill
    it by `init_weights` from a generator seeded with it."""
    with torch.device("meta"):
        model = Qwen(cfg)
    model = model.to(dtype).to_empty(device=device)
    if seed is not None:
        model.init_weights(torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# forward


def _rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin) [B, L, 1, hd / 2] of the rotate-half embedding at
    positions [B, L]; made once per forward or decode step, shared by
    every layer."""
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=positions.device) / hd))
    ang = positions[..., None].to(torch.float32) * inv     # [B, L, hd/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _rope(x: torch.Tensor, cos: torch.Tensor,
          sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding of x [B, L, N, hd]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """bool [B, Lq, Lk] -> additive [B, 1, 1, Lq, Lk]: 0 where a key is
    seen, -inf where not (adding it equals JAX's where(mask, s, -inf))."""
    bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
    return bias.masked_fill(~mask, float("-inf"))[:, None, None]


def _attend(q, k, v, bias):
    """q [B, Lq, N, hd]; k / v [B, Lk, Nkv, hd]; bias [B, 1, 1, Lq, Lk] ->
    [B, Lq, N * hd]. The N / Nkv query heads of a KV head are grouped
    against it (JAX repeats K and V instead: the same products)."""
    b, lq, n, hd = q.shape
    g = k.shape[2]
    qg = q.float().reshape(b, lq, g, n // g, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (hd ** -0.5)
    p = torch.softmax(s + bias, dim=-1).to(v.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, v).reshape(b, lq, n * hd)


def _block(layer: QwenLayer, x, rope_cs, bias, cfg: QwenConfig,
           kv_hook=None):
    """One decoder block; rope_cs = (cos, sin) of `_rope_tables`, bias of
    `_mask_bias`. kv_hook(k, v) -> (k_attend, v_attend) lets a decode step
    write this call's K / V into its cache and attend against the whole
    cache. Returns (x, (k_attend, v_attend))."""
    b, l, _ = x.shape
    n, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    at = layer.self_attn
    h = rms_norm(x, layer.input_layernorm.weight, eps=cfg.rms_eps)
    q = F.linear(h, at.q_proj.weight, at.q_proj.bias).reshape(b, l, n, hd)
    k = F.linear(h, at.k_proj.weight, at.k_proj.bias).reshape(b, l, nkv, hd)
    v = F.linear(h, at.v_proj.weight, at.v_proj.bias).reshape(b, l, nkv, hd)
    q, k = _rope(q, *rope_cs), _rope(k, *rope_cs)
    ka, va = (k, v) if kv_hook is None else kv_hook(k, v)
    x = x + F.linear(_attend(q, ka, va, bias), at.o_proj.weight)
    h = rms_norm(x, layer.post_attention_layernorm.weight, eps=cfg.rms_eps)
    mlp = layer.mlp
    ff = F.silu(F.linear(h, mlp.gate_proj.weight)) * F.linear(
        h, mlp.up_proj.weight)
    return x + F.linear(ff, mlp.down_proj.weight), (ka, va)


def _logits(model: Qwen, x) -> torch.Tensor:
    cfg = model.cfg
    h = rms_norm(x, model.model.norm.weight, eps=cfg.rms_eps)
    head = (model.model.embed_tokens.weight if cfg.tie_embeddings
            else model.lm_head.weight)
    return F.linear(h, head).to(torch.float32)


def _embed(model: Qwen, tokens: torch.Tensor) -> torch.Tensor:
    return model.model.embed_tokens.weight[tokens]


@torch.inference_mode()
def qwen_forward(model: Qwen, tokens: torch.Tensor,
                 seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal forward. tokens [B, L] -> logits [B, L, V] fp32.

    seq_lens (optional, [B]): valid lengths of right-padded rows; keys past
    a row's length are masked out (positions stay 0..L-1)."""
    cfg = model.cfg
    b, l = tokens.shape
    dev = tokens.device
    x = _embed(model, tokens)
    positions = torch.arange(l, device=dev)[None].expand(b, l)
    mask = torch.ones((l, l), dtype=torch.bool, device=dev).tril()[None]
    if seq_lens is not None:
        lens = torch.as_tensor(seq_lens, device=dev)
        mask = mask & (torch.arange(l, device=dev)[None, None, :]
                       < lens[:, None, None])
    rope_cs = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    bias = _mask_bias(mask.expand(b, l, l))
    for layer in model.model.layers:
        x, _ = _block(layer, x, rope_cs, bias, cfg)
    return _logits(model, x)


def _pick(logits: torch.Tensor, temperature: float,
          generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature > 0.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return logits.argmax(dim=-1)


def _graphed(step):
    """`step` captured as a CUDA graph: two warm-up runs on a side stream
    (which must be harmless to repeat: the decode step rewrites the same
    cache slots), the capture, and a function that replays it and returns
    the step's output tensor, rewritten in place by every replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()

    def replay():
        graph.replay()
        return out
    return replay


@torch.inference_mode()
def qwen_generate(model: Qwen, prompt: torch.Tensor,
                  prompt_lens: torch.Tensor, max_new_tokens: int,
                  temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  eos_id: int = -1,
                  cuda_graph: Optional[bool] = None) -> torch.Tensor:
    """Greedy (temperature 0) or sampled generation.

    prompt [B, L0] right-padded ids; prompt_lens [B] valid lengths.
    Returns [B, max_new_tokens] int64: the tokens generated after each
    row's prompt, positions past an EOS filled with eos_id when
    eos_id >= 0 (0 included). Sampling draws from `generator` (on the
    prompt's device). One prefill at L0, then single-token decode steps
    over a static [layers, B, L0 + T, kv_heads, head_dim] cache.

    cuda_graph: replay the decode step as a CUDA graph (the port's
    counterpart of JAX's one jitted scan); None means yes on CUDA
    tensors, False runs it eagerly (CPU tensors always do). The tokens
    are the same either way."""
    cfg = model.cfg
    b, l0 = prompt.shape
    t_max = int(max_new_tokens)
    m = l0 + t_max
    dev = prompt.device
    if cuda_graph is None:
        cuda_graph = dev.type == "cuda"
    elif cuda_graph and dev.type != "cuda":
        raise ValueError(f"cuda_graph needs CUDA tensors, not {dev}")
    lens = torch.as_tensor(prompt_lens, device=dev).to(torch.int64)
    rows = torch.arange(b, device=dev)
    layers = model.model.layers

    # prefill: causal forward over the prompts, keeping each layer's K / V
    x = _embed(model, prompt)
    slots = torch.arange(l0, device=dev)[None, :]
    mask = (torch.ones((l0, l0), dtype=torch.bool, device=dev).tril()[None]
            & (slots[:, None, :] < lens[:, None, None]))
    rope_cs = _rope_tables(slots.expand(b, l0), cfg.head_dim,
                           cfg.rope_theta)
    bias = _mask_bias(mask)
    shape = (cfg.num_layers, b, m, cfg.num_kv_heads, cfg.head_dim)
    kc = torch.zeros(shape, dtype=x.dtype, device=dev)
    vc = torch.zeros_like(kc)
    valid = (slots < lens[:, None])[:, :, None, None]         # [B, L0,1,1]
    for i, layer in enumerate(layers):
        x, (k, v) = _block(layer, x, rope_cs, bias, cfg)
        # pad slots stay zero: generated tokens are written into them
        kc[i, :, :l0] = torch.where(valid, k, 0.0)
        vc[i, :, :l0] = torch.where(valid, v, 0.0)
    last = x[rows, lens - 1][:, None]                         # [B, 1, D]
    tok = _pick(_logits(model, last)[:, 0], temperature, generator)
    done = tok == eos_id          # never true without an eos id (-1)
    out = [tok]

    # decode: the previous token, at its position pos, in; its K / V
    # written into slot pos; attention over the slots <= pos
    tok_in, pos = tok.clone(), lens.clone()
    cache_slots = torch.arange(m, device=dev)[None, None, :]  # [1, 1, M]

    def step():
        bias = _mask_bias(cache_slots <= pos[:, None, None])
        rope_cs = _rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
        x = _embed(model, tok_in)[:, None]
        for li, layer in enumerate(layers):
            def write(k, v, li=li):
                kc[li].index_put_((rows, pos), k[:, 0])
                vc[li].index_put_((rows, pos), v[:, 0])
                return kc[li], vc[li]

            x, _ = _block(layer, x, rope_cs, bias, cfg, kv_hook=write)
        return _logits(model, x)[:, 0]

    run = step
    for i in range(1, t_max):
        tok_in.copy_(tok)
        pos.copy_(lens + (i - 1))
        if cuda_graph and run is step:
            run = _graphed(step)
        nxt = _pick(run(), temperature, generator)
        if eos_id >= 0:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# HF checkpoints


def _strip(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k.removeprefix("model."): v for k, v in state_dict.items()}


def infer_qwen_config(state_dict: Mapping[str, torch.Tensor],
                      num_heads: Optional[int] = None) -> QwenConfig:
    """QwenConfig from an HF state dict's shapes. The head count is not in
    the shapes (q_proj is square): it comes from `num_heads`, else from
    the released size of that hidden width (RELEASED_HEADS); another
    width without `num_heads` raises."""
    sd = _strip(state_dict)
    vocab, dim = sd["embed_tokens.weight"].shape
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd
                       if k.startswith("layers."))
    kv_d = sd["layers.0.self_attn.k_proj.weight"].shape[0]
    ffn = sd["layers.0.mlp.gate_proj.weight"].shape[0]
    heads = num_heads or RELEASED_HEADS.get(int(dim))
    if not heads:
        raise ValueError(f"hidden size {dim} is no released Qwen2.5 size "
                         f"({sorted(RELEASED_HEADS)}): pass num_heads "
                         "(config.json's num_attention_heads)")
    hd = int(dim) // int(heads)
    # an HF state dict of a TIED model may still carry lm_head.weight (the
    # embedding's storage); only a head that differs means untied
    head = state_dict.get("lm_head.weight")
    tied = head is None or torch.equal(head.float(),
                                       sd["embed_tokens.weight"].float())
    return QwenConfig(vocab_size=int(vocab), dim=int(dim), ffn_dim=int(ffn),
                      num_layers=n_layers, num_heads=int(heads),
                      num_kv_heads=int(kv_d) // hd, tie_embeddings=tied)


def convert_qwen(state_dict: Mapping[str, torch.Tensor], cfg: QwenConfig,
                 device="cpu") -> Qwen:
    """An HF `Qwen2ForCausalLM` state dict -> a fp32 Qwen on `device`
    (JAX `convert_qwen` converts to fp32 too); names with or without the
    `model.` prefix. A tied model's stray `lm_head.weight` is dropped."""
    model = build_qwen(cfg, device, torch.float32, seed=None)
    want = model.state_dict()
    sd = {}
    for k, v in state_dict.items():
        name = k if k.startswith("model.") or k == "lm_head.weight" \
            else f"model.{k}"
        if name in want:
            sd[name] = v
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"Qwen state dict lacks {missing[:5]}")
    model.load_state_dict(sd, strict=True)
    return model


def load_qwen_checkpoint(path: str, device=None) -> Tuple[Qwen, QwenConfig]:
    """(model, cfg) from an HF checkpoint on `device` (default: the GPU).

    `path` is a state-dict file (.pt / .pth / .safetensors) or an HF model
    directory (config.json and one or more weight shards); the
    directory's config.json gives the head count, rope_theta and the RMS
    eps."""
    from omnihuman_tpu_torch.pipelines.text2video import resolve_device
    from omnihuman_tpu_torch.utils.convert import load_torch_state_dict

    device = resolve_device(device)
    num_heads, hf_cfg = None, {}
    if os.path.isdir(path):
        cfg_file = os.path.join(path, "config.json")
        if os.path.exists(cfg_file):
            with open(cfg_file) as fh:
                hf_cfg = json.load(fh)
            num_heads = hf_cfg.get("num_attention_heads")
        shards = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith((".safetensors", ".bin", ".pt", ".pth"))
            and "index" not in f)
        if not shards:
            raise FileNotFoundError(f"no weight files in {path}")
        sd = {}
        for s in shards:
            sd.update(load_torch_state_dict(s))
    else:
        sd = load_torch_state_dict(path)
    cfg = infer_qwen_config(sd, num_heads=num_heads)
    if hf_cfg:
        cfg = dataclasses.replace(
            cfg, rope_theta=float(hf_cfg.get("rope_theta", cfg.rope_theta)),
            rms_eps=float(hf_cfg.get("rms_norm_eps", cfg.rms_eps)))
    return convert_qwen(sd, cfg, device), cfg
