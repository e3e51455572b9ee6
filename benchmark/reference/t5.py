"""umT5-XXL's encoder in plain fp32 (reference wan/modules/t5.py:
T5Encoder, T5SelfAttention with a relative position table per block,
T5Attention without 1/sqrt(d) scaling, the gated tanh-GELU FFN, RMS
norms), and the offline hash tokenizer's arithmetic (pad 1, eos 0, word
ids 2 + md5(word)[:8] mod (vocab - 2), after whitespace cleaning)."""

from __future__ import annotations

import hashlib
import html
import math
import re
from typing import List, Tuple

import numpy as np
import torch

from benchmark.reference.common import Linear, rms_norm

VOCAB = 256384


def tokenize(texts: List[str], length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask) [B, length] int32 of the hash tokenizer."""
    ids = np.ones((len(texts), length), np.int32)
    mask = np.zeros((len(texts), length), np.int32)
    for i, t in enumerate(texts):
        t = re.sub(r"\s+", " ", html.unescape(html.unescape(t)).strip())
        words = t.strip().split()[:length - 1]
        for j, w in enumerate(words):
            h = int(hashlib.md5(w.encode()).hexdigest()[:8], 16)
            ids[i, j] = 2 + h % (VOCAB - 2)
        ids[i, len(words)] = 0
        mask[i, :len(words) + 1] = 1
    return ids, mask


def position_buckets(lq: int, lk: int, num_buckets: int, max_dist: int,
                     device) -> torch.Tensor:
    """[lq, lk] bidirectional relative-position buckets."""
    rel = (torch.arange(lk, device=device)[None, :]
           - torch.arange(lq, device=device)[:, None])
    nb = num_buckets // 2
    out = (rel > 0).long() * nb
    rel = rel.abs()
    exact = nb // 2
    large = exact + (torch.log(rel.float().clamp(min=1) / exact)
                     / math.log(max_dist / exact) * (nb - exact)).long()
    large = large.clamp(max=nb - 1)
    return out + torch.where(rel < exact, rel, large)


def encode(sd: dict, t: dict, ids: np.ndarray, mask: np.ndarray, device,
           fp8: bool = False) -> List[torch.Tensor]:
    """Each prompt's valid rows of the encoder output, [n_i, dim] fp32
    (the padded tokens take part as the reference masks them: as keys
    they are masked out)."""
    lin = Linear(fp8)
    outs = []
    n, da = t["num_heads"], t["dim_attn"]
    hd = da // n
    for b in range(ids.shape[0]):
        valid = int(mask[b].sum())
        idx = torch.from_numpy(ids[b].astype(np.int64)).to(device)
        x = sd["token_embedding.weight"][idx.clamp(max=t["vocab_size"] - 1)
                                         ].float()
        l = x.shape[0]
        key_ok = torch.from_numpy(mask[b]).to(device) > 0
        bias_mask = torch.zeros(l, device=device).masked_fill(
            ~key_ok, float("-inf"))
        buckets = position_buckets(l, l, t["num_buckets"], t["max_dist"],
                                   device)
        for i in range(t["num_layers"]):
            p = f"blocks.{i}."
            h = rms_norm(x, sd[p + "norm1.weight"])
            q = lin(h, sd[p + "attn.q.weight"]).reshape(l, n, hd)
            k = lin(h, sd[p + "attn.k.weight"]).reshape(l, n, hd)
            v = lin(h, sd[p + "attn.v.weight"]).reshape(l, n, hd)
            pos = sd[p + "pos_embedding.embedding.weight"].float()[buckets]
            logits = torch.einsum("inc,jnc->nij", q, k) \
                + pos.permute(2, 0, 1) + bias_mask
            a = torch.softmax(logits, dim=-1)
            y = torch.einsum("nij,jnc->inc", a, v).reshape(l, da)
            x = x + lin(y, sd[p + "attn.o.weight"])
            h = rms_norm(x, sd[p + "norm2.weight"])
            g = lin(h, sd[p + "ffn.gate.0.weight"])
            g = 0.5 * g * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                            * (g + 0.044715 * g ** 3)))
            x = x + lin(lin(h, sd[p + "ffn.fc1.weight"]) * g,
                        sd[p + "ffn.fc2.weight"])
        x = rms_norm(x, sd["norm.weight"])
        outs.append(x[:valid])
    return outs
