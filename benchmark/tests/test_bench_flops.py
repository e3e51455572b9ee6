"""The yardstick's arithmetic: the kernel bounds reproduce the port's
kernel table, the model counts a hand count, the decoder's call list the
launches the card counted."""

from __future__ import annotations

import math

import pytest

from benchmark import flops
from benchmark.tests.tiny import tiny_config


def test_kernel_bounds_reproduce_the_kernel_table():
    # K1 self-attention at the flagship shape: B=2, 32,768 queries, 12
    # heads of 128, 32,760 valid keys each
    ms, by = flops.attention_bound(2, 32768, 12, 128, [32760] * 2)
    assert by == "operations" and ms * 1e3 == pytest.approx(13.34, abs=5e-3)
    # K2 over one sample's self-attention: 32,768 query rows, 32,760 keys
    ms, by = flops.backward_bound(32768, 32768, 32768 * 32760, 12, 128)
    assert by == "operations" and ms * 1e3 == pytest.approx(16.67, abs=5e-3)
    # K3 at T=4 480x832 96 -> 96 with the residual
    ms, by = flops.vae_conv_bound(1, 4, 480, 832, 96, 96, True)
    assert by == "operations" and ms * 1e3 == pytest.approx(0.804, abs=5e-4)
    # K4 at T=4 240x416 -> 480x832, 192 -> 96
    ms, by = flops.vae_upsample_bound(1, 4, 240, 416, 192, 96)
    assert ms * 1e3 == pytest.approx(0.238, abs=5e-4)
    # K1b at Lc 128: bound by bytes
    _, by = flops.attention_bound(2, 32768, 12, 128, [37, 128])
    assert by == "bytes"


def test_decode_call_list_matches_the_launch_counts():
    """588 K3 and 63 K4 launches a decode of 21 latent frames (the
    smoke's count); the largest shapes as the kernel table lists them."""
    v = tiny_config("t2v-1.3B")["vae"]
    k3, k4 = flops.vae_decode_calls(v, 2, 21, 60, 104)
    assert len(k3) == 588 and len(k4) == 63
    assert k3.count((2, 4, 480, 832, 96, 96, True)) == 60
    assert k4.count((2, 4, 240, 416, 192, 96)) == 20
    assert k4.count((2, 2, 60, 104, 384, 192)) == 20


def test_dit_flops_match_a_hand_count():
    m = tiny_config("tiny-test")["model"]
    d, f, n_layers = m["dim"], m["ffn_dim"], m["num_layers"]
    b, n, lens = 2, 32, [5, 9]
    hand = 0.0
    for i in range(b):
        per_layer = (2 * n * 3 * d * d          # q, k, v
                     + 2 * n * d * d            # o
                     + 2 * n * d * d            # cross q
                     + 2 * lens[i] * 2 * d * d  # cross k, v
                     + 2 * n * d * d            # cross o
                     + 2 * n * 2 * d * f        # FFN
                     + 4 * d * n * n            # self-attention
                     + 4 * d * n * lens[i])     # cross-attention
        hand += n_layers * per_layer
        hand += 2 * n * (4 * m["in_dim"] * d + d * 4 * m["out_dim"])
        hand += 2 * lens[i] * (m["text_dim"] * d + d * d)
        hand += 2 * (m["freq_dim"] * d + d * d + d * 6 * d)
    assert flops.dit_forward_flops(m, b, n, lens) == pytest.approx(hand)


def test_dit_flops_at_the_flagship_step():
    """~5.6e14 FLOP a fused CFG step at t2v-1.3B, 32,760 tokens."""
    m = tiny_config("t2v-1.3B")["model"]
    fl = flops.dit_forward_flops(m, 2, 32760, [128, 128])
    assert 5.4e14 < fl < 5.8e14


def test_t5_and_training_counts():
    t = tiny_config("tiny-test")["t5"]
    dim, da, dff, layers = t["dim"], t["dim_attn"], t["dim_ffn"], \
        t["num_layers"]
    n = 7
    hand = layers * (2 * n * (4 * dim * da + 3 * dim * dff)
                     + 4 * da * n * n)
    assert flops.t5_encode_flops(t, [n]) == pytest.approx(hand)
    assert flops.training_flops(1.0) == 3.0


def test_decode_flops_are_positive_and_grow_with_frames():
    v = tiny_config("t2v-1.3B")["vae"]
    one = flops.vae_decode_flops(v, 1, 1, 60, 104)
    more = flops.vae_decode_flops(v, 1, 21, 60, 104)
    assert 0 < one < more and math.isfinite(more)
