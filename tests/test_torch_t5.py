"""The port's umT5 encoder and tokenizer against the JAX package.

Tolerance: t5_encode in fp32 1e-4 (outputs are RMS-normalised, of order
1). Token ids and masks must be identical."""

import jax
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.t5 import init_t5_encoder
from omnihuman_tpu.models.t5 import (
    relative_position_buckets as jax_buckets)
from omnihuman_tpu.models.tokenizers import _HashTokenizer as JaxHashTok
from omnihuman_tpu.utils.convert import convert_t5
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.t5 import (
    build_t5_encoder, relative_position_buckets)
from omnihuman_tpu_torch.models.tokenizers import (
    HuggingfaceTokenizer, _HashTokenizer)
from omnihuman_tpu_torch.utils.convert import t5_state_dict_from_jax

torch.set_num_threads(1)

PROMPTS = ["a cat walking in the rain", "two  dogs\tplaying fetch on a "
           "sunny beach at dusk", ""]


@pytest.mark.parametrize("lq,lk,nb,md,bidi", [
    (16, 16, 32, 128, True), (40, 24, 32, 128, True), (20, 20, 8, 16, False)])
def test_relative_position_buckets_match_jax(lq, lk, nb, md, bidi):
    np.testing.assert_array_equal(
        relative_position_buckets(lq, lk, nb, md, bidi),
        jax_buckets(lq, lk, nb, md, bidi))


def test_hash_tokenizer_ids_and_mask_match_jax():
    ours = _HashTokenizer(16)(PROMPTS, max_length=16)
    theirs = JaxHashTok(16)(PROMPTS, max_length=16)
    np.testing.assert_array_equal(ours["input_ids"], theirs["input_ids"])
    np.testing.assert_array_equal(ours["attention_mask"],
                                  theirs["attention_mask"])
    assert ours["input_ids"].max() >= TINY_TEST.t5.vocab_size   # out of vocab


def test_offline_tokenizer_falls_back_to_the_same_ids():
    """Without local tokenizer files the wrapper degrades to the hash
    tokenizer, whose ids and mask equal the JAX fallback's."""
    tok = HuggingfaceTokenizer("google/umt5-xxl", seq_len=16,
                               clean="whitespace")
    if not isinstance(tok.tokenizer, _HashTokenizer):
        pytest.skip("a real umT5 tokenizer is installed locally")
    ids, mask = tok(PROMPTS, return_mask=True)
    cleaned = [" ".join(p.split()) for p in PROMPTS]
    theirs = JaxHashTok(16)(cleaned, max_length=16)
    np.testing.assert_array_equal(ids, theirs["input_ids"])
    np.testing.assert_array_equal(mask, theirs["attention_mask"])


def _t5_pair(seed=0):
    params = jax.tree.map(np.asarray,
                          init_t5_encoder(jax.random.key(seed), JAX_TINY.t5))
    enc = build_t5_encoder(TINY_TEST.t5, "cpu", torch.float32, seed=None)
    enc.load_state_dict(t5_state_dict_from_jax(params, TINY_TEST.t5),
                        strict=True)
    return params, enc


def test_t5_state_dict_round_trips_through_jax_converter():
    params, enc = _t5_pair()
    back = convert_t5({k: v.numpy() for k, v in enc.state_dict().items()},
                      JAX_TINY.t5)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
