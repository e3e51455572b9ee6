"""The umT5 encoder against JAX's: the slow cases of
tests/test_torch_t5.py (whose helpers they use), in a file of their own so
that a `--dist loadfile` run schedules them with the files of few tests,
beside the longest ones, instead of before them."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.t5 import t5_encode
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.tokenizers import _HashTokenizer
# fixtures and helpers of the file these cases came from
from test_torch_t5 import _t5_pair, PROMPTS


def test_t5_encode_matches_jax_with_out_of_vocab_ids():
    """Hash-tokenizer ids run up to 256,383 on a 128-row table: JAX's
    gather clamps them to the last row, and so must the port."""
    params, enc = _t5_pair()
    tok = _HashTokenizer(16)
    out = tok(PROMPTS, max_length=16)
    ids, mask = out["input_ids"], out["attention_mask"]
    want = t5_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                     jnp.asarray(mask), JAX_TINY.t5,
                     compute_dtype=jnp.float32)
    got = enc(torch.from_numpy(ids), torch.from_numpy(mask),
              compute_dtype=torch.float32)
    assert got.shape == (3, 16, TINY_TEST.t5.dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_t5_encode_without_mask_matches_jax(rng):
    params, enc = _t5_pair(seed=3)
    ids = rng.integers(0, TINY_TEST.t5.vocab_size, size=(2, 12)
                       ).astype(np.int32)
    want = t5_encode(jax.tree.map(jnp.asarray, params), jnp.asarray(ids),
                     None, JAX_TINY.t5, compute_dtype=jnp.float32)
    got = enc(torch.from_numpy(ids), None, compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
