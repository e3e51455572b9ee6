"""The Qwen forward against JAX's and against transformers' Qwen2: the
slow cases of tests/test_torch_qwen.py (whose helpers they use), in a file
of their own so that a `--dist loadfile` run schedules them with the files
of few tests, beside the longest ones, instead of before them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.models import qwen as jq
from omnihuman_tpu_torch.models import qwen as pq
# fixtures and helpers of the file these cases came from
from test_torch_qwen import _pair, _prompts, L0, tied


@pytest.mark.parametrize("tie", [True, False])
def test_forward_matches_jax(tie):
    params, jcfg, model, _ = _pair(tie, seed=0 if tie else 5)
    toks, lens = _prompts()
    for sl in (None, lens):
        want = np.asarray(jq.qwen_forward(
            params, jnp.asarray(toks), jcfg,
            None if sl is None else jnp.asarray(sl)))
        got = pq.qwen_forward(model, torch.from_numpy(toks).long(),
                              None if sl is None else torch.from_numpy(sl))
        assert got.dtype == torch.float32 and got.shape == (2, L0, 128)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_forward_matches_transformers_qwen2(tied):
    transformers = pytest.importorskip("transformers")
    _, _, model, sd = tied
    hf_cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=1e6, rms_norm_eps=1e-6, tie_word_embeddings=True,
        max_position_embeddings=64)
    hf = transformers.Qwen2ForCausalLM(hf_cfg).eval()
    hf.load_state_dict(sd, strict=False)
    hf.tie_weights()
    toks, _ = _prompts()
    with torch.no_grad():
        want = hf(torch.from_numpy(toks).long()).logits
    got = pq.qwen_forward(model, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)
