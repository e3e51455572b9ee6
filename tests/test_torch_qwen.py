"""The port's Qwen2 decoder (models/qwen.py) against the JAX package at a
tiny config (vocab 128, dim 64, 2 layers, 4 / 2 heads), fp32, the same
weights carried by `qwen_state_dict_from_jax`.

- `qwen_forward` against JAX `qwen_forward`, with and without ragged
  `seq_lens`, tied and untied heads: 1e-5 (fp32, other summation order);
- the varlen mask: a right-padded row's valid logits equal the row run
  alone: 1e-5;
- `qwen_generate` on a ragged batch equals step-by-step greedy argmax over
  JAX's `qwen_forward` token for token (JAX's own `qwen_generate` writes
  each decode token one position too far, ROADMAP C "Known" 2, so it is
  not the reference);
- eos fill, seeded sampling, the head-dim table, config.json and
  checkpoint files, and transformers' `Qwen2ForCausalLM` on the same HF
  state dict (1e-4: its attention and RMSNorm order their sums
  otherwise).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.models import qwen as jq
from omnihuman_tpu_torch.models import qwen as pq
from omnihuman_tpu_torch.utils.convert import qwen_state_dict_from_jax

torch.set_num_threads(1)

TINY = dict(vocab_size=128, dim=64, ffn_dim=96, num_layers=2, num_heads=4,
            num_kv_heads=2)
L0, T = 12, 10


def _pair(tie=True, seed=0):
    jcfg = jq.QwenConfig(**TINY, tie_embeddings=tie)
    pcfg = pq.QwenConfig(**TINY, tie_embeddings=tie)
    params = jax.tree.map(np.asarray, jq.init_qwen(jax.random.key(seed),
                                                   jcfg))
    rng = np.random.default_rng(seed + 1)     # non-trivial biases and norms
    b = params["blocks"]
    for k in ("q", "k", "v"):
        b[k]["b"] = (0.1 * rng.normal(size=b[k]["b"].shape)
                     ).astype(np.float32)
    for k in ("ln1", "ln2"):
        b[k] = (1 + 0.1 * rng.normal(size=b[k].shape)).astype(np.float32)
    sd = qwen_state_dict_from_jax(params, pcfg)
    return params, jcfg, pq.convert_qwen(sd, pcfg), sd


@pytest.fixture(scope="module")
def tied():
    return _pair(True)


def _prompts(seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 128, size=(2, L0)).astype(np.int32)
    lens = np.array([L0, 7], np.int32)
    toks[1, 7:] = 0                                   # right padding
    return toks, lens


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


def test_varlen_mask_equals_the_row_alone(tied):
    _, _, model, _ = tied
    toks, lens = _prompts()
    full = pq.qwen_forward(model, torch.from_numpy(toks).long(),
                           torch.from_numpy(lens))
    alone = pq.qwen_forward(model, torch.from_numpy(toks[1:, :7]).long())
    np.testing.assert_allclose(full[1, :7].numpy(), alone[0].numpy(),
                               atol=1e-5)


def _jax_greedy(params, jcfg, toks, lens, n):
    """Step-by-step argmax over JAX qwen_forward at one padded length."""
    fwd = jax.jit(lambda p, t, sl: jq.qwen_forward(p, t, jcfg, sl))
    width = L0 + n
    out = []
    for r in range(toks.shape[0]):
        seq = list(toks[r, :lens[r]])
        gen = []
        for _ in range(n):
            buf = np.zeros((1, width), np.int32)
            buf[0, :len(seq)] = seq
            lg = np.asarray(fwd(params, jnp.asarray(buf),
                                jnp.asarray([len(seq)], jnp.int32)))
            tok = int(lg[0, len(seq) - 1].argmax())
            gen.append(tok)
            seq.append(tok)
        out.append(gen)
    return np.asarray(out)


def test_generate_equals_stepwise_greedy_over_jax(tied):
    params, jcfg, model, _ = tied
    toks, lens = _prompts()
    got = pq.qwen_generate(model, torch.from_numpy(toks).long(),
                           torch.from_numpy(lens), T)
    want = _jax_greedy(params, jcfg, toks, lens, T)
    assert got.shape == (2, T)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="CUDA"):    # graphs need the card
        pq.qwen_generate(model, torch.from_numpy(toks).long(),
                         torch.from_numpy(lens), T, cuda_graph=True)


def test_generate_fills_after_eos(tied):
    _, _, model, _ = tied
    toks, lens = _prompts()
    args = (model, torch.from_numpy(toks).long(), torch.from_numpy(lens), T)
    free = pq.qwen_generate(*args).numpy()
    eos = int(free[0, 2])                  # row 0 emits it at step 2
    got = pq.qwen_generate(*args, eos_id=eos).numpy()
    for r in range(2):
        hits = np.nonzero(free[r] == eos)[0]
        first = hits[0] if len(hits) else T
        np.testing.assert_array_equal(got[r, :first + 1], free[r, :first + 1])
        assert (got[r, first:] == eos).all()
    assert (got[0, 2:] == eos).all()


def test_seeded_sampling_reproduces(tied):
    _, _, model, _ = tied
    toks, lens = _prompts()

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return pq.qwen_generate(model, torch.from_numpy(toks).long(),
                                torch.from_numpy(lens), T, temperature=1.5,
                                generator=g)

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert ((a >= 0) & (a < 128)).all()


def _shape_dict(dim, layers, kv, ffn, vocab=151936):
    meta = dict(device="meta")
    sd = {"model.embed_tokens.weight": torch.empty(vocab, dim, **meta)}
    for i in range(layers):
        sd[f"model.layers.{i}.self_attn.k_proj.weight"] = torch.empty(
            kv, dim, **meta)
        sd[f"model.layers.{i}.mlp.gate_proj.weight"] = torch.empty(
            ffn, dim, **meta)
    return sd


def test_infer_config_takes_heads_from_the_released_sizes():
    cfg = pq.infer_qwen_config(_shape_dict(1536, 28, 256, 8960))
    assert cfg.head_dim == 128 and cfg.num_heads == 12
    assert cfg.num_kv_heads == 2 and cfg.num_layers == 28
    assert cfg == dataclasses.replace(pq.QWEN_CONFIGS["qwen2.5-1.5b"])
    # JAX guesses 64 at this width (ROADMAP C "Known" 3)
    assert jq.infer_qwen_config(_shape_dict(1536, 28, 256, 8960)
                                ).head_dim == 64
    cfg3 = pq.infer_qwen_config(_shape_dict(2048, 36, 256, 11008))
    assert cfg3 == pq.QWEN_CONFIGS["qwen2.5-3b"]
    with pytest.raises(ValueError, match="num_heads"):
        pq.infer_qwen_config(_shape_dict(64, 2, 32, 96, vocab=128))
    assert pq.infer_qwen_config(_shape_dict(64, 2, 32, 96, vocab=128),
                                num_heads=4).head_dim == 16


def test_untied_head_is_detected_and_loaded():
    params, _, model, sd = _pair(False, seed=5)
    assert "lm_head.weight" in sd and hasattr(model, "lm_head")
    assert not pq.infer_qwen_config(sd, num_heads=4).tie_embeddings
    _, _, _, tied_sd = _pair(True)
    tied_sd = dict(tied_sd, **{
        "lm_head.weight": tied_sd["model.embed_tokens.weight"].clone()})
    assert pq.infer_qwen_config(tied_sd, num_heads=4).tie_embeddings


def test_load_qwen_checkpoint_from_a_directory_and_a_file(tmp_path, tied):
    from safetensors.torch import save_file
    params, jcfg, model, sd = tied
    d = tmp_path / "qwen_tiny"
    d.mkdir()
    save_file({k: v.to(torch.bfloat16).contiguous() for k, v in sd.items()},
              str(d / "model.safetensors"))
    json.dump({"num_attention_heads": 4, "rope_theta": 10000.0,
               "rms_norm_eps": 1e-5}, open(d / "config.json", "w"))
    loaded, cfg = pq.load_qwen_checkpoint(str(d), device="cpu")
    assert cfg.num_heads == 4 and cfg.rope_theta == 10000.0
    assert cfg.rms_eps == 1e-5 and cfg.tie_embeddings
    for k, v in loaded.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, sd[k].to(torch.bfloat16).float())
    torch.save(sd, tmp_path / "qwen.pt")
    with pytest.raises(ValueError, match="num_heads"):
        pq.load_qwen_checkpoint(str(tmp_path / "qwen.pt"), device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pq.load_qwen_checkpoint(str(tmp_path / "empty"), device="cpu")


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
