"""The port's DiT and omni sampler under sequence parallelism against the
JAX package's on the 8-device virtual CPU mesh.

TINY DiT forwards (t2v with text lengths, i2v with CLIP tokens and the
mask + reference latent) with the self-attention as the ring and as
Ulysses at sp 4, each rank holding a quarter of the tokens, against JAX's
`wan_model_forward` under `use_mesh` on (data 2, fsdp 1, sp 4); and one
`omni_generate` (2 DPM++ steps, every condition) at sp 2 against JAX's on
(4, 1, 2). The port runs as 4 gloo processes (tests/torch_sp_workers.py,
spawned once for the file); the same JAX weights go to both through the
port's converters; every weight is random (the head and the zero-init
adapters too). fp32 throughout; tolerance 5e-4 (as tests/test_sp_model.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import WanModelConfig as JaxWanCfg
from omnihuman_tpu.models.wan_dit import init_wan_model, wan_model_forward
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.ops.rope import rope_angles_3d
from omnihuman_tpu.parallel import MeshConfig, create_mesh
from omnihuman_tpu.parallel.mesh import use_mesh
from omnihuman_tpu.pipelines.omni import omni_generate as jax_omni_generate
from omnihuman_tpu_torch.configs.wan import WanModelConfig
from omnihuman_tpu_torch.omni.model import OmniModelConfig
from omnihuman_tpu_torch.utils.convert import (
    omni_state_dict_from_jax, wan_dit_state_dict_from_jax)
from torch_sp_workers import Ranks

torch.set_num_threads(1)

BASE = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=2, freq_dim=16,
            text_dim=24, text_len=8)
I2V = dict(model_type="i2v", in_dim=36, clip_embed_dim=24, clip_tokens=5)
JFP32 = JaxPolicy(compute=jnp.float32)
GRID, SEQ = (4, 4, 4), 64


def _random_params(init, cfg, rng, scale=0.2):
    """Random fp32 leaves in the shapes of JAX's init (every weight random,
    the head and the zero-init adapters included): the values both
    packages get, without compiling JAX's init."""
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))
    return jax.tree.map(lambda x: (rng.normal(size=x.shape) * scale).astype(
        np.float32), shapes)


def _dit_case(rng, i2v: bool):
    jcfg = JaxWanCfg(**BASE, **(I2V if i2v else {}))
    params = _random_params(init_wan_model, jcfg, rng)
    pcfg = WanModelConfig(**BASE, **(I2V if i2v else {}))
    d = {"cfg": pcfg, "sd": wan_dit_state_dict_from_jax(params, pcfg),
         "grid": GRID, "seq_len": SEQ,
         "x": rng.normal(size=(2, 16, 4, 8, 8)).astype(np.float32),
         "t": np.array([500.0, 100.0], np.float32),
         "ctx": rng.normal(size=(2, 8, 24)).astype(np.float32)}
    if i2v:     # no text lengths: JAX adds clip_tokens to them (ROADMAP C)
        d["y"] = rng.normal(size=(2, 20, 4, 8, 8)).astype(np.float32)
        d["clip"] = rng.normal(size=(2, 5, 24)).astype(np.float32)
    else:
        d["lens"] = torch.tensor([8, 5], dtype=torch.int32)
    return params, jcfg, d


def _jax_dit(cases, mesh):
    """JAX's velocities of every (kind, impl), traced into one program."""
    def run(arrays):
        out = {}
        for kind, (params, jcfg, _) in cases.items():
            a = arrays[kind]
            sin, cos = rope_angles_3d(GRID, jcfg.head_dim, seq_len=SEQ)
            kw = dict(cfg=jcfg, seq_len=SEQ, rope_sin=sin, rope_cos=cos,
                      policy=JFP32, remat=False,
                      context_lens=a.get("lens"), y=a.get("y"),
                      clip_fea=a.get("clip"))
            for impl in ("ring", "ulysses"):
                out[f"{kind}_{impl}"] = wan_model_forward(
                    a["params"], a["x"], a["t"], a["ctx"], attn_impl=impl,
                    **kw)
        return out

    arrays = {}
    for kind, (params, _, d) in cases.items():
        a = {k: jnp.asarray(d[k]) for k in ("x", "t", "ctx", "y", "clip")
             if k in d}
        if "lens" in d:
            a["lens"] = jnp.asarray(d["lens"].numpy())
        a["params"] = params
        arrays[kind] = a
    with use_mesh(mesh):
        return {k: np.asarray(v) for k, v in jax.jit(run)(arrays).items()}


def _omni_case(rng):
    jcfg = JaxOmniCfg(base=JaxWanCfg(**BASE), audio_dim=20,
                      num_keypoints=8, num_frames=8)
    pcfg = OmniModelConfig(base=WanModelConfig(**BASE), audio_dim=20,
                           num_keypoints=8, num_frames=8)
    params = _random_params(init_omni_model, jcfg, rng)
    b, c, f, h, w = 2, 16, 2, 8, 8
    o = {"cfg": pcfg, "sd": omni_state_dict_from_jax(params, pcfg),
         "noise": rng.normal(size=(b, c, f, h, w)).astype(np.float32),
         "ctx": (rng.normal(size=(b, 8, 24)) * 0.5).astype(np.float32),
         "ctx_null": (rng.normal(size=(b, 8, 24)) * 0.5).astype(np.float32),
         "audio": rng.normal(size=(b, 4, 20)).astype(np.float32),
         "pose": (rng.normal(size=(b, 8, f, 2 * h, 2 * w)) * 0.1
                  ).astype(np.float32),
         "ref_latent": rng.normal(size=(b, c, 1, h, w)).astype(np.float32),
         "lens": np.array([6, 8], np.int32),
         "nlens": np.array([3, 7], np.int32),
         "kw": dict(sampling_steps=2, cfg_scale=5.0, shift=1.0)}
    return params, jcfg, o


def _jax_omni(params, jcfg, o):
    mesh = create_mesh(MeshConfig(data=4, fsdp=1, sp=2))
    return np.asarray(jax_omni_generate(
        params, *(jnp.asarray(o[k]) for k in ("noise", "ctx", "ctx_null")),
        cfg=jcfg, policy=JFP32, mesh=mesh, audio=jnp.asarray(o["audio"]),
        pose=jnp.asarray(o["pose"]), ref_latent=jnp.asarray(o["ref_latent"]),
        context_lens=jnp.asarray(o["lens"]),
        null_lens=jnp.asarray(o["nlens"]), **o["kw"]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {kind: _dit_case(rng, kind == "i2v") for kind in ("t2v", "i2v")}
    omni = _omni_case(rng)
    payload = {kind: c[2] for kind, c in cases.items()}
    payload["omni"] = omni[2]
    ranks = Ranks(4, "dit", payload, tmp_path_factory.mktemp("sp_model"))
    mesh = create_mesh(MeshConfig(data=2, fsdp=1, sp=4))
    want = _jax_dit(cases, mesh)
    want["omni_sp2"] = _jax_omni(*omni)
    return ranks.results(), want


@pytest.mark.parametrize("case", ["t2v_ring", "t2v_ulysses", "i2v_ring",
                                  "i2v_ulysses"])
def test_dit_forward_sp4_matches_jax(results, case):
    """Every rank returns the whole velocity (the head output is gathered
    over sp before unpatchify), and every rank's equals JAX's."""
    ranks, want = results
    assert want[case].shape == (2, 16, 4, 8, 8)
    for r in ranks:
        np.testing.assert_allclose(r[case].numpy(), want[case], atol=5e-4,
                                   rtol=5e-4)


def test_omni_generate_sp2_matches_jax(results):
    ranks, want = results
    for r in ranks:
        np.testing.assert_allclose(r["omni_sp2"].numpy(), want["omni_sp2"],
                                   atol=5e-4, rtol=5e-4)
