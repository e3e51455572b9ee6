"""The port's (data, fsdp, sp) mesh and FSDP2 sharding against the JAX
package (parallel/mesh.py, parallel/partition.py, the mesh plan of
pipelines/text2video.py and the serving CLIs).

- `MeshConfig.resolve` gives JAX's degrees and raises where JAX's raises.
- `infer_param_specs` picks, for every parameter that the port's
  converters carry from a JAX params tree (the TINY t2v / i2v DiTs, an
  omni model with 308 keypoints, umT5), the dimension JAX's rule shards:
  each JAX leaf is filled with its own element numbers, converted, and
  the port dimension along which JAX's sharded index runs is read off.
- In 4 gloo processes (tests/torch_sp_workers.py, spawned once for the
  file) on a (1, 2, 2) mesh: FSDP2 places every parameter on the inferred
  dimension and the sharded DiT and umT5 forwards equal the unsharded
  ones, the DiT's also under `use_mesh` with no plan argument (sp 2);
  `WanT2V`'s latents (ring at sp 2, FSDP2 at fsdp 2, 2 UniPC steps, fp32)
  equal JAX's `WanT2V` on (2, 2, 2) within 2e-4
  (tests/test_mesh_pipeline.py's tolerance; JAX's data axis replicates),
  both reading one checkpoint directory; `cli.generate` and
  `cli.omni_inference` run with --sp_size / --fsdp_size on the joined
  group and only rank 0 writes its file.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from omnihuman_tpu.configs.wan import DTypePolicy as JaxPolicy
from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.models.t5 import init_t5_encoder
from omnihuman_tpu.models.wan_dit import init_wan_model
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.parallel import MeshConfig as JaxMeshConfig
from omnihuman_tpu.parallel import create_mesh as jax_create_mesh
from omnihuman_tpu.parallel import infer_param_specs as jax_specs
from omnihuman_tpu.pipelines.text2video import WanT2V as JaxWanT2V
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.t5 import T5Encoder
from omnihuman_tpu_torch.models.vae import build_vae
from omnihuman_tpu_torch.models.wan_dit import WanModel, build_wan_model
from omnihuman_tpu_torch.omni.model import OmniModel, OmniModelConfig
from omnihuman_tpu_torch.ops.rope import rope_angles_3d
from omnihuman_tpu_torch.parallel import MeshConfig, infer_param_specs
from omnihuman_tpu_torch.utils.convert import (
    omni_state_dict_from_jax, t5_state_dict_from_jax,
    wan_dit_state_dict_from_jax)
from torch_sp_workers import Ranks

torch.set_num_threads(1)


@pytest.mark.parametrize("cfg,n", [
    ((-1, 1, 1), 8), ((-1, 2, 2), 8), ((2, 2, 2), 8), ((1, 2, 2), 4),
    ((-1, 4, 1), 4), ((-1, 3, 1), 8), ((2, 2, 1), 8), ((1, 1, 1), 1)])
def test_mesh_config_resolve_matches_jax(cfg, n):
    def resolve(make):
        try:
            r = make(*cfg).resolve(n)
            return ("ok", (r.data, r.fsdp, r.sp))
        except ValueError as e:
            return ("error", str(e))

    assert resolve(MeshConfig) == resolve(JaxMeshConfig)


I2V = dict(model_type="i2v", in_dim=36, clip_embed_dim=24, clip_tokens=5)


def _models():
    """{name: (JAX params, converter, port module on the meta device)}."""
    omni_j = JaxOmniCfg(base=JAX_TINY.model, audio_dim=20, num_keypoints=308,
                        num_frames=8)
    omni_p = OmniModelConfig(base=TINY_TEST.model, audio_dim=20,
                             num_keypoints=308, num_frames=8)
    i2v_p = dataclasses.replace(TINY_TEST.model, **I2V)
    with torch.device("meta"):
        port = {"t2v": WanModel(TINY_TEST.model), "i2v": WanModel(i2v_p),
                "omni308": OmniModel(omni_p), "t5": T5Encoder(TINY_TEST.t5)}

    def shapes(init, cfg):     # the leaves' shapes are all the rule reads
        return jax.eval_shape(lambda k: init(k, cfg), jax.random.key(0))

    return {
        "t2v": (shapes(init_wan_model, JAX_TINY.model),
                lambda p: wan_dit_state_dict_from_jax(p, TINY_TEST.model),
                port["t2v"]),
        "i2v": (shapes(init_wan_model, dataclasses.replace(
                    JAX_TINY.model, **I2V)),
                lambda p: wan_dit_state_dict_from_jax(p, i2v_p), port["i2v"]),
        "omni308": (shapes(init_omni_model, omni_j),
                    lambda p: omni_state_dict_from_jax(p, omni_p),
                    port["omni308"]),
        "t5": (shapes(init_t5_encoder, JAX_TINY.t5),
               lambda p: t5_state_dict_from_jax(p, TINY_TEST.t5),
               port["t5"]),
    }


@pytest.fixture(scope="module")
def models():
    return _models()


def _jax_dims(params, convert, min_size, axis_size):
    """{port parameter name: the port dimension JAX's rule shards, or None
    where it replicates the leaf or shards a dimension the port tensor
    lacks (the stacked layer axis, a merged one)}."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    specs = jax.tree_util.tree_leaves(
        jax_specs(params, min_size=min_size, axis_size=axis_size),
        is_leaf=lambda x: isinstance(x, P))
    offsets = np.cumsum([0] + [int(np.prod(x.shape)) for x in leaves])
    assert offsets[-1] < 2 ** 24          # exact in float32
    marked = [(np.arange(np.prod(x.shape), dtype=np.float64) + o).astype(
        np.float32).reshape(x.shape) for x, o in zip(leaves, offsets)]
    out = {}
    for name, t in convert(jax.tree_util.tree_unflatten(tree, marked)
                           ).items():
        vals = t.numpy().astype(np.int64)
        k = int(np.searchsorted(offsets, vals.flat[0], side="right")) - 1
        spec = tuple(specs[k])
        if "fsdp" not in spec:
            out[name] = None
            continue
        j = spec.index("fsdp")
        idx = np.unravel_index(vals - offsets[k], leaves[k].shape)

        def runs(jd, pd):
            return vals.shape[pd] > 1 and np.any(np.diff(idx[jd], axis=pd))

        along = [pd for pd in range(vals.ndim) if runs(j, pd)]
        ok = (len(along) == 1 and not any(
            runs(o, along[0]) for o in range(len(idx)) if o != j))
        out[name] = along[0] if ok else None
    return out


@pytest.mark.parametrize("min_size", [None, 1])
@pytest.mark.parametrize("axis_size", [None, 2, 4, 16])
@pytest.mark.parametrize("model", ["t2v", "i2v", "omni308", "t5"])
def test_infer_param_specs_pick_jax_dims(models, model, axis_size,
                                         min_size):
    params, convert, port = models[model]
    kw = {} if min_size is None else {"min_size": min_size}
    want = _jax_dims(params, convert, kw.get("min_size", 2 ** 16), axis_size)
    got = infer_param_specs(port, axis_size=axis_size, **kw)
    assert got == want
    if model == "omni308" and min_size is None:
        # the pose guider's [3, 3, 3, 308, 128] leaf: 308 shards over 4,
        # not over 16, where the 128 output channels take it
        assert got["cond.pose_conv1.weight"] == {
            None: 1, 2: 1, 4: 1, 16: 0}[axis_size]


def _write_dir(d):
    """A checkpoint directory in the reference layout (the DiT with a
    random head as safetensors, the VAE as Wan2.1_VAE.pth, fp32) that both
    packages load: JAX's WanT2V then builds no random weights."""
    from safetensors.torch import save_file
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(1))
    save_file(model.state_dict(),
              str(d / "diffusion_pytorch_model.safetensors"))
    vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=3)
    torch.save(vae.state_dict(), str(d / "Wan2.1_VAE.pth"))
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    from PIL import Image
    tmp = tmp_path_factory.mktemp("mesh")
    ckpt = tmp / "ckpt"
    ckpt.mkdir()
    sd = _write_dir(ckpt)
    rng = np.random.default_rng(0)
    ctx = [(rng.normal(size=(1, 16, 32)) * 0.1).astype(np.float32)
           for _ in range(2)]
    noise = np.asarray(jax.random.normal(jax.random.key(11),
                                         (1, 16, 2, 4, 4), jnp.float32))
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
                    ).save(tmp / "ref.png")
    payload = {"sd": sd, "ckpt": str(ckpt),
               "x": rng.normal(size=(2, 16, 2, 8, 8)).astype(np.float32),
               "t": np.array([700.0, 30.0], np.float32),
               "ctx": rng.normal(size=(2, 16, 32)).astype(np.float32),
               "gen_ctx": ctx[0], "gen_ctx_null": ctx[1],
               "gen_noise": noise, "out_dir": str(tmp),
               "t5_ids": rng.integers(1, 128, (2, 8)),
               "image": str(tmp / "ref.png")}
    ranks = Ranks(4, "mesh", payload, tmp)
    jpipe = JaxWanT2V(
        dataclasses.replace(JAX_TINY, policy=JaxPolicy(compute=jnp.float32)),
        checkpoint_dir=str(ckpt), mesh=jax_create_mesh(JaxMeshConfig(2, 2, 2)),
        param_dtype=jnp.float32)
    want = np.asarray(jpipe.generate(
        "x", size=(32, 32), frame_num=5, sampling_steps=2, seed=11,
        context=jnp.asarray(ctx[0]), context_null=jnp.asarray(ctx[1]),
        return_latents=True))
    return payload, ranks.results(), want


def test_shard_params_places_every_parameter(results):
    """Each parameter is a DTensor sharded on the inferred dimension (half
    of it on each of the 2 fsdp ranks), or, where JAX replicates, a whole
    tensor left out of FSDP."""
    payload, ranks, _ = results
    full = {k: tuple(v.shape) for k, v in payload["sd"].items()}
    for r in ranks:
        specs, placed = r["specs"], r["placements"]
        assert set(placed) == set(full)
        assert any(d is not None for d in specs.values())
        for name, (dim, local) in placed.items():
            assert dim == specs[name], name
            if dim is not None:
                want = list(full[name])
                want[dim] //= 2
                assert local == tuple(want), name


def _single_device_forward(payload):
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=None)
    model.load_state_dict(payload["sd"])
    sin, cos = rope_angles_3d((2, 4, 4), TINY_TEST.model.head_dim,
                              seq_len=32)
    policy = dataclasses.replace(TINY_TEST.policy, compute=torch.float32)
    with torch.no_grad():
        return model(*(torch.from_numpy(payload[k])
                       for k in ("x", "t", "ctx")),
                     seq_len=32, rope_sin=sin, rope_cos=cos, policy=policy)


def test_fsdp_forward_equals_unsharded(results):
    payload, ranks, _ = results
    want = _single_device_forward(payload)
    for r in ranks:
        torch.testing.assert_close(r["fsdp_forward"], want, rtol=1e-6,
                                   atol=1e-6)


def test_forward_under_use_mesh_equals_single_device(results):
    """The DiT called with no plan argument inside `use_mesh` of the
    (1, 2, 2) mesh takes the plan from the mesh (its tokens sharded over
    the 2 sp ranks, the ring, sp_cross) and gives every rank the
    single-device velocity, within the sp tests' 2e-4."""
    payload, ranks, _ = results
    want = _single_device_forward(payload)
    for r in ranks:
        torch.testing.assert_close(r["mesh_forward"], want, rtol=2e-4,
                                   atol=2e-4)


def test_fsdp_t5_forward_equals_unsharded(results):
    """umT5 under FSDP2 at fsdp 2 (every divisible parameter sharded)
    encodes as the whole encoder does."""
    _, ranks, _ = results
    for r in ranks:
        assert r["t5_dtensors"] > 0
        torch.testing.assert_close(r["t5_sharded"], r["t5_whole"],
                                   rtol=1e-6, atol=1e-6)


def test_wan_t2v_mesh_matches_jax(results):
    """WanT2V(mesh=(1, 2, 2)) takes JAX's plan (the ring, sp 2, umT5
    resident) and every rank's latents equal JAX's WanT2V on (2, 2, 2)."""
    _, ranks, want = results
    for r in ranks:
        assert r["plan"] == ("ring", 2, False)
        np.testing.assert_allclose(r["latents"].numpy(), want, atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("cli", ["generate", "omni"])
def test_cli_runs_on_a_gloo_mesh(results, cli):
    _, ranks, _ = results
    path = ranks[0][cli]
    assert path is not None and os.path.getsize(path) > 0
    assert [r[cli] for r in ranks[1:]] == [None] * 3
