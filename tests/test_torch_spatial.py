"""The port's spatial sharding (parallel/spatial.py) against the JAX
package, in one process on `VirtualRanks` (every rank's program on its own
thread, halos cut from the neighbours' tensors).

- `halo_exchange` forward and backward against the zero-padded whole
  tensor's windows; `gather_spatial` with uneven shards; `shard_bounds`
  as `torch.tensor_split` splits.
- The W-sharded VAE is in tests/test_torch_spatial_vae.py.
- The H-sharded pose guider (`process_pose(spatial=)`, R = 2 and 4) and its
  gradients against JAX's `process_pose` under `jax.grad`, fp32: 1e-5.
- `TrainMeshPlan.put_batch`'s pose rule against JAX's
  (tests/test_train_cli_mesh.py:41): H shards over sp where both rules
  take it, stays whole where neither does, and H % sp == 0 but
  H % (4 sp) != 0 is JAX-sharded and port-whole (ROADMAP C, "Handled").
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnihuman_tpu.configs.wan import WanModelConfig as JaxWanCfg
from omnihuman_tpu.omni.model import OmniModelConfig as JaxOmniCfg
from omnihuman_tpu.omni.model import init_omni_model
from omnihuman_tpu.omni.model import process_pose as jax_process_pose
from omnihuman_tpu_torch.configs.wan import WanModelConfig
from omnihuman_tpu_torch.omni.model import (
    OmniModelConfig, build_omni_model, process_pose)
from omnihuman_tpu_torch.parallel.spatial import (
    VirtualRanks, gather_spatial, halo_exchange, shard_bounds)
from omnihuman_tpu_torch.parallel.train_mesh import TrainMeshPlan
from omnihuman_tpu_torch.utils.convert import omni_state_dict_from_jax

torch.set_num_threads(1)

OBASE = dict(dim=32, ffn_dim=64, num_heads=4, num_layers=1, freq_dim=16,
             text_dim=24, text_len=8)
JOCFG = JaxOmniCfg(base=JaxWanCfg(**OBASE), audio_dim=20, num_keypoints=8,
                   num_frames=8)
POCFG = OmniModelConfig(base=WanModelConfig(**OBASE), audio_dim=20,
                        num_keypoints=8, num_frames=8)
POSE = (2, 8, 2, 16, 8)            # [B, K, F, H, W]: H = 16 = 4 x 4 ranks


def _t(a):
    return torch.from_numpy(np.array(a))


def _compiled(fn, *args):
    """fn(*args) as one program compiled without XLA's costly passes."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def test_shard_bounds_split_as_tensor_split():
    for width, parts in ((16, 2), (16, 8), (10, 4), (13, 8), (104, 8),
                         (5, 5)):
        bounds = shard_bounds(width, parts)
        sizes = [t.shape[0] for t in torch.tensor_split(torch.arange(width),
                                                        parts)]
        assert [e - s for s, e in bounds] == sizes
        assert bounds[0][0] == 0 and bounds[-1][1] == width
    with pytest.raises(ValueError):
        shard_bounds(3, 4)


@pytest.mark.parametrize("lo,hi", [(1, 1), (0, 1), (1, 0), (2, 1)])
@pytest.mark.parametrize("ranks", [3, 4])
def test_halo_exchange_forward_and_backward(lo, hi, ranks):
    """Each rank's halo-extended shard is its window of the zero-padded
    whole tensor; the gradient of a loss over every rank's extended shard
    reaches each slice's owner, summed."""
    g = torch.Generator().manual_seed(ranks * 10 + lo)
    x = torch.randn(2, 3, 2, 4, 11, generator=g)
    weights = [torch.randn(2, 3, 2, 4, e - s + lo + hi, generator=g)
               for s, e in shard_bounds(11, ranks)]
    bounds = shard_bounds(11, ranks)
    xp = torch.nn.functional.pad(x, (lo, hi))
    leaf = x.clone().requires_grad_(True)
    got = VirtualRanks(ranks).run(
        lambda grp, s, e: halo_exchange(leaf[..., s:e], 4, lo, hi, grp),
        bounds)
    for (s, e), y in zip(bounds, got):
        torch.testing.assert_close(y, xp[..., s:e + lo + hi], rtol=0,
                                   atol=0)
    sum((y * w).sum() for y, w in zip(got, weights)).backward()
    ref = x.clone().requires_grad_(True)
    refp = torch.nn.functional.pad(ref, (lo, hi))
    sum((refp[..., s:e + lo + hi] * w).sum()
        for (s, e), w in zip(bounds, weights)).backward()
    torch.testing.assert_close(leaf.grad, ref.grad, rtol=1e-6, atol=1e-6)


def test_gather_spatial_uneven_shards_and_cl_layout():
    x = torch.randn(1, 16, 2, 3, 10).contiguous(
        memory_format=torch.channels_last_3d)
    bounds = shard_bounds(10, 4)
    sizes = [e - s for s, e in bounds]
    got = VirtualRanks(4).run(
        lambda grp, s, e: gather_spatial(x[..., s:e], 4, grp, sizes), bounds)
    for y in got:
        torch.testing.assert_close(y, x, rtol=0, atol=0)
    ext = VirtualRanks(4).run(
        lambda grp, s, e: halo_exchange(x[..., s:e], 4, 1, 1, grp), bounds)
    assert all(y.is_contiguous(memory_format=torch.channels_last_3d)
               for y in ext)
    assert (ext[0][..., 0] == 0).all() and (ext[-1][..., -1] == 0).all()


# ---------------------------------------------------------------------------
# the H-sharded pose guider


@pytest.fixture(scope="module")
def guider():
    params = jax.tree.map(np.asarray, _compiled(
        lambda k: init_omni_model(k, JOCFG), jax.random.key(0)))
    rng = np.random.default_rng(3)
    cond = params["cond"]
    cond["pose_proj"]["w"] = (rng.normal(size=cond["pose_proj"]["w"].shape)
                              * 0.2).astype(np.float32)
    model = build_omni_model(POCFG, "cpu", torch.float32, seed=None,
                             trainable=True)
    model.load_state_dict(omni_state_dict_from_jax(params, POCFG),
                          strict=True)
    pose = (rng.normal(size=POSE) * 0.5).astype(np.float32)
    tokens = POSE[2] * (POSE[3] // 4) * (POSE[4] // 4)
    weight = rng.normal(size=(POSE[0], tokens, 32)).astype(np.float32)

    def loss(c, p):
        out = jax_process_pose(c, p, JOCFG.base.patch_size)
        return jnp.sum(out * weight), out

    grads, out = _compiled(jax.grad(loss, has_aux=True),
                           jax.tree.map(jnp.asarray, cond), jnp.asarray(pose))
    return model, pose, weight, np.asarray(out), jax.tree.map(np.asarray,
                                                              grads)


@pytest.mark.parametrize("ranks", [2, 4])
def test_h_sharded_guider_matches_jax_with_gradients(guider, ranks):
    model, pose, weight, want, jgrads = guider
    cond = model.cond
    cond.zero_grad(set_to_none=True)
    rows = POSE[3] // ranks
    outs = VirtualRanks(ranks).run(
        lambda grp, r: process_pose(cond, _t(pose)[:, :, :, r * rows:
                                                   (r + 1) * rows],
                                    POCFG.base.patch_size, spatial=grp),
        [(r,) for r in range(ranks)])
    for y in outs:
        np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-5,
                                   rtol=1e-5)
    (outs[0] * _t(weight)).sum().backward()
    for i in (1, 2, 3):
        conv = getattr(cond, f"pose_conv{i}")
        jw = jgrads[f"pose_conv{i}"]
        np.testing.assert_allclose(
            conv.weight.grad.numpy(), np.transpose(jw["w"], (4, 3, 0, 1, 2)),
            atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(conv.bias.grad.numpy(), jw["b"],
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(cond.pose_proj.weight.grad.numpy(),
                               jgrads["pose_proj"]["w"].T, atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# put_batch's rule


class _Axis:
    """One axis of a stand-in mesh: its size and this rank's place."""

    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


@pytest.mark.parametrize("h,port_shards", [(8, True), (5, False),
                                           (4, False)])
def test_put_batch_pose_rule_against_jax(h, port_shards):
    from omnihuman_tpu.parallel.train_mesh import TrainMeshPlan as JaxPlan
    jplan = JaxPlan.from_sizes(fsdp_size=2, sp_size=2)
    pose = np.arange(2 * 8 * 1 * h * 4, dtype=np.float32).reshape(
        2, 8, 1, h, 4)
    frames = np.zeros((2, 4, 1, 4, 4), np.float32)
    jout = jplan.put_batch({"frames": frames, "pose": pose})
    jax_shards = "sp" in str(jout["pose"].sharding.spec)
    assert jax_shards == (h % 2 == 0)
    for sp_rank in (0, 1):
        mesh = {"data": _Axis(2, 1), "fsdp": _Axis(2, 0),
                "sp": _Axis(2, sp_rank)}
        plan = TrainMeshPlan(mesh, torch.device("cpu"))
        out = plan.put_batch({"frames": _t(frames), "pose": _t(pose)})
        assert out["frames"].shape[0] == 1
        want = pose[1:2]                      # data rank 1's sample
        if port_shards:
            rows = h // 2
            want = want[:, :, :, sp_rank * rows:(sp_rank + 1) * rows]
            assert out["pose_sharding"] is mesh["sp"]
        else:
            assert "pose_sharding" not in out
        np.testing.assert_array_equal(out["pose"].numpy(), want)
    assert dataclasses.is_dataclass(plan)
