"""The port's DiT parameter names and its state dict through JAX's
converter: the quick cases of tests/test_torch_wan_dit.py (whose helpers
they use), apart so that the forward comparisons there make a file of
few tests, which a `--dist loadfile` run schedules beside the longest
ones instead of before them."""

import jax
import numpy as np
import torch

from omnihuman_tpu.configs.wan import TINY_TEST as JAX_TINY
from omnihuman_tpu.utils.convert import convert_wan_dit
from omnihuman_tpu_torch.configs.wan import TINY_TEST
from omnihuman_tpu_torch.models.wan_dit import build_wan_model
from omnihuman_tpu_torch.utils.convert import wan_dit_state_dict_from_jax
# fixtures and helpers of the file these cases came from
from test_torch_wan_dit import _params


def test_state_dict_round_trips_through_jax_converter():
    params = _params(JAX_TINY.model)
    sd = wan_dit_state_dict_from_jax(params, TINY_TEST.model)
    back = convert_wan_dit({k: v.numpy() for k, v in sd.items()},
                           JAX_TINY.model)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_port_model_has_reference_parameter_names():
    model = build_wan_model(TINY_TEST.model, "cpu", torch.float32, seed=0)
    names = set(model.state_dict())
    for n in ("patch_embedding.weight", "text_embedding.0.weight",
              "text_embedding.2.bias", "time_embedding.0.weight",
              "time_projection.1.weight", "head.head.weight",
              "head.modulation", "blocks.1.self_attn.norm_q.weight",
              "blocks.1.cross_attn.o.bias", "blocks.1.norm3.weight",
              "blocks.1.ffn.2.weight", "blocks.1.modulation"):
        assert n in names, n
    assert model.state_dict()["blocks.0.modulation"].shape == (1, 6, 64)
    assert model.state_dict()["patch_embedding.weight"].shape == (
        64, 16, 1, 2, 2)
