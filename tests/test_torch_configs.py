"""The port's registry against the JAX one, field for field, and the
port's import boundary: it imports neither JAX nor the JAX package, and
its entry points do not fall back to the CPU on their own."""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from omnihuman_tpu import configs as jax_configs
from omnihuman_tpu_torch import configs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(value):
    """Config values with dtypes reduced to their names."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, torch.dtype):
        return str(value).replace("torch.", "")
    if isinstance(value, type):        # jnp dtypes are scalar types
        return value.__name__
    return value


@pytest.mark.parametrize("name", sorted(jax_configs.WAN_CONFIGS))
def test_registry_entry_matches_jax(name):
    ours, theirs = configs.WAN_CONFIGS[name], jax_configs.WAN_CONFIGS[name]
    assert _plain(ours) == _plain(theirs)


def test_size_tables_match_jax():
    assert configs.SIZE_CONFIGS == jax_configs.SIZE_CONFIGS
    assert configs.SUPPORTED_SIZES == jax_configs.SUPPORTED_SIZES
    assert configs.MAX_AREA_CONFIGS == jax_configs.MAX_AREA_CONFIGS
    assert set(configs.WAN_CONFIGS) == set(jax_configs.WAN_CONFIGS)


def test_head_dim_128_test_config():
    m = configs.TINY_TEST_HD128.model
    assert (m.dim, m.num_heads, m.ffn_dim, m.num_layers, m.head_dim) == (
        256, 2, 512, 2, 128)
    assert (m.freq_dim, m.text_dim, m.text_len) == (32, 32, 16)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import omnihuman_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'omnihuman_tpu' or m.startswith('omnihuman_tpu.')]\n"
        "assert len(names) >= 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_pipeline_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V
    with pytest.raises(RuntimeError, match="CUDA"):
        WanT2V(configs.TINY_TEST)
