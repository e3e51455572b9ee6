"""What the benchmark may load: never JAX or the JAX package (top-level
module names compared whole), and the reference nothing of the port."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_forbidden_names_are_compared_whole():
    mods = {"omnihuman_tpu_torch": 1, "omnihuman_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen.x": 1, "numpy": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"omnihuman_tpu.models": 1, "jaxlib.xla": 1, "jax": 1})
    assert harness.forbidden_modules(mods) == ["jax", "jaxlib",
                                               "omnihuman_tpu"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        tops = set(_imports(path))
        assert "omnihuman_tpu_torch" not in tops, path
        assert not tops & set(harness.FORBIDDEN), path


def test_no_benchmark_file_reads_the_old_benchmark():
    old = ("bench" + ".py", "BENCH" + "_", "BASELINE" + ".", "MULTICHIP")
    for path in _sources():
        if os.path.dirname(path) == os.path.join(BENCH, "tests"):
            continue
        with open(path) as f:
            text = f.read()
        assert not any(o in text for o in old), path


def test_importing_the_harness_and_port_loads_no_jax():
    """A fresh interpreter that loads the harness, every driver and the
    port's modules they use holds no forbidden module."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmark import harness; "
            "import benchmark.drivers.cfg_step, "
            "benchmark.drivers.one_step_request, "
            "benchmark.drivers.distill_step; "
            "import omnihuman_tpu_torch.pipelines.wan_inference, "
            "omnihuman_tpu_torch.pipelines.image2video, "
            "omnihuman_tpu_torch.apt.distill, "
            "omnihuman_tpu_torch.apt.generate, "
            "omnihuman_tpu_torch.ops.quant; "
            "print(harness.forbidden_modules())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    """No CUDA card: a non-zero exit and no result line, never a CPU run."""
    import torch
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "t2v-1.3B.cfg-step", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
