"""Run one cell of BENCHMARK.json on the card this process starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Prints the card's name, count and power limit on one line, then, as the
last line of standard output, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1`
its per-layer metrics), `device`, with `--trace 1` a `breakdown`, and
last `checks`, each number compared beside its limit (also the last lines
of standard error). Exits non-zero, printing no result, without a CUDA
card or with fewer cards than the cell asks for, and when JAX or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout; no library
# that the port uses may load JAX by itself
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "benchmark_cache", sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
# tokenizer files are read from the local cache only, never fetched
os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"
# this file's folder holds modules named like standard ones (trace)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".")
                        != HERE]


def card_facts() -> str:
    """`name, power limit` of every card, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return "; ".join(out.splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {chips} CUDA card(s), this machine "
              f"has {n}; the benchmark never runs on the CPU",
              file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}, count {torch.cuda.device_count()}, "
          f"using {chips}; nvidia-smi: {card_facts()}; peaks: 989 TFLOP/s "
          f"bf16, 3.35 TB/s; torch {torch.__version__}", flush=True)

    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0))
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: the run loaded {bad}: nothing the benchmark runs may "
              "import JAX or the JAX package", file=sys.stderr)
        return 3
    rec = out.pop("record")
    print(f"window: {rec['units']} units in {rec['window_s']:.3f} s, "
          f"set-up {rec['setup_s']:.3f} s, check {rec['check_s']:.1f} s, "
          f"peak {rec['peak_bytes'] / 2 ** 30:.3f} GiB, stages "
          f"{json.dumps(rec['stages'])}", flush=True)
    out["device"] = {"platform": "gpu", "kind": kind, **out["device"]}
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
