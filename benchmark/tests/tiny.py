"""A cell made of files alone, at the port's `tiny-test` sizes, for the
CPU tests: `tiny_cell(tmp_path, ...)` writes its configuration, traffic
and limits under tmp_path and loads it through the harness."""

from __future__ import annotations

import dataclasses
import json
import os

from benchmark import harness

E2E = [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
        "source": "host_clock"},
       {"name": "step_s", "unit": "s", "better": "lower", "bound": 0.05,
        "source": "host_clock", "workloads": ["tiny.cfg-step"]},
       {"name": "peak_mem_gib", "unit": "GiB", "better": "lower",
        "bound": 0.05, "source": "host_clock"}]
PER_LAYER = [{"name": "mfu.step", "unit": "%", "better": "higher",
              "source": "device_trace", "layer": "device",
              "moves": "step_s", "workloads": ["tiny.cfg-step"]}]


def tiny_config(registry: str = "tiny-test") -> dict:
    from omnihuman_tpu_torch.configs import WAN_CONFIGS
    c = WAN_CONFIGS[registry]
    as_json = lambda x: json.loads(json.dumps(dataclasses.asdict(x)))
    return {"registry": registry, "precision": "fast",
            "model": as_json(c.model), "t5": as_json(c.t5),
            "vae": as_json(c.vae), "num_train_timesteps": 1000,
            "vae_stride": list(c.vae_stride)}


def tiny_cell(tmp, name="tiny.cfg-step", traffic=None, limits=None,
              config=None):
    """Write the files of one cell under tmp and load it by name."""
    traffic = traffic or {
        "driver": "cfg_step", "unit": "cfg_step", "size": [64, 64],
        "frame_num": 5, "cfg_mode": "fused", "solver": "unipc", "steps": 4,
        "shift": 5.0, "guide_scale": 5.0, "prompt_tokens": [3, 12],
        "check_last_forward": True}
    limits = limits or {"limits": {"dit_first": 0.05, "dit_last": 0.05,
                                   "guide_solver": 1e-5}}
    for sub, fname, data in (("benchmark/configs", "tiny.json",
                              config or tiny_config()),
                             ("traffic", "tiny-mix.json", traffic),
                             ("limits", name + ".json", limits)):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        with open(os.path.join(tmp, sub, fname), "w") as f:
            json.dump(data, f)
    bench = {"configs": [{"name": "tiny",
                          "file": "benchmark/configs/tiny.json"}],
             "workloads": [{"name": name, "config": "tiny",
                            "traffic": "tiny-mix", "chips": 1}],
             "end_to_end": E2E, "per_layer": PER_LAYER}
    return harness.load_cell(name, root=str(tmp), bench=bench,
                             files=str(tmp))
