#!/usr/bin/env python3
"""Run some phases of a checkout's chip_smoke.py alone, on one GPU.

    python3 scripts/smoke_phases.py [--root DIR] PHASE [PHASE ...]

Builds the kernels (phase 2) of the checkout at DIR (default: this one),
then runs the named phases in order, each with fresh launch counts:
14 (i2v-14B request), 15 (one-step batch), 16 (OmniHuman request), 18
(OmniHuman training), 19 (`cli.generate --ckpt_dir`), 20 (f-distill), 21
(`cli.train_apt`), 22 (`cli.eval_ema`), 23 (the pose data plane and a
`--pose_video` request; on phase 16's pipeline when 16 is named too,
else on one built for it), 24 (`cli.evaluate`; with phase 23's keypoint
processor when 23 is named too), 25 (Qwen2.5-3B), 26 (the XLM-R text
tower), 27 (the exported CFG steps, on phase 5's pipeline built for it),
28 (`cli.generate --profile --use_prompt_extend`, anomaly_detection), 29
(the sequence-parallel per-rank programs, the one-rank NCCL mesh request
and the multi-card / gloo checks, on phase 5's pipeline built for it), 30
(the sequence-parallel backward programs and the one-rank mesh training
steps; the 81-frame step is logged without phase 10's time).
Phases 19-22 run after phase 8
(the checkpoint directory, teacher data and distill output they read). To compare two commits on one card, unpack the
other one (`git archive <commit> | tar -x -C DIR`) and run both in one
call, in turns (parent, change, change, parent). Exits nonzero where a
phase fails, as the smoke does.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("phases", nargs="+", type=int,
                   choices=(14, 15, 16, 18, 19, 20, 21, 22, 23, 24, 25, 26,
                            27, 28, 29, 30))
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    if os.path.dirname(os.path.abspath(cs.__file__)) != root:
        sys.exit(f"imported {cs.__file__}, not the smoke of {root}")
    card = cs.phase_card_facts()
    cs.phase_build()
    from omnihuman_tpu_torch.ops.flash_attention import (
        FLASH_BWD, FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    from omnihuman_tpu_torch.ops.vae_kernels import VAE_CONV, VAE_UPSAMPLE
    fwd = (FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    flash = fwd + (FLASH_BWD,)
    every = flash + (VAE_CONV, VAE_UPSAMPLE)
    held = {}      # phase 16's pipeline for 23, 23's processor for 24

    def omni():
        _, held["pipe"] = cs.phase_omni(every, fwd)

    def pose():
        _, held["proc"] = cs.phase_pose(every, fwd, card, held.pop("pipe",
                                                                    None))

    run = {14: lambda: cs.phase_i2v(every, fwd),
           15: lambda: cs.phase_one_step(every, fwd),
           16: omni,
           18: lambda: cs.phase_omni_train(every, flash),
           23: pose,
           24: lambda: cs.phase_eval(card, held.pop("proc", None)),
           25: cs.phase_qwen,
           26: cs.phase_xlmr,
           27: lambda: cs.phase_export(every, cs.t2v_pipe()),
           28: lambda: cs.phase_tools(every),
           29: lambda: cs.run_sp_phase(every, cs.t2v_pipe(), {}),
           30: lambda: cs.run_sp_train_phase(every, {})}
    import shutil
    for phase in [p for p in args.phases if p < 19 or p > 22]:
        t0 = time.perf_counter()
        try:
            run[phase]()
        finally:
            shutil.rmtree(cs.WORK, ignore_errors=True)
        if phase != 16 or 23 not in args.phases:
            held.pop("pipe", None)
        cs.log(f"phase {phase} of {root}: {time.perf_counter() - t0:.0f} s")
    later = [p for p in args.phases if 19 <= p <= 22]
    if later:
        t0 = time.perf_counter()
        try:
            _, npz = cs.phase_training_main_path(flash)
            cs.run_slice_10_phases(npz, every, {}, phases=later)
        finally:
            shutil.rmtree(cs.WORK, ignore_errors=True)
        cs.log(f"phases 8, {later} of {root}: "
               f"{time.perf_counter() - t0:.0f} s")


if __name__ == "__main__":
    main()
