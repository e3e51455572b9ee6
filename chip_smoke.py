#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py        # from the root of a checkout; needs one GPU

Phases (any failure stops the run with a nonzero exit):
  1. card facts: name and power limit (nvidia-smi), torch / CUDA / nvcc
     versions, whether triton imports;
  2. build every kernel in omnihuman_tpu_torch/csrc/ with nvcc (sm_90a),
     one nvcc per source, all in parallel;
  3. the attention forward K1 (flash_fwd.cu) against its plain PyTorch
     version on the card, in bf16, at the main path's shapes (flagship
     geometry: 480x832, 81 frames, 32,760 tokens padded to 32,768; text
     context trimmed to 128 / 512; the 257 image tokens of i2v; the omni
     path's packed self-attention at B=1 and 20,480 / 22,528 / 25,600
     tokens and its audio cross-attention to 13 latent frames): max abs
     error against the stated tolerance, kernel / plain / SDPA-yardstick
     times (CUDA events, warm, median of 7; the kernel also alone, on
     preallocated outputs, without its wrapper) and the bound; the training
     forward with the LSE at B=1 beside its plain version and the
     library's forward that also returns it; ptxas's registers, spills, shared memory and any wgmma
     serialization warning for K1;
  4. a small-input reference: the DiT forward, the VAE decode and an omni
     forward with every condition and motion tokens on the card against
     the same weights on the CPU (the CPU path is the one the test suite
     holds against the JAX package); the VAE is fp32 at 8 channels, which
     conv_impl "auto" sends to torch convs;
  5. the main path: `WanT2V` for t2v-1.3B at full width (dim 1536, 30
     layers, 12 heads, umT5-xxl), random bf16 weights from a seed,
     precision "fast", answers 2 requests through `generate()` at 480x832,
     cut to 17 frames (7,800 tokens padded to 8,192) and 4 UniPC steps.
     The head gets random weights (the reference zero-inits it, which
     would make every velocity 0). Launch counts are zeroed just before
     and read just after: every attention of the DiT must have gone
     through the kernel. Then one CFG step of that model at that geometry
     with attention through the kernel, held against the same step with
     attention through the plain version;
  6. one warm CFG step at the flagship geometry (latents [1,16,21,60,104]),
     timed, then once more under torch.profiler for its kernel-time split;
  7. the fused backward kernel (flash_bwd.cu, K2) and the forward's LSE
     against their plain versions, B=1, N=12, D=128, bf16, tolerance 2^-6
     of each gradient's own peak: (a) self-attention 32,768 tokens, k_len
     32,760; (b) cross-attention Lq=32,768, Lc=512, no lengths, and with
     k_lens (37, 512) at B=2; (c) Lk=257; (d) a k_len=0 row (gradients
     exactly 0); (e) ragged Lq=1000, Lk=777, causal, window and offsets;
     (f, g) the training CLIs' 1,560 tokens. Keys past k_len get exactly
     zero dK / dV. The kernel's ms alone and with its wrapper (delta, the
     fp32 dQ accumulator's zero-fill and cast), its five-product bound,
     plain ms, and the SDPA backward on the unmasked shape as a yardstick;
  8. the training main path at full width (t2v-1.3B, random weights from a
     seed with a random head, written as a reference `*.safetensors`
     checkpoint directory): `cli.teacher_data` writes 2 samples at 480x832
     (1,560 tokens), then `cli.train_distill` runs 1 epoch at batch 1 (2
     steps, per-block remat) with a checkpoint, which is restored and held
     bit-equal (parameters, EMA, AdamW state). Launch counts are zeroed
     before each CLI and read after it: every attention forward, recompute
     and backward went through K1 and K2 (one K2 launch per attention
     backward, 60 a step);
  9. one distill step at full width and 1,560 tokens, kernels against plain
     attention (relative L2 error of the loss and the gradients, tolerance
     5e-2), and the share of parameter elements one bf16 AdamW step
     changes;
 10. one timed distill step at 81 frames (32,760 tokens, per-block remat,
     batch 1) after one warm-up, its peak memory and a torch.profiler split;
 11. one APT D step and one APT G step at full width and 1,560 tokens: the
     losses, and the K2 launches (the G step's gradient flows through the
     discriminator's frozen backbone, so it launches K2; the D step's
     features are cut, so it does not);
 12. the VAE kernels (vae_conv.cu K3, vae_upsample.cu K4) against their
     plain versions at every distinct full-width shape of an 81-frame
     480x832 decode and encode (first-chunk T=1 shapes included), bf16,
     tolerance 2^-6 of the output's peak: kernel / plain / cuDNN-yardstick
     times (F.conv3d on the activated input for K3, F.conv2d on the
     upsampled input for K4) and the bound; K3's pre-pass timed alone
     beside the whole call, K4 also alone (`vae_upsample_launch` on a
     preallocated output), and ptxas's registers, spills and shared
     memory for K3's kernels, registers, spills and wgmma serialization
     remarks for K4's;
 13. the full-width VAE at 81 frames, 480x832: vae_decode and vae_encode
     through the kernels ("cuda") and through cuDNN ("torch"), relative L2
     between them, wall times, peak memory, and the launch counts, which
     must be 588 K3 / 63 K4 for the decode and 420 K3 for the encode;
 14. the i2v main path: `WanI2V` for i2v-14B at full width (dim 5120, 40
     layers, 40 heads, in_dim 36; CLIP ViT-H/14; umT5-xxl; Wan 2.1 VAE),
     random bf16 weights from a seed with a random head, one seeded
     480x832 image through `generate()`, cut to 17 frames and 3 steps:
     every DiT attention (self, text and image cross-attention) through
     K1, every resblock conv through K3 and every upsample through K4, at
     the counts the code implies; per-stage seconds;
 15. one-step: `SeaweedWanAPTGenerator` over t2v-1.3B, 2 prompts, 81
     frames, one batched forward and the batched decode through K3 / K4.

 16. OmniHuman: `cli.omni_inference.run` for t2v-1.3B at full width plus
     30 audio adapters and the condition encoders (audio_dim 1024, 308
     keypoints, 13 temporal rows), random bf16 weights from a seed with a
     random head, adapter `o` and `pose_proj` (zero in the reference init,
     which would make every condition a no-op), umT5-xxl and the Wan 2.1
     VAE; a seeded 480x832 reference image, a seeded 16 kHz waveform
     through the log-mel extractor and seeded keypoints as heatmaps at
     120x208; 13 latent frames a window, 24 in all (two windows, the
     second with 2 motion frames), 4 DPM++ steps, precision "fast". Packed
     lengths 21,840 -> 22,528 (window 1), 24,960 -> 25,600 (window 2),
     20,280 -> 20,480 (uncond). Launches must be 480 K1 long-K, 720 K1
     short-K, 692 K3 and 72 K4. Per-stage seconds and peak memory; one
     cond + uncond step at window 2's geometry, kernels against plain
     attention (relative L2, tolerance 5e-2); the Wav2Vec2 base extractor
     timed once on the same waveform;
 17. one CFG step of phase 5's model at precision "int8" against "fast"
     (relative L2, tolerance 1e-1), ms a step each, and the share of the
     int8 step's kernel time under aten::_int_mm (torch.profiler).

 18. OmniHuman training at full width: t2v-1.3B, 30 layers plus 30 audio
     adapters and the condition encoders (audio_dim 1024, 308 keypoints,
     13 temporal rows; fp32 parameters and AdamW moments, random from a
     seed with a random head, adapter `o` and `pose_proj`), umT5-xxl and
     the Wan 2.1 VAE (bf16, its encode through K3).
     (a) `cli.train_omni.run` on synthetic samples (seeded frames [3, 49,
     256, 256], log-mel audio [49, 1024], heatmaps [308, 49, 64, 64]) at
     configs/omni_config.yaml's geometry (256x256, 13 latent frames,
     3,328 video + 256 reference tokens = 3,584, batch 1, per-block remat)
     with two stages, text_reference_audio (1 step) and all_conditions (1
     step, audio and pose at 1.0), saving only at each stage's end; then
     `--resume` with the last stage at 2 steps, which must restore step 2
     bit-equal to what run 1 saved (params, AdamW mu, nu, count, step) and
     take exactly one step. Launch counts are zeroed before each run and
     read after it; a step must launch K1 long-K 60 times (30 self-
     attentions, forward + remat recompute), K1 short-K 120 (30 text + 30
     audio cross-attentions, forward + recompute), K2 90 (one backward a
     attention) and K3 280 (20 fused convs a chunk of the 13-chunk frame
     encode and the 1-frame reference encode), K4 0: run 1 twice that,
     the resumed run once. Each save's GB and seconds and the free disk
     are printed;
     (b) at (a)'s geometry, one loss + gradient with attention through the
     kernels and through the plain versions: loss and gradients within 5e-2
     relative (L2 for the gradients); then one timed step there (after a
     warm-up) and its profiled twin's kernel time;
     (c) one timed step at 480x832 (latents [1, 16, 13, 60, 104]: 20,280 +
     1,560 tokens -> 22,528; 49 audio keys) after one warm-up: seconds,
     peak memory, and a torch.profiler split (K1, K2, cuBLAS, the rest of
     the forward / backward, the optimizer); then K1 with the LSE and K2
     at the omni training shapes (self-attention 3,584 and 22,528 tokens,
     text cross-attention Lc 512 and audio cross-attention Lk 49 at Lq
     22,528, audio at Lq 3,584) against their plain versions, with SDPA's
     forward and backward on the unmasked shapes as yardsticks;
     (d) `cli.omni_inference.run --checkpoint` on (a)'s output (256x256,
     one window, 2 steps): a finite video that differs from the same run
     without `--checkpoint`.

Then, on phase 8's files (its dit/ directory, teacher npz and distill
output), after phase 11:
 19. `cli.generate --ckpt_dir` at t2v-1.3B: a random bf16 VAE written as
     Wan2.1_VAE.pth beside phase 8's DiT; a t2v request (17 frames at
     480x832, 4 steps) and a `--one_step` request with the distill EMA as
     `--generator_ckpt`: the loaded DiT bit-equal to the file / the EMA,
     the VAE to its file, a finite video, and the launches (120 / 120 K1,
     140 K3, 15 K4 a request; 30 / 30 K1 one-step);
 20. `cli.train_f_distill` at full width on phase 8's npz (batch 1, one
     epoch, a save a step): 120 / 120 K1 and 60 K2 a step (the teacher's
     cond and uncond as one batch-2 forward, the detached and the graded
     student forward and its recompute), finite losses, the density ratio
     in [0.01, 100], each save's GB and seconds; a resume from step 1;
     one step's loss and student gradients with the kernels against plain
     attention (relative, tolerance 5e-2); one timed step at 81 frames
     (32,760 tokens), its peak memory and a torch.profiler split;
 21. `cli.train_apt` at full width: the generator booted from the distill
     EMA, 2 image updates on phase 8's npz (1,560 tokens) and 1 video
     update on a 2-sample 81-frame npz made with the teacher's CFG
     (32,760 tokens); seconds per D / G update, peak memory, the saves,
     checkpoints [2, 3] with their exact metadata, 237 / 237 K1 and 114
     K2 an update; then a resume after the video final is deleted, which
     reruns the video phase;
 22. `cli.eval_ema` on phase 8's directory with the distill EMA, 2
     samples: finite PSNR / SSIM, two images written, 30 / 30 K1, 56 K3
     and 6 K4 (two 1-latent-frame decodes), the pass's seconds.

Then, right after phase 16 (before phase 17), on its pipeline:
 23. the pose data plane at full width: Sapiens-1b (dim 1536, 40 layers,
     24 heads, 1024x768, 308 keypoints; fp32, random from a seed with a
     positive final-layer bias, so that keypoint confidences clear
     gaussian_heatmaps' 0.1) written as a reference-named state-dict file
     and loaded by `SapiensKeypointProcessor(checkpoint_path=)` through
     `infer_sapiens_config`; the backbone's ms a crop at batch 1 and 8
     (CUDA events, median of 7) beside its fp32 bound, and peak memory;
     8 seeded 480x832 frames with two bright figures through detection,
     crop, heatmaps and UDP decode (ms a frame, backbone against the
     rest); the crop, blur and labelling on the card against the CPU, and
     Sapiens at 2 layers of the 1b width on the same weights (tolerance
     5e-3 of the peak, which allows TF32 convolutions);
     `cli.extract_feature.run` over the frames (images a second, files
     written) and a child's exception reaching the parent; then
     `pose_heatmaps_from_frames` at phase 16's geometry and one omni
     request with those heatmaps, whose launches must equal phase 16's;
 24. `cli.evaluate.main` on 2 real and 2 fake .npy clips (16 frames,
     256x256) with InceptionV3 (random), I3D kinetics-400 from a random
     piergiaj-named state dict (--i3d_weights) and --keypoints with phase
     23's processor: FID > 0, finite FVD, HKC / HKV in [0, 1], the JSON's
     feature-space tags, seconds by stage (features, sqrtm, keypoints);
     FID of identical sets < 1e-3, IS, Sync-C with the default towers;
     Inception and I3D features on the card against the CPU (relative L2,
     tolerance 5e-3).

Right after phase 6, on phase 5's pipeline:
 27. the serving-step export: the t2v-1.3B `fast` CFG step at the
     flagship geometry (latents [1,16,21,60,104], 32,768 tokens, ctx2
     [2, 512, 4096] bf16 untrimmed) exported with `torch.export`, saved,
     loaded, and run with phase 5's weights as its input against the eager
     `cfg_model_step` on the same inputs (bit-equal expected, else relative
     L2 under 1e-3): its K1 launches through the custom op (30 long-K, 30
     short-K), seconds to export, save and load, ms a step exported and
     eager (median of 3); then the i2v step at the i2v-14B width cut to 2
     layers (17 frames, 8,192 tokens) against eager, 2 + 4 K1 launches.

Then, at the end:
 25. Qwen2.5-3B (dim 2048, 36 layers, 16 / 2 heads, vocab 151,936, tied;
     3.09 B parameters): random bf16 weights from a seed written as an
     HF directory (`model.safetensors` and a `config.json` written here)
     and read by `load_qwen_checkpoint` (fp32 on the card, 12.4 GB); a
     right-padded batch of 2 prompts (256 and 200 tokens), greedy, 128 new
     tokens, the decode step replayed as a CUDA graph and run eagerly (the
     same tokens): prefill ms, ms a decode token each way against the
     weight-read bound, the device's kernel time a token and its busy
     share, peak memory; every generated
     token within 1e-4 of its row's logit range of the teacher-forced
     maximum; 2 layers of the width on the card against the CPU (fp32,
     logits within 1e-4 of the peak, 8 greedy tokens equal); the prompt
     expander's Qwen route on the card with a stub chat tokenizer;
 26. the XLM-R text tower at full width (24 layers, dim 1024, vocab
     250,002, 0.56 B parameters, fp32): 2 x 514 ids with padding, ms
     (median of 7) against the fp32 bound, peak memory; 2 layers of the
     width card vs CPU (relative L2 1e-5);
 28. `cli.generate --profile DIR --use_prompt_extend` at phase 5's
     geometry: the trace names K1's, K3's and K4's kernels, the template
     expander's prompt went in (no Qwen files here), the launches equal
     phase 19's (120 / 120 K1, 140 K3, 15 K4); `anomaly_detection` on the
     card passes K1 and raises at an injected NaN; `log_device_memory`
     reports the card.
Each of 25-28 logs its wall time.

Right after phase 27, on phase 5's pipeline:
 29. sequence-parallel serving. (a) The per-rank programs at flagship
     width on one card (B=2, N=12, D=128, bf16, 32,768 tokens, 32,760
     valid), for sp 2 and 4: every virtual rank's ring (`ring_forward_hop`:
     K1 with the LSE on each K / V shard in ring order, the fp32 LSE merge)
     concatenated against one K1 call over the whole (2^-6 of the peak),
     rank 0's hops timed as K1 and merge apart, against 1/sp of the whole
     call and the bound; every rank's Ulysses program (the port's
     all-to-all buffer layouts, emulated exchanges, `ulysses_local`: K1
     over all tokens at N/sp heads) and sp_cross (`sp_cross_local`: K1 at
     Lq/sp against 128 / 512 text keys) against the whole call, each timed
     beside its bound and the library's flash forward with the LSE. (b) A
     one-rank NCCL process group and
     `WanT2V(mesh=create_mesh(MeshConfig(1, 1, 1)))` on phase 5's weights
     (the ring and sp_cross at sp 1, FSDP2 over one rank on the DiT and
     umT5, umT5 resident): phase 5's first request as latents against
     phase 5's pipeline's (bit-equal expected, 1e-3 relative L2 allowed),
     launch counts zeroed before the request and read after its video's
     decode (120 K1 long-K, 120 short-K, K3 and K4 in the decode); a
     second mesh request timed, and one of each pipeline profiled (device time by kernel group, the mesh's
     largest extra kernels). (c) With two or more cards,
     `torchrun` runs this script's --sp-worker mode at sp min(4, cards)
     against (b)'s latents (5e-2 relative L2) and `cli.generate --sp_size`;
     with one card that is logged as not run, and two processes probe
     whether gloo carries CUDA tensors for batch_isend_irecv and
     all_to_all_single. The phase logs its wall time.
 30. sequence-parallel training (after phase 22). (a) The backward
     programs at flagship training width on one card (B=1, N=12, D=128,
     bf16, 32,768 tokens, 32,760 valid), for sp 2 and 4: every virtual
     rank's ring (the forward hops for the merged out / LSE, then
     `ring_backward_hop`: one K2 launch a hop with the global LSE and
     delta, dQ in one fp32 accumulator, dK / dV summed per chunk in fp32)
     concatenated against one K2 call over the whole (2^-6 of each
     gradient's peak), rank 0's hops timed against 1/sp of the whole call
     and the bound; every rank's Ulysses backward (K2 at N/sp heads over
     all tokens) and sp_cross backward (K2 at Lq/sp against 512 text
     keys, dK / dV summed over the ranks) held and timed the same way,
     each beside SDPA's backward at its shape. (b) A one-rank NCCL group
     and `TrainMeshPlan(create_mesh(MeshConfig(1, 1, 1)))`: two distill
     steps at t2v-1.3B width and 1,560 tokens and one OmniHuman step at
     3,584 tokens (1.3B width, fp32 parameters, every condition) against
     the same steps unsharded (loss and grad norm rtol 1e-3, gradients
     within 3x the relative L2 between two unsharded runs, which K2's
     run-dependent dQ sum order sets apart, equal launch counts; counts
     zeroed before the mesh steps and read after them); an 81-frame distill step on the mesh
     timed against phase 10's, with its peak memory; the mesh state saved
     and restored unsharded bit-equal. (c) With two or more cards,
     `torchrun` runs this script's --train-worker mode at sp 2 (fsdp 2 on
     four cards) against (b)'s losses (rtol 2e-2); with one card that is
     logged as not run. The phase logs its wall time.

Right after phase 15, on its videos:
 31. the spatial halo exchange. (a) The W-sharded VAE on virtual ranks on
     one card (`parallel.spatial.VirtualRanks`: every rank's program on its
     own thread, halos cut from the neighbours' tensors): the 81-frame
     480x832 decode (latent [1, 16, 21, 60, 104]) at R = 2, 4, 8 and the
     encode of such a clip at R = 2, 4, every rank running K3 on each
     resblock conv and K4 on each upsample of its halo-extended shard
     (R x 588 K3 and R x 63 K4 a decode, R x 420 K3 an encode), the
     assembled output against the unsharded pass (bit-equal through every
     conv stage; the gathered attention rounds differently: relative L2
     under 1e-2, max abs under 2^-4 of the peak), each rank's program
     replayed alone from the recorded halos and timed against 1/R of the
     unsharded pass; K3 and K4 at each R's widest shard shapes against
     their plain versions beside their bounds. (b) A one-rank NCCL mesh:
     `SeaweedWanAPTGenerator` on phase 5's pipeline built on the mesh
     (the decode on the W-sharded path) on phase 15's prompts against
     phase 15's batch (relative L2 under 1e-3; 30 / 30 K1, 588 K3, 63 K4),
     and phase 30's omni training step with the pose guider on its
     H-sharded path against the whole heatmaps (within 3x the spread of
     two runs). (c) With two or more cards, `torchrun` runs this script's
     --spatial-worker mode: the decode W-sharded over every card through
     NCCL against one card's; with one card that is logged as not run.
     The phase logs its wall time.

Right after phase 12:
 32. block_norm (csrc/block_norm.cu, the DiT block's residual sites in one
     pass) against the eager chain it replaced, on the card, at every
     site form (A the block entry's modulated norm, B the gated add and
     the affine norm after the self-attention, C the add and the
     modulated norm after the cross-attention, the OmniHuman audio
     adapter's two, D the gated add after the FFN), 2 x 32,768 rows at
     dim 1536 and 5120, bf16 residual (and fp32 at B and D): x' bit-equal,
     h within one bf16 step (each element's magnitude floored at 2^-8 of
     its row's peak; the count over one step without the floor is
     printed), ms a call over 20 calls back to back as the DiT makes them
     (CUDA events, median of 7; one call alone with its wrapper's host
     time beside it) against the byte bound (each
     input and output once over 3.35 TB/s) and the eager ms; ptxas's
     registers and spills; the kernel's launches in a full-width
     t2v-1.3B DiT forward, 120 without the gradient, and 240 in a forward
     and backward with it and per-block remat (the recompute launches it
     again; the op's backward is the eager chain). block_norm is counted
     with the other kernels on every path below; a path that launched K1
     without it fails the smoke.
 33. qk_norm_rope (csrc/qk_norm_rope.cu, the attention's q / k RMSNorm
     and 3D RoPE in one pass) against the eager chain it replaced
     (`rms_norm` then `apply_rope`), on the card, at dim 1536 and 5120, 2
     x 32,768 rows: the self-attention's q and k with the flagship's
     tables (bf16 and fp32 rows) and the cross-attention's q with a
     512-row text k; the rotation bit-equal to `apply_rope` of the
     kernel's own norm, every element within two bf16 steps of its pair's
     magnitude of the eager chain (the count of elements apart printed);
     ms a call back to back and alone, as in phase 32, against the byte
     bound and the eager ms; ptxas's registers and spills; the launches
     in a full-width t2v-1.3B DiT forward, 60 without the gradient and
     120 in a forward and backward with per-block remat. Counted on every
     path below as block_norm is; a path that launched K1 without it
     fails the smoke.

The line before last is a JSON object {"kernels": [...]}; its
`launches_by_path` holds each path's launches (phase 19's t2v request,
20's and 21's first CLI runs, 22's pass, 23's `--pose_video` request,
27's exported flagship step ("export"), 28's profiled request
("profile"), 29's one-rank mesh request ("sp_serve"), 30's mesh
training steps ("sp_train"), 31's W-sharded passes ("vae_decode_w2" ...)
and mesh one-step batch ("spatial_one_step") among them), and K3's and
K4's `w_shard_rows` hold phase 31's shard shapes; block_norm's row (phase
32) and qk_norm_rope's (phase 33) hold each form's numbers and their
launches by path; the last
line is {"ok": true, "device": {...}}.

    torchrun --standalone --nproc_per_node N chip_smoke.py --sp-worker OUT
    torchrun --standalone --nproc_per_node N chip_smoke.py --train-worker OUT
    torchrun --standalone --nproc_per_node N chip_smoke.py --spatial-worker OUT

are phase 29 (c)'s worker (one rank of the mesh pipeline at sp N), phase
30 (c)'s (one rank of two mesh distill steps) and phase 31 (c)'s (one
rank of the W-sharded decode).
"""

from __future__ import annotations

import copy
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "_dev", "chip_smoke_work")   # git-ignored scratch

PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
FLAGSHIP = dict(frames=81, size=(832, 480), tokens=32760, seq_len=32768)
SMOKE = dict(frames=17, size=(832, 480), steps=4, requests=(
    ("a red fox running through fresh snow at sunrise, cinematic", 11),
    ("two astronauts playing chess on the moon, wide shot", 23)))
NUM_LAYERS = 30


def log(msg: str) -> None:
    print(msg, flush=True)


def timed_phase(tag, fn, *args, **kw):
    """fn(*args, **kw), its wall time logged under [tag]."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    log(f"[{tag}] phase wall time {time.perf_counter() - t0:.1f} s")
    return out


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bench_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def attention_bound(b, lq, n, d, k_valid):
    """Least time the card could take: Q read and O written once, the valid
    K/V rows read once; 4*Lq*D FLOP per (query, valid key, head)."""
    keys = sum(k_valid)
    flops = 4.0 * n * lq * d * keys
    nbytes = 2.0 * (2 * b * lq * n * d + 2 * keys * n * d)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_card_facts():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    from omnihuman_tpu_torch.ops import cuda_build
    nvcc = subprocess.run([cuda_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "not importable"
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}, triton {triton_v}, "
        f"python {sys.version.split()[0]}")
    log(f"[1] device: {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from omnihuman_tpu_torch.ops import cuda_build
    sources = sorted(f for f in os.listdir(cuda_build.CSRC_DIR)
                     if f.endswith(".cu"))
    t0 = time.perf_counter()
    cuda_build.build(sources)
    log(f"[2] built {sources} in {time.perf_counter() - t0:.1f} s")
    for s in sources:
        for line in cuda_build.build_log(s).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2]   {s}: {line.strip()}")


def ptxas_facts(source: str, tag: str, name: str) -> None:
    """ptxas's report on a kernel's library: registers, spills and any
    wgmma serialization remark (C7512-C7514, C7517), then their counts."""
    from omnihuman_tpu_torch.ops import cuda_build
    spills, warnings = [], []
    for line in cuda_build.build_log(source).splitlines():
        if "entry function" in line:
            log(f"[{tag}] ptxas {line.split(chr(39))[1][:90]}")
        elif "registers" in line or "spill" in line or "C75" in line:
            log(f"[{tag}]   {line.strip()[:160]}")
        if "spill stores" in line and not line.strip().startswith("0 bytes"):
            spills.append(line.strip())
        if any(c in line for c in ("C7512", "C7513", "C7514", "C7517")):
            warnings.append(line.strip())
    log(f"[{tag}] {name} ptxas: {len(spills)} kernels with spills, "
        f"{len(warnings)} wgmma serialization warnings")


def k1_ptxas_facts():
    """ptxas's report on K1 (registers, spills, wgmma serialization) and
    the dynamic shared memory of its two configurations."""
    import ctypes
    from omnihuman_tpu_torch.ops import cuda_build
    from omnihuman_tpu_torch.ops.flash_attention import FLASH_FWD_LONG_K
    ptxas_facts(FLASH_FWD_LONG_K.source, "3", "K1")
    smem = cuda_build.load(FLASH_FWD_LONG_K.source).omni_flash_fwd_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    log("[3] K1 shared memory a block: " + ", ".join(
        f"D={d}: {smem(d, 32768)} B (Lk 32,768), {smem(d, 512)} B (Lk 512)"
        for d in (64, 128)))


def phase_kernels():
    """Returns {kernel name: measurement row} for the JSON line."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops.flash_attention import (
        _clamped_lens, flash_attention_cuda, flash_attention_plain,
        flash_fwd_launch)

    k1_ptxas_facts()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    n, d = 12, 128
    L = FLAGSHIP["seq_len"]

    def rnd(b, l):
        return torch.randn((b, l, n, d), generator=gen, device=dev
                           ).to(torch.bfloat16)

    q_big = rnd(2, L)
    cases = [
        # name, q, lk, k_lens, library mask expressible, JSON row
        ("a self-attention L=32768 k_len=32760", q_big, L, (32760, 32760),
         True, "long"),
        ("b1 cross-attention Lq=32768 Lc=128 k_lens=(37,512)", q_big, 128,
         (37, 512), True, "short"),
        ("b2 cross-attention Lq=32768 Lc=512 k_lens=(37,512)", q_big, 512,
         (37, 512), True, None),
        ("c Lq=32768 Lk=257 no k_lens", q_big, 257, None, True, None),
        ("d k_len=0 row Lq=4096 Lk=512 k_lens=(512,0)", rnd(2, 4096), 512,
         (512, 0), False, None),
        ("e ragged Lq=1000 Lk=777", rnd(2, 1000), 777, None, True, None),
        # the omni path (phase 16), B=1: packed self-attention of the
        # uncond pass and of windows 1 and 2, and the audio
        # cross-attention to a window's 13 latent frames
        ("g omni self B=1 L=20480 k_len=20280", rnd(1, 20480), 20480,
         (20280,), True, "omni_self_20480"),
        ("h omni self B=1 L=22528 k_len=21840", rnd(1, 22528), 22528,
         (21840,), True, "omni_self_22528"),
        ("i omni self B=1 L=25600 k_len=24960", rnd(1, 25600), 25600,
         (24960,), True, "omni_self_25600"),
        ("j omni audio cross B=1 Lq=25600 Lk=13", rnd(1, 25600), 13, None,
         True, "omni_audio"),
    ]
    rows = {}
    for name, q, lk, k_lens, lib_ok, row in cases:
        b, lq = q.shape[0], q.shape[1]
        k, v = rnd(b, lk), rnd(b, lk)
        kl = (None if k_lens is None else
              torch.tensor(k_lens, dtype=torch.int32, device=dev))
        got = flash_attention_cuda(q, k, v, k_lens=kl)
        torch.cuda.synchronize()
        want = flash_attention_plain(q, k, v, k_lens=kl)
        if not torch.isfinite(got.float()).all():
            fail(f"kernel output not finite in case {name}")
        err = (got.float() - want.float()).abs().max().item()
        # bf16 output: the two versions may round one ulp apart; 2^-6 of
        # the output's own peak is two ulps there
        tol = 2 ** -6 * want.float().abs().max().item()
        if err > tol:
            fail(f"kernel vs plain: max abs err {err} > {tol} in {name}")
        if k_lens is not None and 0 in k_lens:
            zero_row = got[list(k_lens).index(0)]
            if zero_row.abs().max().item() != 0.0:
                fail("a row with k_len=0 is not exactly 0")
        k_valid = [min(x, lk) for x in (k_lens or (lk,) * b)]
        bound, bound_by = attention_bound(b, lq, n, d, k_valid)
        ms = bench_ms(lambda: flash_attention_cuda(q, k, v, k_lens=kl))
        # the kernel alone, on preallocated outputs and clamped lengths
        out, klc = torch.empty_like(q), _clamped_lens(kl, b, lk, dev)
        kernel_ms = bench_ms(lambda: flash_fwd_launch(q, k, v, out, None,
                                                      klc))
        plain_ms = bench_ms(
            lambda: flash_attention_plain(q, k, v, k_lens=kl), reps=3,
            warmup=1)
        lib_ms = None
        if lib_ok:    # yardstick only: the port never calls SDPA
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if kl is not None:
                mask = (torch.arange(lk, device=dev)[None, :]
                        < kl.clamp(max=lk)[:, None])[:, None, None, :]
            lib_ms = bench_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
        log(f"[3] {name}: max_abs_err {err:.3g} (tol {tol:.3g}), kernel "
            f"{ms:.3f} ms ({kernel_ms:.3f} alone), bound {bound:.3f} ms "
            f"({bound_by}, {100 * bound / kernel_ms:.1f}% alone), plain "
            f"{plain_ms:.3f} ms, SDPA {lib_ms if lib_ms is None else round(lib_ms, 3)} ms")
        if row is not None:
            rows[row] = dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                             plain_ms=plain_ms, bound_ms=bound,
                             bound_by=bound_by, library_ms=lib_ms)
        del k, v, got, want, out
        torch.cuda.empty_cache()

    # the training forward: B=1 with the LSE, beside the library's forward
    # that also returns it (unmasked; a yardstick the port never calls)
    q, k, v = rnd(1, L), rnd(1, L), rnd(1, L)
    kl = torch.tensor([32760], dtype=torch.int32, device=dev)
    got, lse = flash_attention_cuda(q, k, v, k_lens=kl, return_lse=True)
    torch.cuda.synchronize()
    want, want_lse = flash_attention_plain(q, k, v, k_lens=kl,
                                           return_lse=True)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -6 * want.float().abs().max().item()
    lse_err = (lse - want_lse).abs().max().item()
    if err > tol or lse_err > 1e-3:
        fail(f"K1 with the LSE vs plain: err {err} (tol {tol}), LSE err "
             f"{lse_err} (tol 1e-3)")
    bound, bound_by = attention_bound(1, L, n, d, [32760])
    ms = bench_ms(lambda: flash_attention_cuda(q, k, v, k_lens=kl,
                                               return_lse=True))
    out, klc = torch.empty_like(q), _clamped_lens(kl, 1, L, dev)
    kernel_ms = bench_ms(lambda: flash_fwd_launch(q, k, v, out, lse, klc))
    plain_ms = bench_ms(lambda: flash_attention_plain(
        q, k, v, k_lens=kl, return_lse=True), reps=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    try:
        lib_ms = round(bench_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kt, vt)), 3)
    except (RuntimeError, AttributeError) as e:
        lib_ms = f"not measured ({e})"
    log(f"[3] f self-attention with the LSE B=1 L=32768 k_len=32760: "
        f"max_abs_err {err:.3g} (tol {tol:.3g}), LSE err {lse_err:.3g} (tol "
        f"1e-3), kernel {ms:.3f} ms ({kernel_ms:.3f} alone), bound "
        f"{bound:.3f} ms ({bound_by}, {100 * bound / kernel_ms:.1f}% alone), "
        f"plain {plain_ms:.3f} ms, library forward with LSE {lib_ms} ms")
    del q, k, v, got, want, lse, want_lse, out
    torch.cuda.empty_cache()
    return rows


def phase_small_reference():
    """The DiT forward and the VAE decode on the card vs the CPU, on the
    same small weights and inputs. The card runs attention in the kernel
    (bf16), the CPU in the plain version (the path the CPU tests hold
    against JAX). TF32 is off for the fp32 VAE comparison."""
    import torch
    from omnihuman_tpu_torch.configs.wan import TINY_TEST, TINY_TEST_HD128
    from omnihuman_tpu_torch.models.vae import build_vae, vae_decode
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TINY_TEST_HD128.model
    gen = torch.Generator().manual_seed(7)
    outs = {}
    for device in ("cpu", "cuda"):
        model = build_wan_model(cfg, "cpu", torch.bfloat16, seed=3)
        with torch.no_grad():
            model.head.head.weight.normal_(0.0, 0.05,
                                           generator=torch.Generator(
                                           ).manual_seed(5))
        model = model.to(device)
        gen.manual_seed(7)
        x = torch.randn((2, 16, 3, 8, 8), generator=gen)
        ctx = torch.randn((2, 16, 32), generator=gen)
        sin, cos = rope_angles_3d((3, 4, 4), cfg.head_dim, seq_len=64)
        with torch.inference_mode():
            v = model(x.to(device), torch.tensor([900.0, 300.0]).to(device),
                      ctx.to(device), seq_len=64, rope_sin=sin.to(device),
                      rope_cos=cos.to(device),
                      context_lens=torch.tensor([9, 4]).to(device))
        outs[device] = v.float().cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    if not torch.isfinite(outs["cuda"]).all() or err > 5e-2 * max(1.0, scale):
        fail(f"DiT forward on the card vs the CPU: max abs err {err} "
             f"(output scale {scale})")
    log(f"[4] DiT forward (head_dim 128, bf16) card vs CPU: max abs err "
        f"{err:.3g} on outputs up to {scale:.3g} (tol 5e-2 x scale)")

    vouts = {}
    z = torch.randn((1, 16, 3, 4, 6), generator=gen.manual_seed(9))
    for device in ("cpu", "cuda"):
        vae = build_vae(TINY_TEST.vae, "cpu", torch.float32, seed=4).to(device)
        with torch.inference_mode():   # fp32 at 8 channels: "auto" is torch
            vouts[device] = vae_decode(vae, z.to(device)).cpu()
    err = (vouts["cuda"] - vouts["cpu"]).abs().max().item()
    if err > 1e-3:
        fail(f"VAE decode on the card vs the CPU: max abs err {err}")
    log(f"[4] VAE decode (fp32, TF32 off) card vs CPU: max abs err "
        f"{err:.3g} (tol 1e-3)")
    omni_small_reference()


def omni_small_reference():
    """A small omni forward with every condition (audio, pose, reference,
    motion) on the card against the same bf16 weights on the CPU: head_dim
    128, random head, adapter `o` and `pose_proj`. TF32 is off (phase 4
    turns it off), so the fp32 pose guider is fp32 on both."""
    import torch
    from omnihuman_tpu_torch.configs.wan import DTypePolicy, WanModelConfig
    from omnihuman_tpu_torch.omni.model import (
        OmniModelConfig, build_omni_model, omni_model_forward)

    cfg = OmniModelConfig(
        base=WanModelConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=2,
                            freq_dim=32, text_dim=32, text_len=16),
        audio_dim=20, num_keypoints=8, num_frames=8)
    model = build_omni_model(cfg, "cpu", torch.bfloat16, seed=3)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for w in (model.base.head.head.weight, model.cond.pose_proj.weight,
                  *(b.audio_attn.o.weight for b in model.base.blocks)):
            w.normal_(0.0, 0.05, generator=gen)
    gen.manual_seed(11)
    inputs = dict(
        x=torch.randn((2, 16, 3, 8, 8), generator=gen),
        t=torch.tensor([900.0, 300.0]),
        context=torch.randn((2, 16, 32), generator=gen),
        audio=torch.randn((2, 3, 20), generator=gen),
        pose=torch.rand((2, 8, 3, 16, 16), generator=gen),
        ref_latent=torch.randn((2, 16, 1, 8, 8), generator=gen),
        motion_latent=torch.randn((2, 16, 2, 8, 8), generator=gen),
        context_lens=torch.tensor([9, 4]))
    outs = {}
    for device in ("cpu", "cuda"):
        m = model.to(device)
        with torch.inference_mode():
            outs[device] = omni_model_forward(
                m, **{k: v.to(device) for k, v in inputs.items()},
                policy=DTypePolicy(residual=torch.bfloat16)).float().cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    scale = outs["cpu"].abs().max().item()
    if not torch.isfinite(outs["cuda"]).all() or err > 5e-2 * max(1.0,
                                                                   scale):
        fail(f"omni forward on the card vs the CPU: max abs err {err} "
             f"(output scale {scale})")
    log(f"[4] omni forward (every condition + motion tokens, head_dim 128, "
        f"bf16, TF32 off) card vs CPU: max abs err {err:.3g} on outputs up "
        f"to {scale:.3g} (tol 5e-2 x max(1, scale))")


def _random_head(model, device="cuda"):
    """Unit-scale velocities instead of the reference init's all zeros."""
    import torch
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, model.cfg.dim ** -0.5,
            generator=torch.Generator(device=device).manual_seed(5))


def t2v_pipe(mesh=None, device="cuda"):
    """Phase 5's pipeline: WanT2V(t2v-1.3B, fast) with random bf16 weights
    from seed 0 and a random head; with `mesh`, the same weights on it
    (the head is drawn before FSDP2 shards the model)."""
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.pipelines.text2video import WanT2V

    class Pipe(WanT2V):
        def _build_model(self):
            model = super()._build_model()
            _random_head(model, self.device)
            return model

    return Pipe(T2V_1_3B, device=device, precision="fast", init_seed=0,
                mesh=mesh)


def phase_main_path(kernels):
    import torch

    t0 = time.perf_counter()
    pipe = t2v_pipe()
    torch.cuda.synchronize()
    log(f"[5] WanT2V(t2v-1.3B) built with random bf16 weights in "
        f"{time.perf_counter() - t0:.1f} s")
    w, h = SMOKE["size"]
    frames, steps = SMOKE["frames"], SMOKE["steps"]

    for kn in kernels:
        kn.launches = 0
    for prompt, seed in SMOKE["requests"]:
        t0 = time.perf_counter()
        video = pipe.generate(prompt, size=(w, h), frame_num=frames,
                              sampling_steps=steps, seed=seed)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        if tuple(video.shape) != (3, frames, h, w):
            fail(f"video shape {tuple(video.shape)} != {(3, frames, h, w)}")
        vf = video.float()
        if not torch.isfinite(vf).all():
            fail("video holds non-finite values")
        if vf.min().item() < -1.0 or vf.max().item() > 1.0:
            fail("video values outside [-1, 1]")
        if next(pipe._t5.parameters()).device.type != "cpu":
            fail("the text encoder stayed on the card after the request")
        t = pipe.timings
        log(f"[5] request seed={seed}: video {tuple(video.shape)} in "
            f"[{vf.min().item():.3f}, {vf.max().item():.3f}], std "
            f"{vf.std().item():.3f}; total {total:.2f} s: T5 load "
            f"{t.get('t5_load_s', 0):.2f} s, T5 encode "
            f"{t['t5_encode_s']:.2f} s, T5 unload {t['t5_unload_s']:.2f} s, "
            f"{steps} CFG steps "
            f"{t['denoise_s']:.2f} s ({t['denoise_s'] / steps * 1e3:.1f} "
            f"ms/step), VAE decode {t['vae_decode_s']:.2f} s")
    launches = [kn.launches for kn in kernels]
    want = NUM_LAYERS * steps * len(SMOKE["requests"])
    log(f"[5] kernel launches on the main path: "
        f"{dict(zip([kn.name for kn in kernels], launches))}, "
        f"expected {want} each (2 requests x {steps} steps x 30 layers, "
        f"cond+uncond in one batch)")
    if launches != [want] * len(kernels):
        fail("the main path did not send every attention through the kernel")
    n_tok = (frames - 1) // 4 + 1
    log(f"[5] latents [16,{n_tok},{h // 8},{w // 8}] -> "
        f"{n_tok * (h // 16) * (w // 16)} tokens, seq_len "
        f"{pipe.seq_len_for((16, n_tok, h // 8, w // 8))}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[5] peak device memory so far {peak:.1f} GiB")
    return pipe, launches


def phase_step_vs_plain(pipe):
    """One CFG step of the main path's model (full width, the smoke's
    geometry) with attention through the kernel, against the same step on
    the same weights and inputs with attention through the plain version.
    Its kernel launches come after the main path's counts were read."""
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.ops import attention
    from omnihuman_tpu_torch.ops.flash_attention import flash_attention_plain
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.pipelines.text2video import cfg_model_step

    dev = pipe.device
    lat = pipe.latent_shape(SMOKE["size"], SMOKE["frames"])
    seq_len = pipe.seq_len_for(lat)
    grid = tuple(n // p for n, p in zip(lat[1:], pipe.patch_size))
    gen = torch.Generator(device=dev).manual_seed(77)
    x = torch.randn((1,) + lat, generator=gen, device=dev)
    ctx2 = torch.randn((2, 128, 4096), generator=gen, device=dev)
    lens = torch.tensor([37, 12], dtype=torch.int32, device=dev)
    sin, cos = rope_angles_3d(grid, 128, seq_len=seq_len, device=dev)

    def step():
        with torch.inference_mode():
            return cfg_model_step(pipe.model, x, 900.0, ctx2, sin, cos, lens,
                                  policy=pipe.policy, seq_len=seq_len,
                                  guide_scale=5.0).float()

    got = step()
    with mock.patch.object(attention, "flash_fwd", flash_attention_plain):
        want = step()
    if not torch.isfinite(got).all():
        fail("full-width CFG step through the kernel is not finite")
    rel = ((got - want).norm() / want.norm()).item()
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"[5] full-width CFG step ({seq_len} tokens, bf16), kernel vs plain "
        f"attention: relative L2 error {rel:.3g} (tol 5e-2), max abs err "
        f"{err:.3g} on velocities up to {scale:.3g}, velocity std "
        f"{want.std().item():.3g}")
    if rel > 5e-2:
        fail(f"full-width CFG step: kernel vs plain relative error {rel}")


def phase_flagship_step(pipe):
    import torch
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.pipelines.text2video import cfg_model_step

    dev = pipe.device
    lat = pipe.latent_shape(FLAGSHIP["size"], FLAGSHIP["frames"])
    seq_len = pipe.seq_len_for(lat)
    if seq_len != FLAGSHIP["seq_len"] or lat != (16, 21, 60, 104):
        fail(f"flagship geometry {lat} / {seq_len} unexpected")
    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((1,) + lat, generator=gen, device=dev)
    ctx2 = torch.randn((2, 128, 4096), generator=gen, device=dev)
    lens = torch.tensor([37, 12], dtype=torch.int32, device=dev)
    sin, cos = rope_angles_3d((21, 30, 52), 128, seq_len=seq_len, device=dev)

    def step():
        with torch.inference_mode():
            return cfg_model_step(pipe.model, x, 900.0, ctx2, sin, cos, lens,
                                  policy=pipe.policy, seq_len=seq_len,
                                  guide_scale=5.0)

    v = step()
    torch.cuda.synchronize()
    if not torch.isfinite(v).all():
        fail("flagship CFG step output not finite")
    ms = bench_ms(step, reps=3, warmup=1)
    bound = NUM_LAYERS * attention_bound(2, seq_len, 12, 128,
                                         [FLAGSHIP["tokens"]] * 2)[0]
    log(f"[6] flagship CFG step (latents [1,16,21,60,104], "
        f"{FLAGSHIP['tokens']} tokens, seq_len {seq_len}, fused batch 2): "
        f"{ms:.1f} ms; self-attention bound alone {bound:.1f} ms "
        f"(30 layers); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")

    profile_split(step, "6")


def kernel_split(fn, cpu: bool = False):
    """(groups {name: ms}, total ms, kernel events) of the device kernels
    one run of `fn` launches (torch.profiler / CUPTI): K1, K2, cuBLAS and
    the rest. The host's ops are recorded only with `cpu` (their ranges,
    such as FSDP2's, then show with the device time under them): recording
    them costs a training step's profile tens of seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]
                 + ([ProfilerActivity.CPU] if cpu else [])) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    groups = {"K1 flash_fwd": 0.0, "K2 flash_bwd": 0.0, "cuBLAS GEMM": 0.0,
              "rest (elementwise, norms, optimizer, copies)": 0.0}
    for e in kernels:
        t, name = e.self_device_time_total / 1e3, e.key.lower()
        if "flash_fwd" in name:
            groups["K1 flash_fwd"] += t
        elif "flash_bwd" in name:
            groups["K2 flash_bwd"] += t
        elif any(x in name for x in ("gemm", "xmma", "cutlass", "cublas",
                                     "nvjet")):
            groups["cuBLAS GEMM"] += t
        else:
            groups["rest (elementwise, norms, optimizer, copies)"] += t
    return groups, sum(groups.values()), kernels


def profile_split(step, tag: str) -> None:
    """Where one run of `step` spends its device time, by kernel group,
    and the top kernels."""
    groups, total, kernels = kernel_split(step)
    if total == 0:
        log(f"[{tag}] profiler: no device time recorded")
        return
    log(f"[{tag}] profiled step: {total:.1f} ms of kernel time: " + ", ".join(
        f"{k} {v:.1f} ms ({100 * v / total:.1f}%)" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.1f} ms "
            f"x{e.count:<5d} {e.key[:90]}")


def backward_bound(q_rows, k_rows, pairs, n, d):
    """Least time of the attention backward: five matmuls (S and dP once,
    dV, dK, dQ) of 2*D FLOP per (query, visible key) pair and head; bytes:
    q, dO, k, v read once and dq, dk, dv written once (bf16), plus the fp32
    LSE and delta. Returns (ms, "operations" | "bytes")."""
    flops = 2.0 * 5 * n * d * pairs
    nbytes = 2.0 * n * d * (3 * q_rows + 4 * k_rows) + 8.0 * q_rows * n
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def visible_pairs(b, lq, lk, k_lens, mkw, dev):
    """(query, key) pairs the mask lets through, summed over the batch."""
    import torch
    from omnihuman_tpu_torch.ops.flash_attention import _index_mask
    pairs = 0
    ok = _index_mask(0, lq, lq, lk, mkw.get("causal", False),
                     mkw.get("window_size", (-1, -1)), mkw.get("offsets"),
                     dev)
    for i in range(b):
        kv = lk if k_lens is None else min(k_lens[i], lk)
        if ok is None:
            pairs += lq * kv
        else:
            pairs += int(ok[:, :kv].sum())
    return pairs


def backward_case(tag, name, b, lq, lk, k_lens, mkw, lib_ok, gen,
                  n=12, d=128):
    """K2 (and K1 with the LSE that feeds it) at one shape against the
    plain versions, then timed: the forward with the LSE (and the
    library's, unmasked), K2 alone on preallocated outputs and with its
    wrapper, the plain backward, SDPA's backward on the unmasked shape
    where `lib_ok`, and the five-product bound. Returns the row."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops.flash_attention import (
        _clamped_lens, bwd_delta, flash_attention_cuda, flash_attention_plain,
        flash_bwd_cuda, flash_bwd_launch, flash_bwd_plain)

    dev = torch.device("cuda")

    def rnd(rows):
        return torch.randn((b, rows, n, d), generator=gen, device=dev
                           ).to(torch.bfloat16)

    q, k, v, dout = rnd(lq), rnd(lk), rnd(lk), rnd(lq)
    kl = (None if k_lens is None else
          torch.tensor(k_lens, dtype=torch.int32, device=dev))
    out, lse = flash_attention_cuda(q, k, v, k_lens=kl, return_lse=True,
                                    **mkw)
    torch.cuda.synchronize()
    want_out, want_lse = flash_attention_plain(q, k, v, k_lens=kl,
                                               return_lse=True, **mkw)
    if not torch.equal(out, flash_attention_cuda(q, k, v, k_lens=kl,
                                                 **mkw)):
        fail(f"forward with and without the LSE differ in {name}")
    lse_err = (lse - want_lse).abs().max().item()
    if lse_err > 1e-3:
        fail(f"LSE kernel vs plain: {lse_err} > 1e-3 in {name}")
    got = flash_bwd_cuda(q, k, v, out, lse, dout, k_lens=kl, **mkw)
    torch.cuda.synchronize()
    want = flash_bwd_plain(q, k, v, out, lse, dout, k_lens=kl, **mkw)
    errs = []
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(a.float()).all():
            fail(f"{gname} not finite in {name}")
        err = (a.float() - w.float()).abs().max().item()
        tol = 2 ** -6 * w.float().abs().max().item()
        if err > tol:
            fail(f"{gname} kernel vs plain: {err} > {tol} in {name}")
        errs.append((gname, err, tol))
    if k_lens is not None:
        for i, kv in enumerate(k_lens):
            if kv == 0 and any(x[i].abs().max().item() != 0.0
                               for x in got):
                fail("a row with k_len=0 has a nonzero gradient")
            if kv < lk and (got[1][i, kv:].abs().max().item() != 0.0
                            or got[2][i, kv:].abs().max().item() != 0.0):
                fail(f"keys past k_len have nonzero dK / dV in {name}")
    # the kernel alone on preallocated outputs, then the whole wrapper
    klc = _clamped_lens(kl, b, lk, dev)
    delta = bwd_delta(out, dout)
    mask = dict(softmax_scale=None, **mkw)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    dk_buf, dv_buf = torch.empty_like(k), torch.empty_like(v)
    kernel_ms = bench_ms(lambda: flash_bwd_launch(
        q, k, v, dout, lse, delta, klc, dq_acc, dk_buf, dv_buf, **mask))
    bwd_ms = bench_ms(lambda: flash_bwd_cuda(
        q, k, v, out, lse, dout, k_lens=kl, **mkw))
    fwd_lse_ms = bench_ms(lambda: flash_attention_cuda(
        q, k, v, k_lens=kl, return_lse=True, **mkw))
    fwd_plain_ms = bench_ms(lambda: flash_attention_plain(
        q, k, v, k_lens=kl, return_lse=True, **mkw), reps=1, warmup=0)
    plain_ms = bench_ms(lambda: flash_bwd_plain(
        q, k, v, out, lse, dout, k_lens=kl, **mkw), reps=1, warmup=0)
    lib_ms = lse_lib_ms = None
    if lib_ok:   # yardstick only: the port never calls SDPA
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        # the library's forward that also returns the LSE (unmasked); a
        # yardstick only, so a missing private op is logged, not fatal
        try:
            lse_lib_ms = bench_ms(
                lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    qt.detach(), kt.detach(), vt.detach()))
        except (RuntimeError, AttributeError) as e:
            log(f"[{tag}] library forward with LSE not measured: {e}")
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        dt = dout.transpose(1, 2)
        lib_ms = bench_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dt, retain_graph=True))
        del qt, kt, vt, ot
    pairs = visible_pairs(b, lq, lk, k_lens, mkw, dev)
    bound, by = backward_bound(b * lq, b * lk, pairs, n, d)
    fwd_bound = ("n/a (masked)" if mkw else "%.3f ms, %s" % attention_bound(
        b, lq, n, d, [lk] * b if k_lens is None else
        [min(x, lk) for x in k_lens]))
    log(f"[{tag}] {name}: " + ", ".join(
        f"{g} err {e:.3g} (tol {t:.3g})" for g, e, t in errs)
        + f", LSE err {lse_err:.3g}; forward with LSE {fwd_lse_ms:.3f} "
        f"ms (bound {fwd_bound}; plain {fwd_plain_ms:.1f} ms; library "
        f"forward with LSE "
        f"{lse_lib_ms if lse_lib_ms is None else round(lse_lib_ms, 3)} "
        f"ms); K2 kernel {kernel_ms:.3f} ms, with its wrapper "
        f"{bwd_ms:.3f} ms (bound {bound:.3f}, {by}), plain backward "
        f"{plain_ms:.1f} ms, SDPA backward "
        f"{lib_ms if lib_ms is None else round(lib_ms, 3)} ms")
    del q, k, v, dout, out, lse, got, want, want_out, want_lse, delta
    del dq_acc, dk_buf, dv_buf
    torch.cuda.empty_cache()
    return dict(max_abs_err=max(e for _, e, _ in errs), ms=bwd_ms,
                kernel_ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def phase_backward_kernels():
    """Returns the measurement of K2's JSON row (case a)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4321)
    L = FLAGSHIP["seq_len"]
    cases = [
        # name, B, Lq, Lk, k_lens, mask kwargs, SDPA yardstick
        ("a self-attention L=32768 k_len=32760", 1, L, L, (32760,), {}, True),
        ("b1 cross-attention Lq=32768 Lc=512", 1, L, 512, None, {}, True),
        ("b2 cross-attention Lq=32768 Lc=512 k_lens=(37,512)", 2, L, 512,
         (37, 512), {}, False),
        ("c Lq=32768 Lk=257", 1, L, 257, None, {}, True),
        ("d k_len=0 row Lq=4096 Lk=512 k_lens=(512,0)", 2, 4096, 512,
         (512, 0), {}, False),
        ("e ragged Lq=1000 Lk=777 causal window offsets", 1, 1000, 777,
         None, dict(causal=True, window_size=(300, 20), offsets=(40, 7)),
         False),
        # the shapes the training CLIs run (1,560 tokens: ragged last tiles)
        ("f training self-attention Lq=Lk=1560", 1, 1560, 1560, None, {},
         True),
        ("g training cross-attention Lq=1560 Lc=512", 1, 1560, 512, None, {},
         True),
    ]
    rows = {}
    for case in cases:
        row = backward_case("7", *case, gen)
        if case[0].startswith("a "):
            rows["k2"] = row
    return rows


def same_tree(a, b, where: str) -> int:
    """Fail unless two state trees (dicts of tensors and values) are
    bit-equal, each tensor compared on a's device; returns the bytes of
    the tensors compared."""
    import torch
    if isinstance(a, dict):
        if set(a) != set(b):
            fail(f"restored keys differ at {where}")
        return sum(same_tree(a[k], b[k], f"{where}/{k}") for k in a)
    if isinstance(a, torch.Tensor):
        if a.dtype != b.dtype or not torch.equal(a, b.to(a.device)):
            fail(f"restored tensor differs at {where}")
        return a.numel() * a.element_size()
    if a != b:
        fail(f"restored value differs at {where}: {a} != {b}")
    return 0


def _count(kernels):
    return {kn.name: kn.launches for kn in kernels}


def _zero(kernels):
    for kn in kernels:
        kn.launches = 0


def _differ(counts, want):
    """Whether the launches of the kernels `want` names differ from it
    (block_norm's and qk_norm_rope's, beside them in `counts`, are
    checked in main)."""
    return any(counts.get(k) != v for k, v in want.items())


def phase_training_main_path(kernels):
    """teacher_data, then train_distill, through their CLI main()s; returns
    {path: {kernel: launches}}, the path of the teacher data and the DiT
    written as the checkpoint, frozen on the card: the one t2v-1.3B build
    that phases 9, 20 and 21 share (phase 9 trains a copy of it, 20 and 21
    read it as the teacher)."""
    import torch
    from safetensors.torch import save_file
    from omnihuman_tpu_torch.cli import teacher_data, train_distill
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager

    shutil.rmtree(WORK, ignore_errors=True)
    dit_dir = os.path.join(WORK, "dit")
    os.makedirs(dit_dir)
    t0 = time.perf_counter()
    model = build_wan_model(T2V_1_3B.model, "cuda", torch.bfloat16, seed=0)
    with torch.no_grad():    # the reference zero-inits the head: v = 0
        model.head.head.weight.normal_(
            0.0, T2V_1_3B.model.dim ** -0.5,
            generator=torch.Generator(device="cuda").manual_seed(5))
    save_file({k: v.cpu() for k, v in model.state_dict().items()},
              os.path.join(dit_dir, "diffusion_pytorch_model.safetensors"))
    log(f"[8] random t2v-1.3B DiT (seed 0, random head) written as a "
        f"reference checkpoint in {time.perf_counter() - t0:.1f} s")

    counts = {}
    _zero(kernels)
    t0 = time.perf_counter()
    data = teacher_data.main([
        "--task", "t2v-1.3B", "--num_samples", "2", "--size", "480*832",
        "--out_dir", WORK, "--checkpoint_dir", dit_dir])
    torch.cuda.synchronize()
    counts["teacher_data"] = _count(kernels)
    gc.collect()
    torch.cuda.empty_cache()
    vt = data["v_teacher"]
    log(f"[8] cli.teacher_data: 2 samples at 480x832 in "
        f"{time.perf_counter() - t0:.1f} s; v_teacher {vt.shape} std "
        f"{vt.std():.3g}; launches {counts['teacher_data']}")
    if not (vt.shape == (2, 16, 1, 60, 104) and abs(vt).max() > 0):
        fail("teacher data has the wrong shape or is all zeros")
    want = _want(kernels[:3], NUM_LAYERS, NUM_LAYERS)
    if _differ(counts["teacher_data"], want):
        fail(f"teacher_data launches {counts['teacher_data']}, want {want}")

    npz = os.path.join(WORK, "dummy_data_480x832.npz")
    out = os.path.join(WORK, "distill")
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    state, history = train_distill.main([
        "--task", "t2v-1.3B", "--data_path", npz, "--output_dir", out,
        "--num_epochs", "1", "--batch_size", "1",
        "--checkpoint_dir", dit_dir])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts["train_distill"] = _count(kernels)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for h in history:
        log(f"[8] distill step {h['step']}: loss {h['loss']:.6g}, grad norm "
            f"{h['grad_norm']:.6g}, {h['seconds']:.3f} s")
        if not (h["loss"] > 0 and h["grad_norm"] > 0):
            fail("a distill step has a zero or non-finite loss / gradient")
    steps = len(history)
    want = _want(kernels[:3], *[2 * NUM_LAYERS * steps] * 3)
    log(f"[8] cli.train_distill: {steps} steps in {total:.1f} s (with model "
        f"build and the checkpoint save), peak device memory {peak:.1f} GiB;"
        f" launches {counts['train_distill']}, expected {want} (per step: "
        f"30 layers x self + cross attention, K1 forward + remat recompute, "
        f"one K2 each)")
    if steps != 2 or _differ(counts["train_distill"], want):
        fail("the training path did not send every attention forward, "
             "recompute and backward through K1 and K2")

    t0 = time.perf_counter()
    mgr = CheckpointManager(out)
    if mgr.all_steps() != [2] or mgr.restore_metadata() != {"epoch": 0}:
        fail(f"checkpoint steps {mgr.all_steps()} / metadata unexpected")
    restored = mgr.restore()
    live = state.state_dict()
    n_bytes = same_tree(restored, live, "state")
    log(f"[8] checkpoint of step 2 ({n_bytes / 2 ** 30:.2f} GiB: bf16 "
        f"parameters, EMA, AdamW mu and nu) restored bit-equal in "
        f"{time.perf_counter() - t0:.1f} s")
    del state, restored, live
    gc.collect()
    torch.cuda.empty_cache()
    return counts, npz, model


def _param_grads(model, batch, seq_len, sin, cos, policy):
    import torch
    from omnihuman_tpu_torch.apt.distill import distill_loss, trainable_params
    params = list(trainable_params(model).values())
    loss = distill_loss(model, batch, seq_len=seq_len, rope_sin=sin,
                        rope_cos=cos, policy=policy, remat=True)
    return loss.detach(), torch.autograd.grad(loss, params)


def phase_distill_vs_plain(npz, kernels, dit):
    """One distill loss + gradient at full width, 1,560 tokens, with the
    kernels and with plain attention, on a trainable copy of phase 8's DiT
    (the checkpoint's weights); then the share of elements one AdamW step
    changes. Returns the model for the later phases."""
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.apt.distill import (
        distill_train_step, init_distill_state, make_optimizer,
        trainable_params)
    from omnihuman_tpu_torch.apt.generate import (
        create_dataloader, load_teacher_data)
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.ops import flash_attention as fa
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    cfg = T2V_1_3B
    model = copy.deepcopy(dit).train().requires_grad_(True)
    batch = next(create_dataloader(load_teacher_data(npz), batch_size=1,
                                   shuffle=False, device="cuda")())
    sin, cos = rope_angles_3d((1, 30, 52), 128, seq_len=1560, device="cuda")
    args = (batch, 1560, sin, cos, cfg.policy)
    _zero(kernels)
    loss_k, grads_k = _param_grads(model, *args)
    if not all(_count(kernels).values()):
        fail(f"the kernel pass missed a kernel: {_count(kernels)}")
    _zero(kernels)
    with mock.patch.object(fa, "flash_fwd", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_bwd", fa.flash_bwd_plain):
        loss_p, grads_p = _param_grads(model, *args)
    torch.cuda.synchronize()
    if any(_count(kernels).values()):
        fail(f"the plain pass launched kernels: {_count(kernels)}")
    num = sum((a.float() - b.float()).square().sum() for a, b in
              zip(grads_k, grads_p))
    den = sum(b.float().square().sum() for b in grads_p)
    rel_g = (num / den).sqrt().item()
    rel_l = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"[9] distill loss + gradients (t2v-1.3B, 1,560 tokens, bf16), "
        f"kernels vs plain attention: loss {loss_k.item():.6g} vs "
        f"{loss_p.item():.6g} (relative error {rel_l:.3g}, tol 5e-2), "
        f"gradients relative L2 error {rel_g:.3g} (tol 5e-2), gradient "
        f"norm {den.sqrt().item():.4g}")
    if not (rel_l <= 5e-2 and rel_g <= 5e-2):
        fail("distill step: kernels disagree with plain attention")
    del grads_k, grads_p

    opt = make_optimizer()
    state = init_distill_state(model, opt)
    before = {n: p.detach().clone() for n, p in
              trainable_params(model).items()}
    state, m = distill_train_step(state, batch, optimizer=opt, seq_len=1560,
                                  rope_sin=sin, rope_cos=cos,
                                  policy=cfg.policy)
    changed = sum(int((p != before[n]).sum()) for n, p in
                  trainable_params(model).items())
    total = sum(p.numel() for p in before.values())
    log(f"[9] one bf16 AdamW step (lr 5e-6): {changed} of {total} parameter "
        f"elements changed ({100.0 * changed / total:.4f}%); loss "
        f"{float(m['loss']):.6g}, grad norm {float(m['grad_norm']):.6g}")
    del before

    def timed_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = distill_train_step(state, batch, optimizer=opt, seq_len=1560,
                                  rope_sin=sin, rope_cos=cos,
                                  policy=cfg.policy)
        float(m["loss"])
        return time.perf_counter() - t0

    sec = timed_step()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        timed_step()
    kernel_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"[9] one distill step at 1,560 tokens (batch 1, per-block remat): "
        f"{sec:.3f} s; its profiled twin holds {kernel_ms:.1f} ms of kernel "
        f"time, {100.0 * kernel_ms / (sec * 1e3):.1f}% of the unprofiled "
        f"step: the rest is the host issuing work")
    return state, opt


def phase_flagship_distill_step(state, opt):
    """One distill step at 81 frames (32,760 tokens), per-block remat."""
    import torch
    from omnihuman_tpu_torch.apt.distill import distill_train_step
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    gen = torch.Generator(device="cuda").manual_seed(81)
    lat = (1, 16, 21, 60, 104)
    batch = {"noise": torch.randn(lat, generator=gen, device="cuda"),
             "context": torch.randn((1, 512, 4096), generator=gen,
                                    device="cuda"),
             "v_teacher": torch.randn(lat, generator=gen, device="cuda")}
    seq_len = FLAGSHIP["seq_len"]
    sin, cos = rope_angles_3d((21, 30, 52), 128, seq_len=seq_len,
                              device="cuda")

    def step():
        _, m = distill_train_step(state, batch, optimizer=opt,
                                  seq_len=seq_len, rope_sin=sin, rope_cos=cos,
                                  policy=T2V_1_3B.policy)
        return float(m["loss"])

    step()                                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    loss = step()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if loss != loss:
        fail("81-frame distill step loss is NaN")
    log(f"[10] distill step at 81 frames (latents [1,16,21,60,104], "
        f"{FLAGSHIP['tokens']} tokens, seq_len {seq_len}, per-block remat, "
        f"batch 1): {sec:.2f} s, loss {loss:.6g}, peak device memory "
        f"{peak:.1f} GiB ({held:.1f} held before the step, "
        f"{peak - held:.1f} its own)")

    profile_split(step, "10")
    return sec


def phase_apt_steps(state, npz, kernels):
    """One APT D step and one G step at full width, 1,560 tokens."""
    import torch
    from omnihuman_tpu_torch.apt import apt_trainer as tr
    from omnihuman_tpu_torch.apt.generate import (
        create_dataloader, load_teacher_data)
    from omnihuman_tpu_torch.apt.model import init_apt_discriminator
    from omnihuman_tpu_torch.configs import T2V_1_3B

    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    g_model = state.model
    disc = init_apt_discriminator(
        copy.deepcopy(g_model), generator=torch.Generator(
            device="cuda").manual_seed(11))
    apt_cfg = tr.SeaweedAPTConfig()
    apt = tr.init_apt_state(g_model, disc, apt_cfg.g_lr_image,
                            apt_cfg.d_lr_image)
    batch = next(create_dataloader(load_teacher_data(npz), batch_size=1,
                                   shuffle=False, device="cuda")())
    gen = torch.Generator().manual_seed(12)
    batch["real"] = torch.randn(batch["noise"].shape, generator=gen
                                ).to("cuda")
    sin, cos = rope_angles_3d((1, 30, 52), 128, seq_len=1560, device="cuda")
    kw = dict(apt_cfg=apt_cfg, video=False, seq_len=1560, rope_sin=sin,
              rope_cos=cos, policy=T2V_1_3B.policy)
    _zero(kernels)
    t0 = time.perf_counter()
    apt, dm = tr.apt_d_step(apt, batch, gen, d_optimizer=tr.make_d_optimizer(
        apt_cfg.d_lr_image, disc), **kw)
    d_loss = float(dm["d_loss"])
    d_sec = time.perf_counter() - t0
    d_counts = _count(kernels)
    _zero(kernels)
    t0 = time.perf_counter()
    apt, gm = tr.apt_g_step(apt, batch, gen, g_optimizer=tr.make_rmsprop(
        apt_cfg.g_lr_image), **kw)
    g_loss = float(gm["g_loss"])
    g_sec = time.perf_counter() - t0
    g_counts = _count(kernels)
    taps = disc.taps
    log(f"[11] APT D step: d_loss {d_loss:.6g}, r1 {float(dm['r1_loss']):.6g}"
        f", total {float(dm['d_total']):.6g}, {d_sec:.2f} s, launches "
        f"{d_counts} (generator and 3 discriminator forwards, no gradient "
        f"through the backbone)")
    log(f"[11] APT G step: g_loss {g_loss:.6g}, {g_sec:.2f} s, launches "
        f"{g_counts} (discriminator taps {taps}: its backward reaches blocks "
        f"0..{max(taps)})")
    for what, v in (("d", dm["d_total"]), ("g", gm["g_loss"])):
        if not torch.isfinite(v):
            fail(f"APT {what} loss not finite")
    k2 = [kn.name for kn in kernels if "bwd" in kn.name]
    if any(d_counts[k] for k in k2):
        fail("the D step launched the backward kernels through a cut")
    if not all(g_counts[k] > 0 for k in k2):
        fail("the G step did not launch the backward kernels")


# ---------------------------------------------------------------------------
# phases 12-15: the VAE kernels, the VAE at full width, i2v, one-step

# (T, H, W, Cin, Cout) of every distinct K3 call of an 81-frame 480x832
# decode (28 a latent frame) and encode (20 a chunk); the first chunk / step
# runs each resolution at T=1
K3_SHAPES = sorted({
    (1, 60, 104, 384, 384), (2, 120, 208, 192, 384), (2, 120, 208, 384, 384),
    (4, 240, 416, 192, 192), (4, 480, 832, 96, 96),        # decode steps
    (1, 120, 208, 192, 384), (1, 120, 208, 384, 384),
    (1, 240, 416, 192, 192), (1, 480, 832, 96, 96),        # decode first
    (4, 240, 416, 96, 192), (1, 240, 416, 96, 192)})       # encode extra
# (T, h, w, Cin, Cout) of the K4 calls (decode steps, then the first step)
K4_SHAPES = [(2, 60, 104, 384, 192), (4, 120, 208, 384, 192),
             (4, 240, 416, 192, 96), (1, 60, 104, 384, 192),
             (1, 120, 208, 384, 192), (1, 240, 416, 192, 96)]
K3_ROW, K4_ROW = (4, 480, 832, 96, 96), (4, 240, 416, 192, 96)
I2V = dict(frames=17, steps=3, size=(832, 480),
           prompt="a woman turns her head and smiles, soft window light",
           seed=31)
ONE_STEP = dict(frames=81, seed=5, prompts=(
    "a paper boat drifting down a rain-soaked street, close-up",
    "timelapse of clouds rolling over a mountain ridge at dusk"))


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _vae_rnd(seed):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return lambda *shape, scale=1.0: torch.randn(
        shape, generator=gen, device="cuda") * scale


def k3_case(t, h, w, cin, cout, tag="12", rnd=None):
    """K3 against its plain version at one shape (random bf16 inputs,
    tolerance 2^-6 of the output's peak), timed beside its pre-pass, the
    plain version, cuDNN's conv3d of the activated input and the bound;
    logged under `tag`. Returns the JSON row."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops import vae_kernels as vk
    cl = torch.channels_last_3d
    rnd = rnd or _vae_rnd(1212)
    res_on = cin == cout       # conv2 of an identity block
    x = rnd(1, cin, t, h, w).to(torch.bfloat16).contiguous(memory_format=cl)
    cache = rnd(1, cin, 2, h, w).to(torch.bfloat16).contiguous(
        memory_format=cl)
    gamma = rnd(cin, scale=0.2) + 1.0
    wt = rnd(3, 3, 3, cin, cout, scale=(27 * cin) ** -0.5)
    w2 = vk.pack_conv_weights(wt)
    wk = vk.conv_weights_kmajor(w2)    # made once a VAE pass
    bias = rnd(cout, scale=0.05)
    res = (rnd(1, cout, t, h, w).to(torch.bfloat16).contiguous(
        memory_format=cl) if res_on else None)
    got, cnew = vk.fused_act_causal_conv3d_cuda(x, cache, gamma, w2, bias,
                                                res, wk)
    torch.cuda.synchronize()
    want, cwant = vk.fused_act_causal_conv3d_plain(x, cache, gamma, w2,
                                                   bias, res)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -6 * want.float().abs().max().item()
    cerr = (cnew.float() - cwant.float()).abs().max().item()
    ctol = 2 ** -6 * cwant.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or err > tol or cerr > ctol:
        fail(f"K3 vs plain at {(t, h, w, cin, cout)}: output err {err} "
             f"(tol {tol}), cache err {cerr} (tol {ctol})")
    n_out, hw = t * h * w, h * w
    flops = 2.0 * 27 * cin * cout * n_out
    nbytes = 2.0 * (n_out * cin + 2 * 2 * hw * cin + 27 * cin * cout
                    + n_out * cout * (2 if res_on else 1)) \
        + 4.0 * (cin + cout)
    bound, by = _bound(flops, nbytes)
    ms = bench_ms(lambda: vk.fused_act_causal_conv3d_cuda(
        x, cache, gamma, w2, bias, res, wk))
    # the pre-pass alone (its plain version: act_cache_plain)
    pre_ms = bench_ms(lambda: vk.act_cache_cuda(x, cache, gamma))
    plain_ms = bench_ms(lambda: vk.fused_act_causal_conv3d_plain(
        x, cache, gamma, w2, bias, res), reps=3, warmup=1)
    # yardstick only: cuDNN's conv of the already-activated input
    xin = torch.cat([cache, vk.activate_plain(x, gamma)], dim=2
                    ).contiguous(memory_format=cl)
    wl = wt.permute(4, 3, 0, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=cl)
    bl = bias.to(torch.bfloat16)
    lib_ms = bench_ms(lambda: F.conv3d(xin, wl, bl, padding=(0, 1, 1)))
    log(f"[{tag}] K3 T={t} {h}x{w} {cin}->{cout}"
        f"{' +residual' if res_on else ''}: max_abs_err {err:.3g} (tol "
        f"{tol:.3g}), cache err {cerr:.3g}; kernel {ms:.3f} ms (pre-pass "
        f"{pre_ms:.3f}, conv {ms - pre_ms:.3f}), bound "
        f"{bound:.3f} ms ({by}, {100 * bound / ms:.1f}%), plain "
        f"{plain_ms:.3f} ms, cuDNN conv3d {lib_ms:.3f} ms")
    del x, cache, res, got, cnew, want, cwant, xin
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=lib_ms)


def k4_case(t, h, w, cin, cout, tag="12", rnd=None):
    """K4 against its plain version at one low-res shape, timed with its
    wrapper and alone beside the plain version, cuDNN's conv2d of the
    upsampled frames and the bound; logged under `tag`. Returns the JSON
    row."""
    import torch
    import torch.nn.functional as F
    from omnihuman_tpu_torch.ops import vae_kernels as vk
    cl = torch.channels_last_3d
    rnd = rnd or _vae_rnd(1212)
    x = rnd(1, cin, t, h, w).to(torch.bfloat16).contiguous(memory_format=cl)
    wt = rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5)
    w4 = vk.pack_upsample_weights(wt.to(torch.bfloat16))
    wk = vk.upsample_weights_kmajor(w4)    # made once a VAE pass
    bias = rnd(cout, scale=0.05)
    got = vk.fused_upsample_conv2d_cuda(x, w4, bias, wk)
    torch.cuda.synchronize()
    want = vk.fused_upsample_conv2d_plain(x, w4, bias)
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 ** -6 * want.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or err > tol:
        fail(f"K4 vs plain at {(t, h, w, cin, cout)}: err {err} > {tol}")
    n_in = t * h * w
    flops = 2.0 * 4 * 4 * cin * cout * n_in
    nbytes = 2.0 * (n_in * cin + 16 * cin * cout + 4 * n_in * cout) \
        + 4.0 * cout
    bound, by = _bound(flops, nbytes)
    ms = bench_ms(lambda: vk.fused_upsample_conv2d_cuda(x, w4, bias, wk))
    # the kernel alone, on a preallocated output
    out = torch.empty_like(got)
    kernel_ms = bench_ms(lambda: vk.vae_upsample_launch(x, wk, bias, out))
    plain_ms = bench_ms(lambda: vk.fused_upsample_conv2d_plain(
        x, w4, bias), reps=3, warmup=1)
    # yardstick only: cuDNN's 3x3 conv of the upsampled frames
    xu = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    xu = xu.transpose(1, 2).reshape(t, cin, 2 * h, 2 * w).contiguous(
        memory_format=torch.channels_last)
    wl = wt.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bl = bias.to(torch.bfloat16)
    lib_ms = bench_ms(lambda: F.conv2d(xu, wl, bl, padding=1))
    log(f"[{tag}] K4 T={t} {h}x{w} -> {2 * h}x{2 * w} {cin}->{cout}: "
        f"max_abs_err {err:.3g} (tol {tol:.3g}); kernel {ms:.3f} ms "
        f"({kernel_ms:.3f} alone), bound {bound:.3f} ms ({by}, "
        f"{100 * bound / kernel_ms:.1f}% alone), plain {plain_ms:.3f} "
        f"ms, cuDNN conv2d {lib_ms:.3f} ms")
    del x, got, want, xu, out
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, kernel_ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms)


def phase_vae_kernels():
    """K3 / K4 against their plain versions at the full-width shapes.
    Returns the JSON rows of the largest call of each."""
    from omnihuman_tpu_torch.ops import cuda_build
    from omnihuman_tpu_torch.ops import vae_kernels as vk

    rnd = _vae_rnd(1212)
    # ptxas of K3's kernels: registers, spills, shared memory
    for line in cuda_build.build_log(vk.VAE_CONV.source).splitlines():
        if "entry function" in line:
            log(f"[12] ptxas {line.split(chr(39))[1][:90]}")
        elif ("registers" in line or "spill" in line or "wgmma" in line
              or "arning" in line):
            log(f"[12]   {line.strip()}")
    rows = {}
    for shape in K3_SHAPES:
        row = k3_case(*shape, rnd=rnd)
        if shape == K3_ROW:
            rows["k3"] = row
    ptxas_facts(vk.VAE_UPSAMPLE.source, "12", "K4")
    for shape in K4_SHAPES:
        row = k4_case(*shape, rnd=rnd)
        if shape == K4_ROW:
            rows["k4"] = row
    return rows


def f_lat_of(run) -> int:
    return (run["frames"] - 1) // 4 + 1


def _timed(fn):
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, \
        torch.cuda.max_memory_allocated() / 2 ** 30


def phase_vae_full(vae_kernels):
    """vae_decode / vae_encode at 81 frames, 480x832, K3 / K4 against
    cuDNN. Returns {path: {kernel: launches}}."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.vae import build_vae, vae_decode, \
        vae_encode

    vae = build_vae(T2V_1_3B.vae, "cuda", torch.bfloat16, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(13)
    z = torch.randn((1, 16, 21, 60, 104), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    video = (torch.rand((1, 3, 81, 480, 832), generator=gen, device="cuda")
             * 2 - 1).to(torch.bfloat16)
    counts = {}
    for name, fn, inp, want in (
            ("decode", lambda x, impl: vae_decode(vae, x, clamp=False,
                                                  conv_impl=impl), z,
             [588, 63]),
            ("encode", lambda x, impl: vae_encode(vae, x, conv_impl=impl),
             video, [420, 0])):
        with torch.inference_mode():
            fn(inp, "cuda")                           # warm-up
            _zero(vae_kernels)
            got, sec, peak = _timed(lambda: fn(inp, "cuda"))
            counts[f"vae_{name}_81f"] = _count(vae_kernels)
            fn(inp, "torch")
            ref, sec_t, peak_t = _timed(lambda: fn(inp, "torch"))
        launches = list(counts[f"vae_{name}_81f"].values())
        rel = ((got.float() - ref.float()).norm() / ref.float().norm()).item()
        log(f"[13] vae_{name} 81 frames 480x832 (bf16, streaming): kernels "
            f"{sec:.3f} s, peak {peak:.2f} GiB; cuDNN {sec_t:.3f} s, peak "
            f"{peak_t:.2f} GiB; relative L2 kernels vs cuDNN {rel:.3g} (tol "
            f"5e-2); output {tuple(got.shape)}; launches "
            f"{counts[f'vae_{name}_81f']}, expected {want}")
        if not torch.isfinite(got.float()).all() or rel > 5e-2:
            fail(f"vae_{name}: kernels vs cuDNN relative L2 {rel}")
        if launches != want:
            fail(f"vae_{name}: launches {launches} != {want}")
        del got, ref
    del vae, z, video
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_i2v(kernels, flash_kernels):
    """WanI2V at i2v-14B full width: one request through generate()."""
    import torch
    from omnihuman_tpu_torch.configs import I2V_14B
    from omnihuman_tpu_torch.pipelines.image2video import WanI2V

    t0 = time.perf_counter()
    pipe = WanI2V(I2V_14B, device="cuda", precision="fast", init_seed=0)
    with torch.no_grad():    # unit-scale velocities instead of all zeros
        pipe.model.head.head.weight.normal_(
            0.0, I2V_14B.model.dim ** -0.5,
            generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"[14] WanI2V(i2v-14B) built with random weights in "
        f"{time.perf_counter() - t0:.1f} s: DiT {n_params / 1e9:.2f} B "
        f"parameters (bf16), CLIP ViT-H/14 fp32, VAE bf16")
    w, h = I2V["size"]
    gen = torch.Generator(device="cuda").manual_seed(17)
    img = torch.rand((3, h, w), generator=gen, device="cuda") * 2 - 1
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    video = pipe.generate(I2V["prompt"], img, max_area=h * w,
                          frame_num=I2V["frames"],
                          sampling_steps=I2V["steps"], seed=I2V["seed"])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _count(kernels)
    vf = video.float()
    tm = pipe.timings
    log(f"[14] i2v request: video {tuple(video.shape)} in "
        f"[{vf.min().item():.3f}, {vf.max().item():.3f}], std "
        f"{vf.std().item():.3f}; total {total:.2f} s: T5 load "
        f"{tm['t5_load_s']:.2f} s, T5 encode {tm['t5_encode_s']:.2f} s, T5 "
        f"unload {tm['t5_unload_s']:.2f} s, CLIP {tm['clip_s']:.3f} s, VAE "
        f"encode {tm['vae_encode_s']:.3f} s, denoise {tm['denoise_s']:.2f} s "
        f"({tm['denoise_s'] / I2V['steps']:.2f} s/step), VAE decode "
        f"{tm['vae_decode_s']:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    # the reference's latent size: max_area 480*832 at this aspect gives
    # sqrt(230400) = 479.99999999999994 in float64, so 58 latent rows
    lat_h, lat_w = pipe.latent_size_for((h, w), h * w)
    log(f"[14] latent {lat_h}x{lat_w} -> {lat_h * lat_w // 4 * f_lat_of(I2V)}"
        f" tokens, seq_len {pipe.seq_len_for((16, f_lat_of(I2V), lat_h, lat_w))}")
    if tuple(video.shape) != (3, I2V["frames"], 8 * lat_h, 8 * lat_w) or \
            not torch.isfinite(vf).all() or vf.abs().max().item() > 1.0:
        fail("the i2v video has the wrong shape or values")
    layers, steps = I2V_14B.model.num_layers, I2V["steps"]
    f_lat = f_lat_of(I2V)
    want = {flash_kernels[0].name: layers * steps,        # self-attention
            flash_kernels[1].name: 2 * layers * steps,    # text + image
            kernels[3].name: 20 * f_lat + 28 * f_lat,     # encode + decode
            kernels[4].name: 3 * f_lat}
    want = {kn.name: want.get(kn.name, 0) for kn in kernels[:5]}
    log(f"[14] launches {counts}, expected {want} ({layers} layers x {steps}"
        f" steps, CFG in one batch; {f_lat} encode chunks x 20 + {f_lat} "
        f"decode steps x 28 K3, x 3 K4)")
    if _differ(counts, want):
        fail("the i2v path did not send every attention through K1 and "
             "every VAE conv through K3 / K4")
    del pipe, video
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_one_step(kernels, flash_kernels):
    """SeaweedWanAPTGenerator: t2v-1.3B, 2 prompts x 81 frames, over phase
    5's pipeline. Returns (the counts, (the videos, the prompts' contexts
    and lengths) for phase 31 (b))."""
    import torch
    from omnihuman_tpu_torch.pipelines.wan_inference import (
        SeaweedWanAPTGenerator)

    pipe = t2v_pipe()
    gen = SeaweedWanAPTGenerator(pipe)
    w, h = FLAGSHIP["size"]
    pipe.t5                                       # built outside the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    videos = gen.generate_batch(list(ONE_STEP["prompts"]), size=(w, h),
                                frame_num=ONE_STEP["frames"],
                                seed=ONE_STEP["seed"])
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _count(kernels)
    vf = videos.float()
    tm = gen.timings
    log(f"[15] one-step, 2 prompts x {ONE_STEP['frames']} frames: videos "
        f"{tuple(videos.shape)}, std {vf.std().item():.3f}; total "
        f"{total:.2f} s: text encode {tm['text_encode_s']:.2f} s, DiT "
        f"{tm['dit_s']:.3f} s, VAE decode {tm['vae_decode_s']:.3f} s, "
        f"{tm['frames_per_sec']:.1f} frames/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    if tuple(videos.shape) != (2, 3, ONE_STEP["frames"], h, w) or \
            not torch.isfinite(vf).all():
        fail("the one-step videos have the wrong shape or values")
    f_lat = f_lat_of(ONE_STEP)
    want = {flash_kernels[0].name: NUM_LAYERS,
            flash_kernels[1].name: NUM_LAYERS,
            kernels[3].name: 28 * f_lat, kernels[4].name: 3 * f_lat}
    want = {kn.name: want.get(kn.name, 0) for kn in kernels[:5]}
    log(f"[15] launches {counts}, expected {want}")
    if _differ(counts, want):
        fail("the one-step path did not go through K1 and K3 / K4")
    # phase 31 (b)'s reference: these videos and the prompts' contexts
    ctx, lens = pipe.encode_text(list(ONE_STEP["prompts"]))
    del pipe, gen
    gc.collect()
    torch.cuda.empty_cache()
    return counts, (videos, ctx, lens)


# phases 16-17: OmniHuman serving and the int8 precision
OMNI = dict(argv=["--task", "t2v-1.3B", "--size", "832*480",
                  "--num_frames", "13", "--total_frames", "24",
                  "--motion_frames", "2", "--num_inference_steps", "4",
                  "--precision", "fast", "--seed", "7",
                  "--prompt", "a woman speaking to the camera, studio light"],
            size=(832, 480), f_win=13, f_total=24, motion=2, steps=4,
            audio_s=2.0, sr=16000)


def _omni_inputs(rng, h, w, f_total, num_keypoints):
    """A seeded reference image [h, w, 3] uint8, a 16 kHz waveform (tones
    under noise) and keypoints -> heatmaps [K, f_total, h/4, w/4]."""
    import numpy as np
    from omnihuman_tpu_torch.omni.dataset import generate_heatmaps
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = int(OMNI["audio_s"] * OMNI["sr"])
    tt = np.arange(n) / OMNI["sr"]
    wav = (0.3 * np.sin(2 * np.pi * 220 * tt) * np.sin(2 * np.pi * 3 * tt)
           + 0.05 * rng.normal(size=n)).astype(np.float32)
    kps = rng.uniform(0.0, 1.0, (f_total, num_keypoints, 3)).astype(
        np.float32)
    pose = np.stack([generate_heatmaps(k, (h // 4, w // 4)) for k in kps],
                    axis=1)
    return img, wav, pose


def _omni_pipeline(tag: str):
    """(args, pipe): phase 16's OmniHuman pipeline from OMNI's flags, with
    a random head, adapter `o` and `pose_proj` (seed 5)."""
    import torch
    from omnihuman_tpu_torch.cli.omni_inference import (
        build_parser, build_pipeline)
    args = build_parser().parse_args(OMNI["argv"])
    args.output = None                      # frames stay on the card
    t0 = time.perf_counter()
    pipe = build_pipeline(args)
    dim = pipe.config.model.dim
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():   # the reference zero-inits these: no-ops
        pipe.model.base.head.head.weight.normal_(0.0, dim ** -0.5,
                                                 generator=g)
        for w in (pipe.model.cond.pose_proj.weight,
                  *(b.audio_attn.o.weight for b in pipe.model.base.blocks)):
            w.normal_(0.0, 0.1 * dim ** -0.5, generator=g)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"[{tag}] OmniHuman(t2v-1.3B) built in "
        f"{time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f} B "
        f"parameters (bf16; 30 audio adapters, pose guider "
        f"308->128->256->384, temporal embedding 13 rows)")
    return args, pipe


def _omni_want(all_kernels, flash_kernels):
    """The launches of one omni request at OMNI's geometry."""
    layers, steps = NUM_LAYERS, OMNI["steps"]
    windows = -(-OMNI["f_total"] // OMNI["f_win"])
    f_lat = OMNI["f_total"]
    want = {flash_kernels[0].name: 2 * layers * steps * windows,
            flash_kernels[1].name: 3 * layers * steps * windows,
            all_kernels[3].name: 20 + 28 * f_lat,
            all_kernels[4].name: 3 * f_lat}
    return {kn.name: want.get(kn.name, 0) for kn in all_kernels[:5]}


def phase_omni(all_kernels, flash_kernels):
    """OmniHuman serving at full width through cli.omni_inference.run; then
    one cond + uncond step at window 2's geometry, kernels against plain
    attention, and the Wav2Vec2 base extractor timed once. Returns the
    request's launches and the pipeline (phase 23 drives it again)."""
    import numpy as np
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.cli.omni_inference import run
    from omnihuman_tpu_torch.models.vae import vae_encode
    from omnihuman_tpu_torch.ops import attention
    from omnihuman_tpu_torch.omni.model import omni_model_forward
    from omnihuman_tpu_torch.ops.flash_attention import flash_attention_plain
    from omnihuman_tpu_torch.pipelines.omni import _slice_frames

    args, pipe = _omni_pipeline("16")
    w_px, h_px = OMNI["size"]
    t0 = time.perf_counter()
    img, wav, pose = _omni_inputs(np.random.default_rng(21), h_px, w_px,
                                  OMNI["f_total"],
                                  pipe.omni_config.num_keypoints)
    log(f"[16] inputs: image {img.shape}, {wav.size} audio samples at "
        f"{OMNI['sr']} Hz, heatmaps {pose.shape} fp32 "
        f"({pose.nbytes / 2 ** 30:.2f} GiB) made in "
        f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    _zero(all_kernels)
    t0 = time.perf_counter()
    out = run(args, img, wav, OMNI["sr"], pose=pose, pipe=pipe)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _count(all_kernels)
    video, tm = out["video"], out["timings"]
    vf = video.float()
    n_px = 1 + 4 * (OMNI["f_total"] - 1)
    log(f"[16] omni request: video {tuple(video.shape)} in "
        f"[{vf.min().item():.3f}, {vf.max().item():.3f}], std "
        f"{vf.std().item():.3f}; total {total:.2f} s: T5 load "
        f"{tm['t5_load_s']:.2f} s, T5 encode {tm['t5_encode_s']:.2f} s, T5 "
        f"unload {tm['t5_unload_s']:.2f} s, audio features (log-mel) "
        f"{tm['audio_features_s']:.3f} s, reference encode "
        f"{tm['ref_encode_s']:.3f} s, windows "
        + ", ".join(f"{x:.2f}" for x in tm["windows_s"])
        + f" s ({OMNI['steps']} steps each), VAE decode "
        f"{tm['vae_decode_s']:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    if tuple(video.shape) != (3, n_px, h_px, w_px) or \
            not torch.isfinite(vf).all() or vf.abs().max().item() > 1.0:
        fail("the omni video has the wrong shape or values")
    layers, steps = NUM_LAYERS, OMNI["steps"]
    windows = -(-OMNI["f_total"] // OMNI["f_win"])
    f_lat = OMNI["f_total"]
    want = _omni_want(all_kernels, flash_kernels)
    log(f"[16] launches {counts}, expected {want} ({windows} windows x "
        f"{steps} steps x {layers} layers: cond + uncond self-attention "
        f"long, cond text + cond audio + uncond text short; K3 20 for the "
        f"1-frame reference encode + 28 x {f_lat} decode steps, K4 3 x "
        f"{f_lat})")
    if _differ(counts, want):
        fail("the omni path did not send every attention through K1 and "
             "every VAE conv through K3 / K4")

    # one cond + uncond step at window 2's geometry, kernels vs plain
    dev = pipe.device
    lat_h, lat_w = h_px // 8, w_px // 8
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.randn((1, 16, OMNI["f_win"], lat_h, lat_w), generator=gen,
                    device=dev)
    motion = torch.randn((1, 16, OMNI["motion"], lat_h, lat_w),
                         generator=gen, device=dev)
    ctx2 = torch.randn((2, 128, 4096), generator=gen, device=dev)
    with torch.inference_mode():
        ref_lat = vae_encode(pipe.vae, torch.from_numpy(
            img.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0
        ).to(dev)[None, :, None]).float()
    aud = torch.randn((1, OMNI["f_win"], 1024), generator=gen, device=dev)
    pz = _slice_frames(torch.from_numpy(pose).to(dev)[None], 2,
                       OMNI["f_win"], OMNI["f_win"])    # window 2's pose
    t = torch.tensor([900.0], device=dev)
    lens = (torch.tensor([37], device=dev), torch.tensor([12], device=dev))

    def step():
        with torch.inference_mode():
            v_c = omni_model_forward(
                pipe.model, x, t, ctx2[:1], audio=aud, pose=pz,
                ref_latent=ref_lat, motion_latent=motion,
                context_lens=lens[0], policy=pipe.policy)
            v_u = omni_model_forward(pipe.model, x, t, ctx2[1:],
                                     context_lens=lens[1],
                                     policy=pipe.policy)
            return v_u + 7.5 * (v_c - v_u)

    got = step()
    torch.cuda.synchronize()
    ms = bench_ms(step, reps=3, warmup=1)
    with mock.patch.object(attention, "flash_fwd", flash_attention_plain):
        want_v = step()
    rel = ((got - want_v).norm() / want_v.norm()).item()
    log(f"[16] window-2 CFG step (cond 24,960 tokens -> 25,600, uncond "
        f"20,280 -> 20,480): {ms:.1f} ms; kernel vs plain attention "
        f"relative L2 {rel:.3g} (tol 5e-2), velocity std "
        f"{want_v.std().item():.3g}")
    if not torch.isfinite(got).all() or rel > 5e-2:
        fail(f"omni step: kernel vs plain relative L2 {rel}")
    profile_split(step, "16")
    del got, want_v, x, pz, video, out
    gc.collect()
    torch.cuda.empty_cache()

    # the Wav2Vec2 base extractor (random weights) on the same waveform
    from omnihuman_tpu_torch.omni.wav2vec import Wav2Vec2AudioFeatures
    ext = Wav2Vec2AudioFeatures(preset="base", dim=1024, device="cuda")
    feats = ext(wav, OMNI["sr"], OMNI["f_total"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats = ext(wav, OMNI["sr"], OMNI["f_total"])
    torch.cuda.synchronize()
    log(f"[16] Wav2Vec2 base features {feats.shape} of {wav.size} samples: "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms warm (fp32, dense "
        f"attention); finite {bool(np.isfinite(feats).all())}")
    if not np.isfinite(feats).all():
        fail("Wav2Vec2 features not finite")
    del ext
    return counts, pipe


def phase_int8_step():
    """One CFG step of phase 5's WanT2V (t2v-1.3B, 17 frames at 480x832,
    random head) at precision int8 against fast, on the same weights."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.ops.quant import quantize_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.pipelines.text2video import (
        WanT2V, cfg_model_step)
    from torch.profiler import ProfilerActivity, profile

    pipe = WanT2V(T2V_1_3B, device="cuda", precision="fast", init_seed=0)
    with torch.no_grad():
        pipe.model.head.head.weight.normal_(
            0.0, T2V_1_3B.model.dim ** -0.5,
            generator=torch.Generator(device="cuda").manual_seed(5))
    q_model = quantize_wan_model(copy.deepcopy(pipe.model))
    lat = pipe.latent_shape(SMOKE["size"], SMOKE["frames"])
    seq_len = pipe.seq_len_for(lat)
    grid = tuple(n // p for n, p in zip(lat[1:], pipe.patch_size))
    gen = torch.Generator(device="cuda").manual_seed(77)
    x = torch.randn((1,) + lat, generator=gen, device="cuda")
    ctx2 = torch.randn((2, 128, 4096), generator=gen, device="cuda")
    lens = torch.tensor([37, 12], dtype=torch.int32, device="cuda")
    sin, cos = rope_angles_3d(grid, 128, seq_len=seq_len, device="cuda")

    def step(model):
        with torch.inference_mode():
            return cfg_model_step(model, x, 900.0, ctx2, sin, cos, lens,
                                  policy=pipe.policy, seq_len=seq_len,
                                  guide_scale=5.0).float()

    want, got = step(pipe.model), step(q_model)
    rel = ((got - want).norm() / want.norm()).item()
    fast_ms = bench_ms(lambda: step(pipe.model), reps=5, warmup=1)
    int8_ms = bench_ms(lambda: step(q_model), reps=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(q_model)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    total = sum(e.self_device_time_total for e in ev
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    int_mm = sum(e.device_time_total for e in ev
                 if e.key == "aten::_int_mm") / 1e3
    share = f"{100 * int_mm / total:.1f}%" if total else "not measured"
    log(f"[17] CFG step at {seq_len} tokens (fused batch 2), int8 vs fast: "
        f"relative L2 {rel:.3g} (tol 1e-1), fast {fast_ms:.1f} ms, int8 "
        f"{int8_ms:.1f} ms; profiled int8 step {total:.1f} ms of kernel "
        f"time, {int_mm:.1f} ms ({share}) under aten::_int_mm")
    if not torch.isfinite(got).all() or rel > 1e-1:
        fail(f"int8 step vs fast: relative L2 {rel}")
    del pipe, q_model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 18: OmniHuman training

OMNI_TRAIN = dict(task="t2v-1.3B", size=(256, 256), pixel_frames=49,
                  f_lat=13, heatmap=(64, 64), sr=16000,
                  big_lat=(1, 16, 13, 60, 104),
                  caption="a man talking to the camera, studio light")


def _omni_train_config(path, out_dir, last_steps):
    """configs/omni_config.yaml with two stages: the repo's
    text_reference_audio (1 step) and all_conditions (`last_steps`) with
    its audio and pose ratios at 1.0; checkpoint_interval stays 1000, so
    only the stage-final saves happen."""
    from omnihuman_tpu_torch.utils.config_io import load_yaml, save_snapshot
    cfg = load_yaml(os.path.join(HERE, "configs", "omni_config.yaml"))
    stages = {s["name"]: s for s in cfg["stages"]}
    last = dict(stages["all_conditions"], num_steps=last_steps)
    last["condition_ratios"] = dict(last["condition_ratios"], audio=1.0,
                                    pose=1.0)
    cfg["stages"] = [dict(stages["text_reference_audio"], num_steps=1), last]
    cfg["training"]["output_dir"] = out_dir
    cfg["training"]["log_interval"] = 1
    if cfg["training"]["checkpoint_interval"] <= last_steps:
        fail("the smoke's stages would save mid-stage")
    save_snapshot(cfg, os.path.dirname(path), os.path.basename(path))
    return path


def _omni_train_samples(stages, num_keypoints, audio_dim):
    """factory(stage) -> an endless iterator of one-sample batches, as
    OmniHumanDataset gives them for a 256x256 video with audio and
    keypoints: seeded frames [3, 49, 256, 256] in [-1, 1], the first frame
    as the reference, a seeded 16 kHz waveform through the log-mel
    extractor ([49, 1024], one row a pixel frame) when the stage's audio
    ratio is above 0, seeded keypoints as heatmaps [308, 49, 64, 64] when
    its pose ratio is."""
    import numpy as np
    from omnihuman_tpu_torch.omni.dataset import (
        AudioFeatureExtractor, generate_heatmaps)
    rng = np.random.default_rng(18)
    t_px, (h, w) = OMNI_TRAIN["pixel_frames"], OMNI_TRAIN["size"]
    n = int(t_px / 16.0 * OMNI_TRAIN["sr"])
    tt = np.arange(n) / OMNI_TRAIN["sr"]
    wav = (0.3 * np.sin(2 * np.pi * 180 * tt) * np.sin(2 * np.pi * 2 * tt)
           + 0.05 * rng.normal(size=n)).astype(np.float32)
    audio = AudioFeatureExtractor(dim=audio_dim)(wav, OMNI_TRAIN["sr"],
                                                 t_px)
    kps = rng.uniform(0.0, 1.0, (t_px, num_keypoints, 3)).astype(np.float32)
    pose = np.stack([generate_heatmaps(k, OMNI_TRAIN["heatmap"])
                     for k in kps], axis=1)

    def factory(stage_idx):
        ratios = stages[stage_idx].condition_ratios
        while True:
            frames = rng.uniform(-1.0, 1.0, (3, t_px, h, w)).astype(
                np.float32)
            cond = {"text": OMNI_TRAIN["caption"], "reference": frames[:, :1]}
            if ratios.get("audio", 0) > 0:
                cond["audio"] = audio
            if ratios.get("pose", 0) > 0:
                cond["pose"] = pose
            yield [{"frames": frames, "conditions": cond,
                    "metadata": {"start": 0}}]
    return factory, audio.shape, pose.shape


def _omni_step_launches(stage, layers):
    """K1 long-K / short-K and K2 launches of one omni training step with
    per-block remat: every attention runs K1 twice (forward, recompute)
    and K2 once; self-attention is long-K, the text (512 keys) and audio
    (49 keys, only when the batch carries audio) cross-attentions
    short-K."""
    n_cross = 1 + (stage.condition_ratios.get("audio", 0) > 0)
    return (2 * layers, 2 * layers * n_cross, layers * (1 + n_cross))


def _disk_free(path):
    return shutil.disk_usage(path).free / 1e9


def _gib_in_use():
    import torch
    return torch.cuda.memory_allocated() / 2 ** 30


def phase_omni_train(all_kernels, flash_kernels):
    """Phase 18 (a)-(d); returns the launches of (a)'s first run."""
    import numpy as np
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.cli import omni_inference, train_omni
    from omnihuman_tpu_torch.omni.trainer import (
        draw_step_inputs, omni_flow_matching_loss, omni_train_step)
    from omnihuman_tpu_torch.ops import flash_attention as fa

    work = os.path.join(WORK, "omni_train")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    out = os.path.join(work, "ckpt")
    base_argv = ["--task", OMNI_TRAIN["task"]]

    # (a) cli.train_omni.run: 2 stages x 1 step, then --resume
    args = train_omni.build_parser().parse_args(
        ["--config", _omni_train_config(os.path.join(work, "run1.yaml"),
                                        out, 1)] + base_argv)
    t0 = time.perf_counter()
    setup = train_omni.load_setup(args)
    model = setup.trainer.state.model
    dim = model.cfg.dim
    g = torch.Generator(device="cuda").manual_seed(5)
    with torch.no_grad():   # the reference zero-inits these: no-ops
        model.base.head.head.weight.normal_(0.0, dim ** -0.5, generator=g)
        for w in (model.cond.pose_proj.weight,
                  *(b.audio_attn.o.weight for b in model.base.blocks)):
            w.normal_(0.0, 0.1 * dim ** -0.5, generator=g)
    torch.cuda.synchronize()
    params = setup.trainer.state.params()
    n_params = sum(p.numel() for p in params.values())
    layers = model.cfg.base.num_layers
    log(f"[18] train setup (OmniModel t2v-1.3B, {layers} layers + audio "
        f"adapters, fp32 parameters and AdamW moments: {n_params / 1e9:.3f} "
        f"B parameters; umT5-xxl bf16; Wan 2.1 VAE bf16, conv_impl auto) "
        f"in {time.perf_counter() - t0:.1f} s; "
        f"{_disk_free(work):.0f} GB free on the disk")
    factory, a_shape, p_shape = _omni_train_samples(
        setup.stages, setup.ocfg.num_keypoints, setup.ocfg.audio_dim)
    log(f"[18] samples: frames (3, {OMNI_TRAIN['pixel_frames']}, 256, 256),"
        f" audio features {a_shape}, heatmaps {p_shape}; stages "
        + ", ".join(f"{s.name} x {s.num_steps} {s.condition_ratios}"
                    for s in setup.stages))

    def expected(stage_steps):
        want = {kn.name: 0 for kn in all_kernels[:5]}
        for stage, steps in stage_steps:
            for kn, n in zip(flash_kernels,
                             _omni_step_launches(stage, layers)):
                want[kn.name] += n * steps
            # K3: the 49-frame encode (13 chunks) and the reference, 20
            # fused convs a chunk; no decode, so no K4
            want[all_kernels[3].name] += 20 * (OMNI_TRAIN["f_lat"] + 1) \
                * steps
        return want

    torch.cuda.reset_peak_memory_stats()
    _zero(all_kernels)
    t0 = time.perf_counter()
    train_omni.run(args, factory, setup)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _count(all_kernels)
    want = expected([(s, s.num_steps) for s in setup.stages])
    saves = setup.trainer.saves
    log(f"[18] run 1: {setup.trainer.state.step} steps in {total:.1f} s "
        f"with {len(saves)} saves ("
        + ", ".join(f"step {r['step']}: {r['bytes'] / 1e9:.2f} GB in "
                    f"{r['seconds']:.1f} s" for r in saves)
        + f"); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; "
        f"{_disk_free(work):.0f} GB free; launches {counts}, expected {want}"
        f" (a step: {layers} layers x self + text + audio attention, K1 "
        f"forward + remat recompute, one K2 each; K3 20 x 14 encode "
        f"chunks)")
    if _differ(counts, want):
        fail("the omni training path did not send every attention "
             "forward, recompute and backward through K1 / K2 and every "
             "encoder conv through K3")
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
    mgr = CheckpointManager(out)
    if mgr.all_steps() != [1, 2] or mgr.restore_metadata(2) != {
            "stage": 1, "final": True}:
        fail(f"omni checkpoints {mgr.all_steps()} / metadata "
             f"{mgr.restore_metadata(2)} unexpected")
    ref_state = setup.trainer.state        # what step 2 saved, on the card
    del setup, model, params
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(os.path.join(out, "step_00000001"))   # no longer needed
    log(f"[18] {_gib_in_use():.1f} GiB in use with run 1's state kept")

    args2 = train_omni.build_parser().parse_args(
        ["--config", _omni_train_config(os.path.join(work, "run2.yaml"),
                                        out, 2), "--resume"] + base_argv)
    t0 = time.perf_counter()
    setup = train_omni.load_setup(args2)
    checked = []

    def resumed_factory(stage_idx):
        # train() calls this right after restoring step 2
        if not checked:
            t1 = time.perf_counter()
            checked.append(same_tree(setup.trainer.state.state_dict(),
                                     ref_state.state_dict(), "state"))
            log(f"[18] restored state of step 2 bit-equal to what was "
                f"saved: {checked[0] / 1e9:.2f} GB of params, mu and nu, "
                f"count and step ({time.perf_counter() - t1:.1f} s)")
        return factory(stage_idx)

    _zero(all_kernels)
    train_omni.run(args2, resumed_factory, setup)
    torch.cuda.synchronize()
    counts2 = _count(all_kernels)
    want2 = expected([(setup.stages[-1], 1)])
    saves = setup.trainer.saves
    log(f"[18] run 2 (--resume, last stage at 2 steps): to step "
        f"{setup.trainer.state.step} in {time.perf_counter() - t0:.1f} s "
        f"(setup, restore, one step, "
        + ", ".join(f"save of step {r['step']}: {r['bytes'] / 1e9:.2f} GB "
                    f"in {r['seconds']:.1f} s" for r in saves)
        + f"); launches {counts2}, expected {want2}")
    if not checked or setup.trainer.state.step != 3 or len(saves) != 1 \
            or _differ(counts2, want2):
        fail("the resumed run did not restore step 2 and take exactly "
             "one step")
    del ref_state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[18] {_gib_in_use():.1f} GiB in use after run 2")

    # (b) one step at (a)'s geometry, kernels against plain attention
    sample = next(factory(len(setup.stages) - 1))
    batch = train_omni.assemble_batch(sample, setup)
    setup.text_encoder = None         # umT5 is not needed past here
    gc.collect()
    torch.cuda.empty_cache()
    state, opt = setup.trainer.state, setup.trainer.optimizer
    all_on = {"audio": 1.0, "pose": 1.0, "reference": 1.0}
    gen = torch.Generator(device="cuda").manual_seed(180)
    masks, t, noise = draw_step_inputs(gen, batch["frames"].shape, all_on,
                                       "cuda")
    plist = list(state.params().values())

    def grads_of(b, nz):
        loss = omni_flow_matching_loss(state.model, b, masks, t, nz,
                                       policy=setup.policy, remat=True)
        return loss.detach(), torch.autograd.grad(
            loss, plist, allow_unused=True, materialize_grads=True)

    _zero(all_kernels)
    loss_k, grads_k = grads_of(batch, noise)
    if not all(_count(flash_kernels).values()):
        fail(f"the kernel pass missed a kernel: {_count(flash_kernels)}")
    _zero(all_kernels)
    with mock.patch.object(fa, "flash_fwd", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_bwd", fa.flash_bwd_plain):
        loss_p, grads_p = grads_of(batch, noise)
    torch.cuda.synchronize()
    if any(_count(flash_kernels).values()):
        fail(f"the plain pass launched kernels: {_count(flash_kernels)}")
    num = sum((a.float() - b.float()).square().sum() for a, b in
              zip(grads_k, grads_p))
    den = sum(b.float().square().sum() for b in grads_p)
    rel_g = (num / den).sqrt().item()
    rel_l = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"[18] omni loss + gradients (3,584 packed tokens, Lc 512, 49 audio"
        f" keys, every condition on), kernels vs plain attention: loss "
        f"{loss_k.item():.6g} vs {loss_p.item():.6g} (relative error "
        f"{rel_l:.3g}, tol 5e-2), gradients relative L2 {rel_g:.3g} (tol "
        f"5e-2), gradient norm {den.sqrt().item():.4g}")
    if not (rel_l <= 5e-2 and rel_g <= 5e-2):
        fail("omni step: kernels disagree with plain attention")
    del grads_k, grads_p, plist
    gc.collect()
    torch.cuda.empty_cache()

    def small_step():
        omni_train_step(state, batch, masks, t, noise, optimizer=opt,
                        policy=setup.policy, remat=True)

    small_step()                                      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    small_step()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    split, busy, _ = kernel_split(small_step)
    log(f"[18] one omni training step at (a)'s geometry (3,584 tokens, "
        f"batch assembled ahead): {sec:.3f} s; its profiled twin holds "
        f"{busy:.1f} ms of kernel time ({100 * busy / (sec * 1e3):.1f}% of "
        f"the unprofiled step; the rest is the host issuing work): "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items()))
    del batch

    # (c) one timed step at 480x832: 20,280 + 1,560 tokens -> 22,528
    lat = OMNI_TRAIN["big_lat"]
    _, c, f, h, w = lat
    big = {"frames": torch.randn(lat, generator=gen, device="cuda"),
           "context": torch.randn((1, 512, 4096), generator=gen,
                                  device="cuda"),
           "audio": torch.randn((1, OMNI_TRAIN["pixel_frames"], 1024),
                                generator=gen, device="cuda"),
           "pose": torch.rand((1, 308, f, 2 * h, 2 * w), generator=gen,
                              device="cuda").to(torch.bfloat16),
           "reference": torch.randn((1, c, 1, h, w), generator=gen,
                                    device="cuda")}
    masks, t, noise = draw_step_inputs(gen, lat, all_on, "cuda")

    def step():
        _, m = omni_train_step(state, big, masks, t, noise, optimizer=opt,
                               policy=setup.policy, remat=True)
        return float(m["loss"])

    step()                                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(all_kernels)
    t0 = time.perf_counter()
    loss = step()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    big_counts = _count(flash_kernels)
    want_big = dict(zip(big_counts, _omni_step_launches(setup.stages[-1],
                                                        layers)))
    if loss != loss or big_counts != want_big:
        fail(f"480x832 omni step: loss {loss}, launches {big_counts}, "
             f"expected {want_big}")
    holder = {}

    def fwd_bwd():
        params = state.params()
        loss = omni_flow_matching_loss(state.model, big, masks, t, noise,
                                       policy=setup.policy, remat=True)
        holder["grads"] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True,
            materialize_grads=True)))

    fb, fb_total, _ = kernel_split(fwd_bwd)
    _, opt_total, _ = kernel_split(lambda: opt.step(
        state.params(), holder.pop("grads"), state.opt_state))
    total_ms = fb_total + opt_total
    fb["rest (elementwise, norms, copies)"] = fb.pop(
        "rest (elementwise, norms, optimizer, copies)")
    split = dict(fb, optimizer=opt_total)
    log(f"[18] omni training step at 480x832 (latents {lat}, 21,840 packed "
        f"tokens -> 22,528, Lc 512, 49 audio keys, heatmaps 308 x 13 x 240 "
        f"x 416 bf16, {layers} layers, per-block remat, batch 1): "
        f"{sec:.3f} s, loss {loss:.6g}, peak device memory {peak:.1f} GiB; "
        f"launches {big_counts}; profiled: " + (
            f"{total_ms:.1f} ms of kernel time: " + ", ".join(
                f"{k} {v:.1f} ms ({100 * v / total_ms:.1f}%)"
                for k, v in split.items()) if total_ms else
            "no device time recorded"))
    del big, state, opt, holder, noise
    setup.trainer = None
    del setup
    gc.collect()
    torch.cuda.empty_cache()

    # K1 with the LSE and K2 alone at the omni training shapes
    kgen = torch.Generator(device="cuda").manual_seed(1818)
    rows = {}
    for key, case in (
            ("self_3584", ("self-attention Lq=Lk=3584", 1, 3584, 3584, None,
                           {}, True)),
            ("self_22528", ("self-attention Lq=Lk=22528 k_len=21840", 1,
                            22528, 22528, (21840,), {}, True)),
            ("text_22528", ("text cross-attention Lq=22528 Lc=512", 1,
                            22528, 512, None, {}, True)),
            ("audio_22528", ("audio cross-attention Lq=22528 Lk=49", 1,
                             22528, 49, None, {}, True)),
            ("audio_3584", ("audio cross-attention Lq=3584 Lk=49", 1, 3584,
                            49, None, {}, True))):
        rows[key] = backward_case("18", *case, kgen)

    # (d) cli.omni_inference.run with --checkpoint on (a)'s final state
    rng = np.random.default_rng(19)
    img = rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
    n = int(1.0 * OMNI_TRAIN["sr"])
    wav = (0.3 * np.sin(2 * np.pi * 200 * np.arange(n) / OMNI_TRAIN["sr"])
           + 0.05 * rng.normal(size=n)).astype(np.float32)
    inf_argv = ["--task", OMNI_TRAIN["task"], "--size", "256*256",
                "--num_frames", "13", "--total_frames", "13",
                "--num_inference_steps", "2", "--seed", "7"]
    videos = {}
    for name, extra in (("trained", ["--checkpoint", out]), ("random", [])):
        a = omni_inference.build_parser().parse_args(inf_argv + extra)
        a.output = None
        t0 = time.perf_counter()
        pipe = omni_inference.build_pipeline(a)
        build_s = time.perf_counter() - t0
        _zero(all_kernels)
        t0 = time.perf_counter()
        res = omni_inference.run(a, img, wav, OMNI_TRAIN["sr"], pipe=pipe)
        torch.cuda.synchronize()
        v = res["video"].float()
        log(f"[18] omni_inference {name} ({' '.join(extra) or 'random init'}"
            f"): pipeline built in {build_s:.1f} s, request "
            f"{time.perf_counter() - t0:.1f} s, video {tuple(v.shape)} in "
            f"[{v.min().item():.3f}, {v.max().item():.3f}]; launches "
            f"{_count(all_kernels)}")
        if tuple(v.shape) != (3, 49, 256, 256) or not torch.isfinite(v).all():
            fail(f"omni_inference {name}: wrong shape or non-finite video")
        videos[name] = v.cpu()
        del pipe, res, v
        gc.collect()
        torch.cuda.empty_cache()
    diff = (videos["trained"] - videos["random"]).abs().max().item()
    log(f"[18] --checkpoint video vs random-init video: max abs difference "
        f"{diff:.4g}")
    if diff == 0.0:
        fail("--checkpoint did not change the omni output")
    shutil.rmtree(work, ignore_errors=True)
    return counts, rows


# ---------------------------------------------------------------------------
# phases 19-22: checkpoint directories in the CLI, f-distill, the APT CLI,
# EMA evaluation (on phase 8's dit/, teacher npz and distill output)

APT_VIDEO = dict(samples=2, latent=(16, 21, 60, 104), seed=21)
FD_BIG = dict(latent=(1, 16, 21, 60, 104), seed=81)


def _recording(cls, built):
    """`cls` that keeps each instance it builds in `built`."""
    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)
    return Recording


class _SaveTimes:
    """Context that times every CheckpointManager.save: [(step, s, GB)]."""

    def __enter__(self):
        from unittest import mock
        from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
        real, self.saves = CheckpointManager.save, []

        def timed(mgr, step, state, metadata=None):
            t0 = time.perf_counter()
            real(mgr, step, state, metadata=metadata)
            self.saves.append((step, time.perf_counter() - t0, os.path.getsize(
                os.path.join(mgr._path(step), "state.pt")) / 1e9))
        self._patch = mock.patch.object(CheckpointManager, "save", timed)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()

    def text(self) -> str:
        return ", ".join(f"step {s}: {gb:.2f} GB in {sec:.1f} s"
                         for s, sec, gb in self.saves)


def _want(kernels, long_k=0, short_k=0, bwd=0, k3=0, k4=0):
    """{kernel name: launches} in the order K1 long-K, K1 short-K, K2, K3,
    K4 (the names of the first five of `kernels`; block_norm's and
    qk_norm_rope's, after them, are left to `_differ`'s callers)."""
    return dict(zip([kn.name for kn in kernels],
                    (long_k, short_k, bwd, k3, k4)))


def phase_ckpt_dir(kernels):
    """[19] `cli.generate --ckpt_dir` on phase 8's directory with a random
    bf16 VAE file beside the DiT: a t2v request, then --one_step with the
    distill EMA as the generator."""
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.cli import generate
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.vae import build_vae
    from omnihuman_tpu_torch.pipelines import text2video as t2v
    # imported before WanT2V is patched: a module first imported under the
    # patch would bind the recording class, and with it the pipelines it
    # holds, for the rest of the run
    from omnihuman_tpu_torch.pipelines import wan_inference  # noqa: F401
    from omnihuman_tpu_torch.utils import media
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager
    from omnihuman_tpu_torch.utils.convert import load_torch_state_dict

    dit_dir, distill = os.path.join(WORK, "dit"), os.path.join(WORK, "distill")
    vae = build_vae(T2V_1_3B.vae, "cuda", torch.bfloat16, seed=1)
    torch.save({k: v.cpu() for k, v in vae.state_dict().items()},
               os.path.join(dit_dir, "Wan2.1_VAE.pth"))
    vae_file = {k: v.cpu() for k, v in vae.state_dict().items()}
    del vae
    w, h = SMOKE["size"]
    frames, steps = SMOKE["frames"], SMOKE["steps"]
    f_lat = (frames - 1) // 4 + 1
    base = ["--task", "t2v-1.3B", "--ckpt_dir", dit_dir, "--size",
            f"{h}*{w}", "--frame_num", str(frames), "--base_seed", "3"]
    runs = (
        ("t2v", ["--sample_steps", str(steps), "--save_file",
                 os.path.join(WORK, "ckpt_t2v.mp4")],
         load_torch_state_dict(os.path.join(
             dit_dir, "diffusion_pytorch_model.safetensors")),
         _want(kernels, NUM_LAYERS * steps, NUM_LAYERS * steps, 0,
               28 * f_lat, 3 * f_lat)),
        ("one-step", ["--one_step", "--generator_ckpt", distill,
                      "--save_file", os.path.join(WORK, "ckpt_one.mp4")],
         CheckpointManager(distill).restore()["ema_params"],
         _want(kernels, NUM_LAYERS, NUM_LAYERS, 0, 28 * f_lat, 3 * f_lat)))
    counts = None
    for name, extra, want_dit, want in runs:
        built, videos = [], []
        real_cache = media.cache_video

        def keep(video, *a, **k):
            videos.append(video)
            return real_cache(video, *a, **k)
        _zero(kernels)
        t0 = time.perf_counter()
        with mock.patch.object(t2v, "WanT2V", _recording(t2v.WanT2V, built)), \
                mock.patch.object(media, "cache_video", keep):
            path = generate.main(base + extra)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = _count(kernels)
        counts = counts or got
        pipe, = built
        video = videos[0].float()
        n_bytes = same_tree(want_dit, dict(pipe.model.state_dict()), "dit")
        same_tree(vae_file, pipe.vae.state_dict(), "vae")
        log(f"[19] cli.generate --ckpt_dir ({name}): {sec:.1f} s with the "
            f"pipeline build; DiT {n_bytes / 1e9:.2f} GB bit-equal to "
            f"{'the file' if name == 't2v' else 'the distill EMA'}, VAE to "
            f"Wan2.1_VAE.pth; video {tuple(video.shape)} in "
            f"[{video.min().item():.3f}, {video.max().item():.3f}] -> "
            f"{os.path.basename(path)}; stage times {pipe.timings or ''}"
            f"; launches {got}, expected {want}")
        if tuple(video.shape) != (3, frames, h, w) or \
                not torch.isfinite(video).all():
            fail(f"--ckpt_dir {name}: wrong video shape or values")
        if _differ(got, want):
            fail(f"--ckpt_dir {name}: launches {got} != {want}")
        built.clear()
        del pipe, videos, video
        gc.collect()
        torch.cuda.empty_cache()
    return counts


class _GradsOnly:
    """An optimizer that keeps the gradients and changes nothing."""

    def step(self, params, grads, state):
        self.grads = grads


def _f_distill_grads(state, teacher, batch, d_snapshot, kw):
    """(loss, student gradients) of one f-distill step from the
    discriminator in `d_snapshot`; the student is left as it is."""
    import copy as _copy
    from omnihuman_tpu_torch.apt import f_distill as fd
    state.disc.load_state_dict(d_snapshot[0])
    state.d_opt_state = _copy.deepcopy(d_snapshot[1])
    cap = _GradsOnly()
    _, m = fd.f_distill_train_step(state, teacher, batch, optimizer=cap,
                                   d_optimizer=fd.make_d_optimizer(1e-5), **kw)
    return m["loss"].item(), list(cap.grads.values())


def phase_f_distill(npz, kernels, teacher):
    """[20] cli.train_f_distill at t2v-1.3B full width on phase 8's npz,
    a resume, kernels against plain attention, an 81-frame step; the
    steps outside the CLI read phase 8's DiT (`teacher`, the checkpoint's
    weights) as the teacher."""
    import copy as _copy
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.apt import f_distill as fd
    from omnihuman_tpu_torch.apt.generate import (
        create_dataloader, load_teacher_data)
    from omnihuman_tpu_torch.cli import train_f_distill
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.ops import attention
    from omnihuman_tpu_torch.ops import flash_attention as fa
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager

    dit_dir, out = os.path.join(WORK, "dit"), os.path.join(WORK, "f_distill")
    argv = ["--task", "t2v-1.3B", "--checkpoint_dir", dit_dir, "--data_path",
            npz, "--output_dir", out, "--num_epochs", "1", "--batch_size",
            "1", "--save_interval", "1"]
    # a step: the batch-2 teacher CFG forward, the detached student
    # forward, the graded forward and its recompute; one K2 an attention
    per_step = (4 * NUM_LAYERS, 4 * NUM_LAYERS, 2 * NUM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    with _SaveTimes() as saves:
        state, history = train_f_distill.main(argv)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = _count(kernels)
    want = _want(kernels, *(2 * n for n in per_step))
    for h in history:
        log(f"[20] f-distill step {h['step']}: loss {h['loss']:.6g}, f_div "
            f"{h['f_div_loss']:.6g}, g {h['g_loss']:.6g}, d "
            f"{h['d_loss']:.6g}, density ratio "
            f"{h['density_ratio_mean']:.4g}, weight "
            f"{h['weight_mean']:.4g}, {h['seconds']:.3f} s")
        if not (h["loss"] > 0 and h["f_div_loss"] > 0 and h["d_loss"] > 0
                and 0.01 <= h["density_ratio_mean"] <= 100.0):
            fail("an f-distill step has a zero, non-finite or out-of-range "
                 "metric")
    log(f"[20] cli.train_f_distill: {len(history)} steps at 1,560 tokens in "
        f"{total:.1f} s (with model build and saves), peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; saves "
        f"{saves.text()}; launches {counts}, expected {want}")
    mgr = CheckpointManager(out)
    if mgr.all_steps() != [1, 2] or mgr.restore_metadata(2) != {"epoch": 0}:
        fail(f"f-distill checkpoints {mgr.all_steps()} / metadata unexpected")
    if _differ(counts, want):
        fail("the f-distill path did not send every attention through K1 "
             "and K2")
    shutil.rmtree(os.path.join(out, "step_00000002"))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    _zero(kernels)
    state, resumed = train_f_distill.main(argv + ["--resume"])
    got = _count(kernels)
    if [h["step"] for h in resumed] != [2] or _differ(
            got, _want(kernels, *per_step)):
        fail(f"f-distill resume from step 1: steps "
             f"{[h['step'] for h in resumed]}, launches {got}")
    rel = abs(resumed[0]["loss"] - history[1]["loss"]) / history[1]["loss"]
    log(f"[20] --resume from step 1: step 2 again, loss "
        f"{resumed[0]['loss']:.6g} against {history[1]['loss']:.6g} "
        f"uninterrupted (relative {rel:.3g}; dQ's sum order varies run to "
        f"run); launches {got}")

    data = load_teacher_data(npz)
    batch = next(create_dataloader(data, batch_size=1, shuffle=False,
                                   device="cuda")())
    batch = {"noise": batch["noise"], "context": batch["context"],
             "context_null": torch.from_numpy(
                 data["negative_context"])[None].cuda()}
    sin, cos = rope_angles_3d((1, 30, 52), 128, seq_len=1560, device="cuda")
    kw = dict(seq_len=1560, rope_sin=sin, rope_cos=cos,
              policy=T2V_1_3B.policy, f_divergence="jensen-shannon",
              beta=0.9, alpha=0.1)
    snap = (_copy.deepcopy(state.disc.state_dict()),
            _copy.deepcopy(state.d_opt_state))
    _zero(kernels)
    loss_k, grads_k = _f_distill_grads(state, teacher, batch, snap, kw)
    if not all(list(_count(kernels).values())[:3]):
        fail(f"the kernel pass missed a kernel: {_count(kernels)}")
    _zero(kernels)
    # the graded forwards go through fa's autograd Function, the no-grad
    # ones (the teacher, the detached student) through ops.attention
    with mock.patch.object(fa, "flash_fwd", fa.flash_attention_plain), \
            mock.patch.object(fa, "flash_bwd", fa.flash_bwd_plain), \
            mock.patch.object(attention, "flash_fwd",
                              fa.flash_attention_plain):
        loss_p, grads_p = _f_distill_grads(state, teacher, batch, snap, kw)
    torch.cuda.synchronize()
    # only the attention is patched: block_norm and qk_norm_rope run in
    # both passes
    if any(_count(kernels[:3]).values()):
        fail(f"the plain pass launched kernels: {_count(kernels)}")
    num = sum((a.float() - b.float()).square().sum() for a, b in
              zip(grads_k, grads_p))
    den = sum(b.float().square().sum() for b in grads_p)
    rel_g = (num / den).sqrt().item()
    rel_l = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[20] f-distill loss + gradients (1,560 tokens, bf16), kernels vs "
        f"plain attention: loss {loss_k:.6g} vs {loss_p:.6g} (relative "
        f"{rel_l:.3g}, tol 5e-2), gradients relative L2 {rel_g:.3g} (tol "
        f"5e-2), gradient norm {den.sqrt().item():.4g}")
    if not (rel_l <= 5e-2 and rel_g <= 5e-2):
        fail("f-distill step: kernels disagree with plain attention")
    del grads_k, grads_p
    state.disc.load_state_dict(snap[0])
    state.d_opt_state = snap[1]

    gen = torch.Generator(device="cuda").manual_seed(FD_BIG["seed"])
    big = {"noise": torch.randn(FD_BIG["latent"], generator=gen,
                                device="cuda"),
           "context": torch.randn((1, 512, 4096), generator=gen,
                                  device="cuda"),
           "context_null": torch.randn((1, 512, 4096), generator=gen,
                                       device="cuda")}
    sin, cos = rope_angles_3d((21, 30, 52), 128,
                              seq_len=FLAGSHIP["seq_len"], device="cuda")
    kw.update(seq_len=FLAGSHIP["seq_len"], rope_sin=sin, rope_cos=cos)
    opt, d_opt = fd.make_student_optimizer(1e-5), fd.make_d_optimizer(1e-5)

    def step():
        _, m = fd.f_distill_train_step(state, teacher, big, optimizer=opt,
                                       d_optimizer=d_opt, **kw)
        return float(m["loss"])

    step()                                            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    loss = step()
    sec = time.perf_counter() - t0
    big_counts = _count(kernels)
    if not loss > 0 or _differ(big_counts, _want(kernels, *per_step)):
        fail(f"81-frame f-distill step: loss {loss}, launches {big_counts}")
    log(f"[20] f-distill step at 81 frames (latents [1,16,21,60,104], "
        f"{FLAGSHIP['tokens']} tokens, per-block remat, batch 1, teacher CFG "
        f"as one batch-2 forward): {sec:.2f} s, loss {loss:.6g}, peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB; "
        f"launches {big_counts}")
    profile_split(step, "20")
    del state, opt, d_opt
    shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _write_video_npz(npz, path, teacher):
    """Phase 21's video-phase data: 2 samples at 81 frames ([16, 21, 60,
    104], 32,760 tokens), v_teacher from the checkpoint's DiT (phase 8's,
    `teacher`) with CFG 7.5 at t = 999 and phase 8's contexts."""
    import numpy as np
    import torch
    from omnihuman_tpu_torch.apt.generate import (
        load_teacher_data, teacher_cfg_velocity)
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    data = load_teacher_data(npz)
    n = APT_VIDEO["samples"]
    gen = torch.Generator(device="cuda").manual_seed(APT_VIDEO["seed"])
    noise = torch.randn((n,) + APT_VIDEO["latent"], generator=gen,
                        device="cuda")
    ctx = torch.from_numpy(data["positive_contexts"][:n]).cuda()
    neg = torch.from_numpy(data["negative_context"]).cuda()
    sin, cos = rope_angles_3d((21, 30, 52), 128,
                              seq_len=FLAGSHIP["seq_len"], device="cuda")
    v = torch.cat([teacher_cfg_velocity(
        teacher, noise[i:i + 1], ctx[i:i + 1], neg[None],
        seq_len=FLAGSHIP["seq_len"], rope_sin=sin, rope_cos=cos,
        policy=T2V_1_3B.policy, t_value=999.0, cfg_scale=7.5)
        for i in range(n)])
    noise_np = noise.cpu().numpy()
    np.savez(path, dummy_data=noise_np, noise=noise_np,
             dummy_prompts=data["dummy_prompts"][:n],
             positive_contexts=data["positive_contexts"][:n],
             negative_context=data["negative_context"],
             v_teacher=v.cpu().numpy())
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_apt(npz, kernels, teacher):
    """[21] cli.train_apt at t2v-1.3B full width: 2 image updates on phase
    8's npz (1,560 tokens), 1 video update on an 81-frame npz (32,760
    tokens; its v_teacher from phase 8's DiT, `teacher`), the generator
    booted from the distill EMA; then a resume after the video final is
    lost."""
    import numpy as np
    import torch
    from omnihuman_tpu_torch.cli import train_apt
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager

    video_npz = os.path.join(WORK, "video_81f.npz")
    t0 = time.perf_counter()
    _write_video_npz(npz, video_npz, teacher)
    log(f"[21] 81-frame video npz ({APT_VIDEO['samples']} samples, "
        f"v_teacher by the batch-2 teacher CFG) in "
        f"{time.perf_counter() - t0:.1f} s")
    out = os.path.join(WORK, "apt")
    argv = ["--task", "t2v-1.3B", "--checkpoint_dir",
            os.path.join(WORK, "dit"), "--consistency_path",
            os.path.join(WORK, "distill"), "--data_path", npz,
            "--video_data_path", video_npz, "--output_dir", out,
            "--image_updates", "2", "--video_updates", "1",
            "--save_interval", "2"]
    # an update: D (the generator and 3 discriminator forwards, features
    # cut) and G (generator forward + recompute, discriminator forward and
    # the recompute of blocks 0..26 that its taps (11, 19, 26) reach)
    per_update = (237, 237, 114)
    torch.cuda.reset_peak_memory_stats()
    _zero(kernels)
    t0 = time.perf_counter()
    with _SaveTimes() as saves:
        _, history = train_apt.main(argv)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = _count(kernels)
    want = _want(kernels, *(3 * n for n in per_update))
    for h in history:
        tokens = 32760 if h["phase"] else 1560
        log(f"[21] APT {'video' if h['phase'] else 'image'} update "
            f"{h['update']} ({tokens} tokens): D {h['d_seconds']:.2f} s "
            f"(d_loss {h['d_loss']:.5g}, r1 {h['r1_loss']:.5g}), G "
            f"{h['g_seconds']:.2f} s (g_loss {h['g_loss']:.5g})")
        if not all(np.isfinite(h[k]) for k in ("d_loss", "r1_loss",
                                               "g_loss")):
            fail("an APT loss is not finite")
    log(f"[21] cli.train_apt: 2 image + 1 video updates in {total:.1f} s "
        f"(with model builds and saves), peak device memory {peak:.1f} GiB; "
        f"saves {saves.text()}; launches {counts}, expected {want}")
    mgr = CheckpointManager(out)
    metas = {s: mgr.restore_metadata(s) for s in mgr.all_steps()}
    if metas != {2: {"phase": "image", "update": 2, "final": True},
                 3: {"phase": "video", "update": 1, "final": True}}:
        fail(f"APT checkpoints / metadata unexpected: {metas}")
    if _differ(counts, want):
        fail("the APT path did not send every attention through K1 and K2")
    shutil.rmtree(os.path.join(out, "step_00000003"))
    _zero(kernels)
    _, resumed = train_apt.main(argv + ["--resume"])
    got = _count(kernels)
    log(f"[21] --resume after the video final was lost: updates "
        f"{[(h['phase'], h['update']) for h in resumed]}, steps "
        f"{mgr.all_steps()}, launches {got}")
    if [(h["phase"], h["update"]) for h in resumed] != [(1.0, 1)] \
            or mgr.all_steps() != [2, 3] or _differ(
                got, _want(kernels, *per_update)):
        fail("the APT resume did not rerun the video phase from the image "
             "final")
    shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_eval_ema(npz, kernels):
    """[22] cli.eval_ema on phase 8's directory (DiT + the VAE file of
    phase 19) with the distill EMA, 2 samples of phase 8's npz."""
    import numpy as np
    import torch
    from unittest import mock
    from omnihuman_tpu_torch.apt import eval_ema as ee
    from omnihuman_tpu_torch.cli import eval_ema

    out = os.path.join(WORK, "eval")
    run, pass_s = ee.evaluate_ema, []

    def timed(*a, **k):              # the pass alone, without the build
        t0 = time.perf_counter()
        metrics = run(*a, **k)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
        return metrics
    _zero(kernels)
    t0 = time.perf_counter()
    with mock.patch.object(ee, "evaluate_ema", timed):
        metrics = eval_ema.main([
            "--task", "t2v-1.3B", "--checkpoint_dir",
            os.path.join(WORK, "dit"), "--ema_checkpoint",
            os.path.join(WORK, "distill"), "--data_path", npz,
            "--num_samples", "2", "--out_dir", out])
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _count(kernels)
    # one batch-2 forward; two 1-latent-frame decodes (28 K3 + 3 K4 each)
    want = _want(kernels, NUM_LAYERS, NUM_LAYERS, 0, 56, 6)
    files = sorted(os.listdir(out))
    log(f"[22] cli.eval_ema (2 samples, 1,560 tokens): {sec:.1f} s with the "
        f"pipeline build, the pass (one-step forward, two decodes, metrics, "
        f"images) {pass_s[0]:.2f} s; {metrics}; images {files}; launches "
        f"{counts}, "
        f"expected {want}")
    if not (np.isfinite(metrics["psnr_vs_teacher"])
            and np.isfinite(metrics["ssim_vs_teacher"])
            and [os.path.splitext(f)[0] for f in files]
            == ["eval_image_0", "eval_image_1"]):
        fail("eval_ema: non-finite metrics or missing images")
    if _differ(counts, want):
        fail("eval_ema did not run through K1 and K3 / K4")
    return counts


# ---------------------------------------------------------------------------
# phases 23-24: the pose data plane (Sapiens-1b keypoints, extract_feature,
# --pose_video) and the evaluation suite, after phase 16 on its pipeline

POSE = dict(frames=8, seed=31, sapiens_seed=41)   # frames at OMNI's size
EVAL = dict(clips=2, frames=16, hw=256, seed=51)


def _pose_frames(n, h, w, seed):
    """n seeded frames [h, w, 3] uint8: a dark noisy background and two
    bright figures (head and torso), drifting apart frame to frame."""
    import numpy as np
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 60, (n, h, w, 3), dtype=np.uint8)
    for t in range(n):
        for cx, level in ((0.3 * w - 4 * t, 235), (0.68 * w + 3 * t, 200)):
            x0, x1 = int(cx - 0.04 * w), int(cx + 0.04 * w)
            frames[t, int(0.12 * h):int(0.27 * h), x0:x1] = level
            frames[t, int(0.28 * h):int(0.92 * h),
                   int(cx - 0.08 * w):int(cx + 0.08 * w)] = level - 20
    return frames


def sapiens_flops(cfg) -> float:
    """FLOP of one Sapiens crop: the patch embed, 12 D^2 a token a layer in
    the linears, 4 T^2 D a layer in attention, the deconvs (4 Cin taps an
    output pixel), the 1x1 convs and the final layer."""
    gh, gw = cfg.grid
    t, d = gh * gw, cfg.embed_dim
    f = 2.0 * t * d * 3 * cfg.patch_size ** 2
    f += cfg.depth * (2.0 * t * 12 * d * d + 4.0 * t * t * d)
    cin, h, w = d, gh, gw
    for c in cfg.deconv_channels:
        h, w = 2 * h, 2 * w
        f += 2.0 * h * w * c * cin * 4
        cin = c
    for c in cfg.conv_channels:
        f += 2.0 * h * w * c * cin
        cin = c
    return f + 2.0 * h * w * cfg.num_keypoints * cin


class _TimedBackbone:
    """A backbone wrapper that adds each call's synchronised seconds."""

    def __init__(self, backbone):
        self.backbone, self.seconds, self.calls = backbone, 0.0, 0

    def __call__(self, crop):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.backbone(crop)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def tf32_state() -> str:
    import torch
    return (f"TF32 in matmuls {torch.backends.cuda.matmul.allow_tf32}, in "
            f"cuDNN {torch.backends.cudnn.allow_tf32}")


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_pose(all_kernels, flash_kernels, card, pipe=None):
    """[23] The pose data plane at full width: Sapiens-1b from a state-dict
    file through SapiensKeypointProcessor, its times, card against CPU,
    cli.extract_feature.run, then --pose_video's heatmaps through one omni
    request on phase 16's pipeline (built anew when `pipe` is None).
    Returns (the request's launches, the processor)."""
    import copy
    import dataclasses
    import multiprocessing
    import numpy as np
    import torch
    from omnihuman_tpu_torch.cli import extract_feature
    from omnihuman_tpu_torch.cli.omni_inference import (
        build_parser, pose_heatmaps_from_frames, run)
    from omnihuman_tpu_torch.omni import pose_utils as pu
    from omnihuman_tpu_torch.omni import sapiens as sap
    from omnihuman_tpu_torch.omni.keypoints import SapiensKeypointProcessor
    from omnihuman_tpu_torch.omni.worker_pool import WorkerPool

    tf32 = tf32_state()
    cfg = sap.SAPIENS_PRESETS["1b"]
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "sapiens_1b.pth")
    t0 = time.perf_counter()
    model = sap.build_sapiens(cfg, "cuda", seed=POSE["sapiens_seed"])
    with torch.no_grad():   # random heatmaps sit near 0, under the 0.1
        # confidence gaussian_heatmaps keeps: a positive final bias makes
        # the pose heatmaps and HKC non-trivial
        model.head.final_layer.bias.normal_(
            0.5, 0.1, generator=torch.Generator(device="cuda").manual_seed(
                POSE["sapiens_seed"]))
    n_params = sum(p.numel() for p in model.parameters())
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path)
    gb = os.path.getsize(path) / 1e9
    del model
    torch.cuda.empty_cache()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = SapiensKeypointProcessor(checkpoint_path=path)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    os.remove(path)
    if proc.backbone is None or proc.backbone.cfg != cfg:
        fail("SapiensKeypointProcessor did not load the Sapiens-1b file")
    log(f"[23] Sapiens-1b ({n_params / 1e9:.3f} B parameters, fp32, random "
        f"seed {POSE['sapiens_seed']}): {gb:.2f} GB state-dict file written "
        f"in {t_write:.1f} s, loaded through infer_sapiens_config in "
        f"{t_load:.1f} s; {tf32}")

    # the backbone alone, batch 1 and 8
    bb = proc.backbone
    g = torch.Generator(device="cuda").manual_seed(3)
    crops = torch.randint(0, 256, (8, *cfg.img_size, 3), generator=g,
                          device="cuda", dtype=torch.uint8)
    flops = sapiens_flops(cfg)
    base = torch.cuda.memory_allocated()
    times = {}
    for b in (1, 8):
        torch.cuda.reset_peak_memory_stats()
        times[b] = bench_ms(lambda: bb.batch(crops[:b]), reps=7,
                            warmup=2 if b == 1 else 1)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        log(f"[23] Sapiens-1b forward 1024x768 at batch {b}: "
            f"{times[b]:.1f} ms ({times[b] / b:.1f} ms a crop; "
            f"{flops / 1e12:.2f} TFLOP a crop, {flops * b / times[b] / 1e9:.1f}"
            f" TFLOP/s; fp32 bound {flops * b / 67e12 * 1e3:.1f} ms at 67 "
            f"TFLOP/s); peak {peak:.2f} GiB above the weights ({card})")

    # the processor, frame by frame
    w_px, h_px = OMNI["size"]
    frames = _pose_frames(POSE["frames"], h_px, w_px, POSE["seed"])
    timed = _TimedBackbone(bb)
    proc.backbone = proc.detector.backbone = timed
    kps, per, dev = [], [], []
    for f in frames:
        torch.cuda.synchronize()
        t0, b0 = time.perf_counter(), timed.seconds
        kps.append(proc.extract_keypoints(f))
        torch.cuda.synchronize()
        per.append(time.perf_counter() - t0)
        dev.append(timed.seconds - b0)
    if any(k is None for k in kps) or not np.isfinite(np.stack(kps)).all():
        fail("the keypoint processor failed on a synthetic frame")
    kps = np.stack(kps)
    host = np.array(per) - np.array(dev)
    log(f"[23] keypoints of {len(frames)} frames {frames.shape[1:]}: "
        f"{np.median(per) * 1e3:.1f} ms a frame (median; first "
        f"{per[0] * 1e3:.1f}): backbone {np.median(dev) * 1e3:.1f} ms in "
        f"{timed.calls // len(frames)} passes (detector + crop), the rest "
        f"(resize, labelling, crop, blur, UDP / DARK) "
        f"{np.median(host) * 1e3:.1f} ms (medians); keypoints {kps.shape}, "
        f"x in [{kps[..., 0].min():.3f}, {kps[..., 0].max():.3f}], scores "
        f"in [{kps[..., 2].min():.3f}, {kps[..., 2].max():.3f}] ({card})")
    proc.backbone = proc.detector.backbone = bb

    # card against CPU: the crop, blur and labelling, and Sapiens at 2
    # layers of the 1b width on the same weights
    box = proc.detect_person(frames[0])
    c_card, *_ = pu.top_down_affine_transform(
        torch.from_numpy(frames[0]).cuda(), box, proc.input_size)
    c_cpu, *_ = pu.top_down_affine_transform(frames[0], box,
                                             proc.input_size)
    crop_err = (c_card.cpu().int() - c_cpu.int()).abs().max().item()
    hm = bb(c_card)
    b_card, b_cpu = pu.gaussian_blur(hm).cpu(), pu.gaussian_blur(hm.cpu())
    blur_err = (b_card - b_cpu).abs().max().item()
    mask = (hm.amax(0) >= 0.3 * hm.amax()).to(torch.uint8)
    la, lb = (pu.connected_components(m) for m in
              (mask.cpu().numpy(), (hm.cpu().amax(0) >= 0.3 * hm.cpu().amax()
                                    ).to(torch.uint8).numpy()))
    labels_equal = la[0] == lb[0] and (la[1] == lb[1]).all() and \
        (la[2] == lb[2]).all()
    small = sap.build_sapiens(dataclasses.replace(cfg, depth=2), "cpu",
                              seed=43)
    t0 = time.perf_counter()
    want = sap.SapiensBackbone(model=copy.deepcopy(small), device="cpu"
                               ).batch(c_cpu[None])
    cpu_s = time.perf_counter() - t0
    got = sap.SapiensBackbone(model=small, device="cuda").batch(
        c_card[None]).cpu()
    sap_err = (got - want).abs().max().item() / want.abs().max().item()
    log(f"[23] card vs CPU: crop max {crop_err} levels (tol 1), blur max "
        f"abs {blur_err:.3g} (tol 1e-6), {la[0] - 1} components, labels and "
        f"stats equal {labels_equal}; Sapiens 2 layers at the 1b width "
        f"max err {sap_err:.3g} of the peak (tol 5e-3, which allows TF32 "
        f"convolutions; the CPU forward {cpu_s:.1f} s)")
    if crop_err > 1 or blur_err > 1e-6 or not labels_equal or sap_err > 5e-3:
        fail("the pose data plane on the card disagrees with the CPU")
    del small, got, want

    # cli.extract_feature.run over the frames, and a child's exception
    out_dir = os.path.join(WORK, "features")
    t0 = time.perf_counter()
    n = extract_feature.run(((f"frame{i:02d}.png", f) for i, f in
                             enumerate(frames)), out_dir, proc)
    dt = time.perf_counter() - t0
    files = sorted(os.listdir(out_dir))
    hm0 = np.load(os.path.join(out_dir, files[0]))
    log(f"[23] cli.extract_feature.run: {n} files of {hm0.shape} written in "
        f"{dt:.2f} s ({n / dt:.2f} images/s, 2 spawned writers) ({card})")
    if n != len(frames) or len(files) != n or hm0.shape != (308, 64, 64):
        fail("extract_feature wrote the wrong files")
    with WorkerPool(processes=1,
                    context=multiprocessing.get_context("spawn")) as pool:
        r = pool.apply_async(extract_feature._save_npy,
                             (os.path.join(out_dir, "no", "x.npy"), hm0))
        try:
            r.get(timeout=60)
            fail("a child's exception did not reach the parent")
        except FileNotFoundError as e:
            reached = "child traceback" in str(e)
    log(f"[23] a child's FileNotFoundError reached the parent with its "
        f"traceback: {reached}")
    if not reached:
        fail("the child's traceback is missing")
    shutil.rmtree(out_dir, ignore_errors=True)

    # --pose_video: heatmaps at phase 16's geometry, one omni request
    if pipe is None:
        args, pipe = _omni_pipeline("23")
    else:
        args = build_parser().parse_args(OMNI["argv"])
        args.output = None
    h_lat, w_lat = h_px // 8, w_px // 8
    t0 = time.perf_counter()
    pose = pose_heatmaps_from_frames(iter(frames), OMNI["f_total"], h_lat,
                                     w_lat, proc)
    pose_s = time.perf_counter() - t0
    if pose.shape != (1, 308, OMNI["f_total"], 2 * h_lat, 2 * w_lat) or \
            not np.isfinite(pose).all():
        fail(f"pose heatmaps {pose.shape} are wrong")
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (h_px, w_px, 3), dtype=np.uint8)
    nsamp = int(OMNI["audio_s"] * OMNI["sr"])
    wav = (0.3 * np.sin(2 * np.pi * 220 * np.arange(nsamp) / OMNI["sr"])
           ).astype(np.float32)
    _zero(all_kernels)
    t0 = time.perf_counter()
    out = run(args, img, wav, OMNI["sr"], pose=pose[0], pipe=pipe)
    torch.cuda.synchronize()
    req_s = time.perf_counter() - t0
    counts = _count(all_kernels)
    want = _omni_want(all_kernels, flash_kernels)
    video = out["video"].float()
    log(f"[23] --pose_video: heatmaps {pose.shape} of {len(frames)} frames "
        f"(the last repeated to {OMNI['f_total']}; {pose.any(axis=(2, 3, 4)).sum()}"
        f" of 308 maps non-zero) in {pose_s:.2f} s; omni "
        f"request with them {req_s:.2f} s, video {tuple(video.shape)} "
        f"finite {bool(torch.isfinite(video).all())}; launches {counts}, "
        f"phase 16's {want} ({card})")
    if _differ(counts, want) or not torch.isfinite(video).all():
        fail("the --pose_video request did not match phase 16's launches")
    return counts, proc


def phase_eval(card, proc=None):
    """[24] cli.evaluate.main at full width on 2 real and 2 fake .npy clips
    (16 frames, 256x256): InceptionV3 (random), I3D kinetics-400 from a
    random piergiaj-named state dict, --keypoints with phase 23's
    processor (a random Sapiens-1b one when None); then FID of identical
    sets, IS, Sync-C with the default towers, and Inception / I3D on the
    card against the CPU."""
    import json
    from unittest import mock
    import numpy as np
    import torch
    from omnihuman_tpu_torch.cli import evaluate as cli
    from omnihuman_tpu_torch.omni import evaluate as ev
    from omnihuman_tpu_torch.omni.i3d import (
        I3D_PRESETS, I3DVideoFeatures, build_i3d)
    from omnihuman_tpu_torch.omni.inception import InceptionFeatures
    from omnihuman_tpu_torch.omni.syncc import SyncCEmbedders

    if proc is None:
        proc = cli.build_keypoint_processor()
    rng = np.random.default_rng(EVAL["seed"])
    n, t, hw = EVAL["clips"], EVAL["frames"], EVAL["hw"]
    dirs = {k: os.path.join(WORK, "eval", k) for k in ("real", "fake")}
    real = rng.uniform(-1, 1, (n, t, hw, hw, 3)).astype(np.float32)
    real[:, :, 64:200, 96:160] = 0.9                      # a figure
    fake = np.clip(real + rng.normal(0, 0.3, real.shape), -1, 1).astype(
        np.float32)
    for k, clips in (("real", real), ("fake", fake)):
        os.makedirs(dirs[k], exist_ok=True)
        for i, c in enumerate(clips):
            np.save(os.path.join(dirs[k], f"clip{i}.npy"), c)
    i3d_path = os.path.join(WORK, "eval", "i3d_rgb.pt")
    torch.save({k: v.cpu() for k, v in build_i3d(
        I3D_PRESETS["kinetics-400"], "cuda", seed=EVAL["seed"]
    ).state_dict().items()}, i3d_path)

    spent = {"sqrtm": 0.0, "keypoints": 0.0}
    frechet = ev.frechet_distance

    def timed_frechet(a, b):
        t0 = time.perf_counter()
        d = frechet(a, b)
        spent["sqrtm"] += time.perf_counter() - t0
        return d

    class TimedProcessor:
        num_keypoints = proc.num_keypoints

        def extract_keypoints(self, img):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k = proc.extract_keypoints(img)
            torch.cuda.synchronize()
            spent["keypoints"] += time.perf_counter() - t0
            if k is None:
                fail("the keypoint processor failed on an eval frame")
            return k

    out_dir = os.path.join(WORK, "eval", "out")
    t0 = time.perf_counter()
    with mock.patch.object(ev, "frechet_distance", timed_frechet):
        path = cli.main(["--real_dir", dirs["real"], "--fake_dir",
                         dirs["fake"], "--num_frames", str(t), "--size",
                         f"{hw}*{hw}", "--i3d_weights", i3d_path,
                         "--keypoints", "--output_dir", out_dir,
                         "--name", "smoke"],
                        keypoint_processor=TimedProcessor())
    total = time.perf_counter() - t0
    m = json.load(open(path))
    feats_s = total - spent["sqrtm"] - spent["keypoints"]
    log(f"[24] cli.evaluate ({n} + {n} clips of {t} frames at {hw}x{hw}): "
        f"fid {m['fid']:.4f}, fvd {m['fvd']:.4f}, hkc {m['hkc']:.4f}, hkv "
        f"{m['hkv']:.4f}, feature_space {m['feature_space']}, "
        f"fvd_feature_space {m.get('fvd_feature_space')}; {total:.1f} s: "
        f"features and loading {feats_s:.1f} s, sqrtm {spent['sqrtm']:.1f} "
        f"s (FID 2,048-d + FVD 1,024-d, host), keypoints "
        f"{spent['keypoints']:.1f} s ({n * t} frames) ({card})")
    if not (np.isfinite(m["fid"]) and m["fid"] > 0 and np.isfinite(m["fvd"])
            and 0 <= m["hkc"] <= 1 and 0 <= m["hkv"] <= 1
            and m["feature_space"] == "inception_v3_random_init_proxy"
            and m.get("fvd_feature_space") == "i3d_kinetics"):
        fail(f"cli.evaluate's metrics or tags are wrong: {m}")

    inc = InceptionFeatures()
    flat = real.reshape(-1, hw, hw, 3).transpose(0, 3, 1, 2)
    t0 = time.perf_counter()
    f_real = inc(flat)
    feat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_same = ev.frechet_distance(f_real, f_real)
    same_s = time.perf_counter() - t0
    logits = inc.logits(fake.reshape(-1, hw, hw, 3).transpose(0, 3, 1, 2))
    p = np.exp(logits - logits.max(1, keepdims=True))
    score = ev.inception_score(p / p.sum(1, keepdims=True))
    sy = SyncCEmbedders()
    aud = rng.normal(size=(t, 1024)).astype(np.float32)
    t0 = time.perf_counter()
    sync = ev.LipSyncEvaluator(sy.audio_embed_fn, sy.visual_embed_fn
                               ).sync_confidence(
        fake[0].transpose(3, 0, 1, 2), aud)
    sync_s = time.perf_counter() - t0
    log(f"[24] FID of identical sets {fid_same:.3g} (tol 1e-3; sqrtm "
        f"{same_s:.1f} s; {len(flat)} frames' features {feat_s:.2f} s), IS "
        f"{score:.4f}, Sync-C (default towers, random) {sync:.4f} in "
        f"{sync_s:.2f} s ({card})")
    if not (abs(fid_same) < 1e-3 and np.isfinite(score)
            and np.isfinite(sync)):
        fail("FID of identical sets, IS or Sync-C is wrong")

    # Inception and I3D on the card against the CPU, same weights
    inc_cpu = InceptionFeatures(device="cpu")
    inc_cpu.model.load_state_dict(inc.model.state_dict())
    x = flat[:2]
    e_inc = _rel_l2(torch.from_numpy(inc(x)), torch.from_numpy(inc_cpu(x)))
    i3d_card = I3DVideoFeatures(i3d_path)
    i3d_cpu = I3DVideoFeatures(i3d_path, device="cpu")
    v = real[:1].transpose(0, 4, 1, 2, 3)
    e_i3d = _rel_l2(torch.from_numpy(i3d_card(v)),
                    torch.from_numpy(i3d_cpu(v)))
    log(f"[24] card vs CPU relative L2: Inception features {e_inc:.3g}, "
        f"I3D features {e_i3d:.3g} (tol 5e-3, which allows TF32 "
        f"convolutions; {tf32_state()})")
    if e_inc > 5e-3 or e_i3d > 5e-3:
        fail("Inception / I3D on the card disagree with the CPU")
    shutil.rmtree(os.path.join(WORK, "eval"), ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 25-28: the Qwen prompt expander, the XLM-R text tower, the exported
# CFG step and the tools

QWEN = dict(lens=(256, 200), new_tokens=128, seed=41)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores


class _StubChatTokenizer:
    """A chat template over a byte vocabulary: no tokenizer files exist
    here (tests/test_qwen_expander.py's stub)."""

    eos_token_id = 2

    def apply_chat_template(self, msgs, tokenize=False,
                            add_generation_prompt=True):
        return "\n".join(f"{m['role']}: {m['content']}" for m in msgs)

    def __call__(self, texts, return_tensors="np"):
        import numpy as np

        class R:
            input_ids = np.asarray([[3 + (b % 120)
                                     for b in texts[0].encode()]], np.int32)
        return R()

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(97 + int(t) % 26) for t in ids)


def _device_ms(fn) -> float:
    """Summed device time (ms) of the CUDA kernels one run of `fn`
    launches (torch.profiler / CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def phase_qwen():
    """[25] Qwen2.5-3B at full width: random bf16 weights written as an HF
    directory and read by `load_qwen_checkpoint` (fp32 on the card); a
    right-padded batch of 2 prompts, greedy, 128 new tokens, held against
    teacher-forced argmax; 2 layers of the width card vs CPU; the prompt
    expander's Qwen route on the card."""
    import dataclasses
    import torch
    from safetensors.torch import save_file
    from omnihuman_tpu_torch.models import qwen as pq
    from omnihuman_tpu_torch.utils.prompt_extend import QwenPromptExpander

    cfg = pq.QWEN_CONFIGS["qwen2.5-3b"]
    d = os.path.join(WORK, "qwen2.5-3b")
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    src = pq.build_qwen(cfg, "cuda", torch.bfloat16, seed=QWEN["seed"])
    sd = {k: v.cpu() for k, v in src.state_dict().items()}
    del src
    torch.cuda.empty_cache()
    n_params = sum(v.numel() for v in sd.values())
    save_file(sd, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"architectures": ["Qwen2ForCausalLM"],
                   "hidden_size": cfg.dim,
                   "intermediate_size": cfg.ffn_dim,
                   "num_hidden_layers": cfg.num_layers,
                   "num_attention_heads": cfg.num_heads,
                   "num_key_value_heads": cfg.num_kv_heads,
                   "vocab_size": cfg.vocab_size,
                   "rope_theta": cfg.rope_theta,
                   "rms_norm_eps": cfg.rms_eps,
                   "tie_word_embeddings": True,
                   "torch_dtype": "bfloat16"}, f)
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, lcfg = pq.load_qwen_checkpoint(d, device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if lcfg != cfg:
        fail(f"load_qwen_checkpoint read {lcfg}, not {cfg}")
    loaded = model.state_dict()
    for k in ("model.embed_tokens.weight", "model.layers.0.self_attn.q_proj."
              "weight", f"model.layers.{cfg.num_layers - 1}.mlp.down_proj."
              "weight"):
        if not torch.equal(loaded[k].cpu(), sd[k].float()):
            fail(f"{k} loaded differs from the file")
    del sd, loaded
    weights_gb = n_params * 4 / 1e9
    log(f"[25] Qwen2.5-3B: {n_params / 1e9:.3f} B parameters; random bf16 "
        f"weights written as an HF directory in {t_write:.1f} s, loaded by "
        f"load_qwen_checkpoint (fp32, {weights_gb:.2f} GB) in {t_load:.1f} "
        f"s; config {lcfg}")

    gen = torch.Generator(device="cuda").manual_seed(43)
    l0 = max(QWEN["lens"])
    prompt = torch.randint(0, cfg.vocab_size, (2, l0), generator=gen,
                           device="cuda")
    lens = torch.tensor(QWEN["lens"], device="cuda")
    prompt[1, QWEN["lens"][1]:] = 0
    n_new = QWEN["new_tokens"]

    def generate(n, graph=True):
        return pq.qwen_generate(model, prompt, lens, n, cuda_graph=graph)

    out = generate(n_new)
    out_eager = generate(n_new, graph=False)
    torch.cuda.synchronize()
    if not torch.equal(out, out_eager):
        fail("the CUDA-graph decode and the eager decode give other tokens")
    prefill_ms = bench_ms(lambda: generate(1), reps=7, warmup=1)
    ms = {}
    for graph in (True, False):     # 2 tokens: the first step (and capture)
        two = bench_ms(lambda: generate(2, graph), reps=3, warmup=0)
        full = bench_ms(lambda: generate(n_new, graph), reps=3, warmup=0)
        ms[graph] = (two, full, (full - two) / (n_new - 2))
    dev_tok = (_device_ms(lambda: generate(17, False))
               - _device_ms(lambda: generate(1, False))) / 16
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    bound_ms = weights_gb * 1e9 / PEAK_BYTES * 1e3
    prefill_flop = 2.0 * n_params * sum(QWEN["lens"])
    log(f"[25] generate 2 prompts ({QWEN['lens']} tokens, right-padded), "
        f"greedy, {n_new} new tokens, the same tokens with and without the "
        f"CUDA graph: prefill {prefill_ms:.2f} ms ({prefill_flop / 1e12:.2f}"
        f" TFLOP in the linears: {prefill_flop / PEAK_FP32_FLOPS * 1e3:.1f} "
        f"ms at the fp32 rate); decode a token {ms[True][2]:.2f} ms with the "
        f"graph, {ms[False][2]:.2f} ms eager, against the weight-read bound "
        f"{bound_ms:.2f} ms ({weights_gb:.2f} GB / 3.35 TB/s); the device's "
        f"kernel time a token {dev_tok:.2f} ms (busy {100 * dev_tok / ms[True][2]:.1f}"
        f"% with the graph, {100 * dev_tok / ms[False][2]:.1f}% eager); the "
        f"first step with its capture {ms[True][0] - prefill_ms:.1f} ms; "
        f"request {ms[True][1]:.1f} ms ({ms[False][1]:.1f} eager); peak "
        f"{peak:.2f} GiB above the "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB held")

    # teacher-forced check: each generated token is its row's argmax
    seqs = torch.zeros((2, l0 + n_new), dtype=torch.int64, device="cuda")
    for r, n in enumerate(QWEN["lens"]):
        seqs[r, :n] = prompt[r, :n]
        seqs[r, n:n + n_new] = out[r]
    logits = pq.qwen_forward(model, seqs, lens + n_new)
    rows = torch.stack([torch.arange(n - 1, n - 1 + n_new, device="cuda")
                        for n in QWEN["lens"]])
    sel = torch.gather(logits, 1, rows[..., None].expand(
        -1, -1, logits.shape[-1]))                     # [2, T, V]
    chosen = torch.gather(sel, 2, out[..., None])[..., 0]
    top, low = sel.max(-1).values, sel.min(-1).values
    gap = ((top - chosen) / (top - low)).max().item()
    log(f"[25] teacher-forced qwen_forward over prompt + output: the worst "
        f"generated token sits {gap:.3g} of its row's logit range below the "
        f"row's maximum (tol 1e-4); {int((chosen == top).sum())} of "
        f"{2 * n_new} are the exact argmax")
    if gap > 1e-4:
        fail("qwen_generate disagrees with step-by-step argmax")
    del logits, sel

    e = QwenPromptExpander(checkpoint_path=d, device="cuda",
                           max_new_tokens=16)
    e._tok = _StubChatTokenizer()
    e._qwen = (model, lcfg)          # the checkpoint loaded above
    t0 = time.perf_counter()
    res = e("a red fox running through fresh snow at sunrise", seed=5)
    torch.cuda.synchronize()
    log(f"[25] QwenPromptExpander on the card: status {res.status}, "
        f"message {res.message!r}, {len(res.prompt)} characters in "
        f"{time.perf_counter() - t0:.2f} s")
    if not (res.status and res.message == "qwen-torch"):
        fail("the prompt expander did not take the Qwen route on the card")
    del model, e
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)

    # 2 layers of the 3B width on the card against the CPU (fp32)
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    m2 = pq.build_qwen(cfg2, "cpu", seed=44)
    g = torch.Generator().manual_seed(45)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    lens2 = torch.tensor([64, 40])
    want = pq.qwen_forward(m2, toks, lens2)
    want_gen = pq.qwen_generate(m2, toks, lens2, 8)
    m2 = m2.to("cuda")
    got = pq.qwen_forward(m2, toks.cuda(), lens2.cuda()).cpu()
    got_gen = pq.qwen_generate(m2, toks.cuda(), lens2.cuda(), 8).cpu()
    err = (got - want).abs().max().item() / want.abs().max().item()
    log(f"[25] 2 layers of the 3B width, card vs CPU: logits max abs err "
        f"{err:.3g} of the peak (tol 1e-4; {tf32_state()}); 8 greedy "
        f"tokens equal: {torch.equal(got_gen, want_gen)}")
    if err > 1e-4 or not torch.equal(got_gen, want_gen):
        fail("Qwen on the card disagrees with the CPU")
    del m2


def phase_xlmr():
    """[26] The XLM-R text tower at full width (24 layers, dim 1024,
    vocab 250,002), 2 x 514 ids with padding: ms and peak memory; 2 layers
    of the width card vs CPU."""
    import dataclasses
    import torch
    from omnihuman_tpu_torch.configs.wan import CLIPConfig
    from omnihuman_tpu_torch.models.clip import (
        build_clip, clip_textual_forward)

    cfg = CLIPConfig()

    def ids_on(device):
        g = torch.Generator().manual_seed(52)
        ids = torch.randint(2, cfg.vocab_size, (2, cfg.max_text_len),
                            generator=g)
        ids[0, 512:] = cfg.pad_id       # 512 tokens: the last position
        ids[1, 300:] = cfg.pad_id
        return ids.to(device)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_clip(cfg, "cuda", torch.float32, seed=51, text=True)
    n_text = sum(p.numel() for p in model.textual.parameters())
    ids = ids_on("cuda")

    def run():
        with torch.inference_mode():
            return clip_textual_forward(model, ids)

    out = run()
    torch.cuda.synchronize()
    if tuple(out.shape) != (2, cfg.embed_dim) or not torch.isfinite(out).all():
        fail(f"text tower output {tuple(out.shape)} not finite / wrong shape")
    ms = bench_ms(run, reps=7, warmup=1)
    d, s, n = cfg.text_dim, cfg.max_text_len, 2
    per_tok = 2.0 * cfg.text_layers * (4 * d * d + 8 * d * d)
    flop = per_tok * n * s + cfg.text_layers * n * 4.0 * s * s * d
    bound = max(flop / PEAK_FP32_FLOPS, n_text * 4 / PEAK_BYTES) * 1e3
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    log(f"[26] XLM-R text tower: {n_text / 1e9:.3f} B parameters (fp32); "
        f"2 x {s} ids (512 and 300 valid): {ms:.2f} ms ({flop / 1e12:.2f} "
        f"TFLOP, fp32 bound {bound:.2f} ms); peak {peak:.2f} GiB with the "
        f"visual tower it is built beside")
    del model
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(cfg, text_layers=2, vision_layers=1)
    m2 = build_clip(cfg2, "cpu", torch.float32, seed=53, text=True)
    with torch.inference_mode():
        want = clip_textual_forward(m2, ids_on("cpu"))
        got = clip_textual_forward(m2.to("cuda"), ids_on("cuda")).cpu()
    err = _rel_l2(got, want)
    log(f"[26] 2 layers of the width, card vs CPU: relative L2 {err:.3g} "
        f"(tol 1e-5, fp32; {tf32_state()})")
    if err > 1e-5:
        fail("the XLM-R text tower on the card disagrees with the CPU")
    return ms


def phase_export(all_kernels, pipe):
    """[27] The exported t2v-1.3B `fast` CFG step at the flagship geometry
    (phase 5's model and weights): export, save, load, then the loaded
    program against the eager step, its K1 launches and ms; then the i2v
    step at the i2v-14B width cut to 2 layers. Returns the exported t2v
    step's launch counts."""
    import dataclasses
    import torch
    from omnihuman_tpu_torch.configs import I2V_14B, T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    from omnihuman_tpu_torch.pipelines.text2video import cfg_model_step
    from omnihuman_tpu_torch.utils.export import (
        export_i2v_denoise_step, export_t2v_denoise_step, load_exported)

    d = os.path.join(WORK, "export")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "t2v_1.3B_480x832_81f.pt2")
    w, h = FLAGSHIP["size"]
    t0 = time.perf_counter()
    export_t2v_denoise_step(T2V_1_3B, (w, h), FLAGSHIP["frames"], path,
                            platforms=("cuda",), precision="fast")
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    step = load_exported(path)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.export.save(step.program, path.replace(".pt2", "_again.pt2"))
    t_save = time.perf_counter() - t0
    log(f"[27] t2v-1.3B fast step exported (trace and save) in "
        f"{t_export:.1f} s ({t_save:.2f} s of it the save, "
        f"{os.path.getsize(path) / 1e6:.1f} MB), loaded in {t_load:.2f} s; "
        f"metadata {step.metadata['seq_len']} tokens, "
        f"{len(step.metadata['in_avals'])} inputs")

    dev, mc = pipe.device, pipe.config.model
    gen = torch.Generator(device=dev).manual_seed(71)
    lat = pipe.latent_shape((w, h), FLAGSHIP["frames"])
    seq = step.metadata["seq_len"]
    x = torch.randn((1,) + lat, generator=gen, device=dev)
    t = torch.tensor(900.0, device=dev)
    ctx2 = torch.randn((2, mc.text_len, mc.text_dim), generator=gen,
                       device=dev).to(torch.bfloat16)

    def rope(lat_fhw):
        grid = tuple(n // p for n, p in zip(lat_fhw, mc.patch_size))
        return rope_angles_3d(grid, mc.head_dim, seq_len=seq, device=dev)

    sin, cos = rope(lat[1:])
    params = pipe.model.state_dict()

    def exported():
        return step.call(params, x, t, ctx2, sin, cos)

    def eager():
        with torch.inference_mode():
            return cfg_model_step(pipe.model, x, 900.0, ctx2, sin, cos,
                                  policy=pipe.policy, seq_len=seq,
                                  guide_scale=5.0)

    _zero(all_kernels)
    got = exported()
    torch.cuda.synchronize()
    counts = _count(all_kernels)
    want = eager()
    same = torch.equal(got, want)
    rel = 0.0 if same else _rel_l2(got, want)
    log(f"[27] exported step vs eager cfg_model_step on the same weights and "
        f"inputs: bit-equal {same}, relative L2 {rel:.3g} (tol 1e-3 where "
        f"not bit-equal); launches of one exported step {counts}")
    if not torch.isfinite(got).all() or (not same and rel > 1e-3):
        fail("the exported step disagrees with the eager step")
    if _differ(counts, _want(all_kernels, NUM_LAYERS, NUM_LAYERS)):
        fail(f"the exported step did not launch K1 {NUM_LAYERS} + "
             f"{NUM_LAYERS} times")
    ms_exp = bench_ms(exported, reps=3, warmup=1)
    ms_eager = bench_ms(eager, reps=3, warmup=1)
    log(f"[27] ms a step at {seq} tokens, text {mc.text_len} keys "
        f"untrimmed: exported {ms_exp:.1f}, eager {ms_eager:.1f} "
        f"({100 * (ms_exp / ms_eager - 1):+.2f}%)")
    del got, want, params
    torch.cuda.empty_cache()

    mcfg = dataclasses.replace(I2V_14B.model, num_layers=2)
    icfg = dataclasses.replace(I2V_14B, model=mcfg)
    model = build_wan_model(mcfg, dev, torch.bfloat16, seed=61)
    with torch.no_grad():
        model.head.head.weight.normal_(
            0.0, mcfg.dim ** -0.5,
            generator=torch.Generator(device=dev).manual_seed(62))
    ipath = os.path.join(d, "i2v_14B_2layers.pt2")
    t0 = time.perf_counter()
    export_i2v_denoise_step(icfg, (w, h), 17, ipath, platforms=("cuda",),
                            precision="fast")
    istep = load_exported(ipath)
    t_i = time.perf_counter() - t0
    seq = istep.metadata["seq_len"]
    ilat = pipe.latent_shape((w, h), 17)
    x = torch.randn((1,) + ilat, generator=gen, device=dev)
    y2 = torch.randn((2, mcfg.in_dim - 16) + ilat[1:], generator=gen,
                     device=dev)
    clip2 = torch.randn((2, mcfg.clip_tokens, mcfg.clip_embed_dim),
                        generator=gen, device=dev).to(torch.bfloat16)
    ctx2 = torch.randn((2, mcfg.text_len, mcfg.text_dim), generator=gen,
                       device=dev).to(torch.bfloat16)
    isin, icos = rope(ilat[1:])
    _zero(all_kernels)
    got = istep.call(model.state_dict(), x, t, ctx2, y2, clip2, isin, icos)
    torch.cuda.synchronize()
    icounts = _count(all_kernels)
    with torch.inference_mode():
        want = cfg_model_step(
            model, x, 900.0, ctx2, isin, icos, seq_len=seq, guide_scale=5.0,
            policy=dataclasses.replace(I2V_14B.policy,
                                       residual=torch.bfloat16),
            y=y2, clip_fea=clip2)
    same = torch.equal(got, want)
    rel = 0.0 if same else _rel_l2(got, want)
    log(f"[27] i2v-14B width, 2 layers, 17 frames ({seq} tokens): exported "
        f"and loaded in {t_i:.1f} s; vs eager: bit-equal {same}, relative "
        f"L2 {rel:.3g}; launches {icounts}")
    if not torch.isfinite(got).all() or (not same and rel > 1e-3):
        fail("the exported i2v step disagrees with the eager step")
    if _differ(icounts, _want(all_kernels, 2, 4)):
        fail("the exported i2v step did not launch K1 2 + 4 times")
    del model, got, want
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(d, ignore_errors=True)
    return counts


def phase_tools(all_kernels):
    """[28] `cli.generate --profile DIR --use_prompt_extend` at phase 5's
    geometry; the trace names K1's, K3's and K4's kernels; the template
    expander's prompt went in; `anomaly_detection` on the card;
    `log_device_memory`. Returns the request's launch counts."""
    import logging
    import torch
    from omnihuman_tpu_torch.cli import generate as cli_gen
    from omnihuman_tpu_torch.ops.flash_attention import flash_fwd
    from omnihuman_tpu_torch.utils.logging import (
        anomaly_detection, log_device_memory)

    os.environ.pop("DASH_API_KEY", None)
    d = os.path.join(WORK, "profile")
    os.makedirs(d, exist_ok=True)
    w, h = SMOKE["size"]
    prompt, seed = SMOKE["requests"][0]
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    lg = logging.getLogger("omnihuman_tpu_torch")
    keep = Keep()
    lg.addHandler(keep)
    _zero(all_kernels)
    t0 = time.perf_counter()
    try:
        cli_gen.main(["--task", "t2v-1.3B", "--size", f"{h}*{w}",
                      "--frame_num", str(SMOKE["frames"]), "--sample_steps",
                      str(SMOKE["steps"]), "--base_seed", str(seed),
                      "--prompt", prompt, "--profile", d,
                      "--use_prompt_extend",
                      "--save_file", os.path.join(d, "clip.mp4")])
    finally:
        lg.removeHandler(keep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _count(all_kernels)
    trace = os.path.join(d, "trace.json")
    with open(trace) as f:
        text = f.read()
    named = {k: text.count(k) for k in ("flash_fwd_kernel",
                                        "vae_conv_kernel",
                                        "vae_upsample_kernel")}
    extended = [ln for ln in lines if ln.startswith("prompt extended")]
    log(f"[28] cli.generate --profile --use_prompt_extend: {wall:.1f} s; "
        f"trace {os.path.getsize(trace) / 1e6:.1f} MB naming {named}; "
        f"launches {counts}; {extended[:1]}")
    if not all(named.values()):
        fail("the profiler trace does not name K1's, K3's and K4's kernels")
    if not extended or "template-expanded" not in extended[0]:
        fail("the prompt was not expanded")
    if _differ(counts, _want(all_kernels, 120, 120, 0, 140, 15)):
        fail("the profiled request's launches differ from phase 19's")

    q = torch.randn((1, 2048, 2, 128), device="cuda").to(torch.bfloat16)
    with anomaly_detection():
        flash_fwd(q, q, q)                  # K1 under the check: clean
        try:
            torch.log(torch.full((4,), -1.0, device="cuda"))
        except FloatingPointError as e:
            caught = str(e)
        else:
            fail("anomaly_detection did not raise at a NaN on the card")
    stats = log_device_memory("[28]")
    log(f"[28] anomaly_detection on the card: {caught}; log_device_memory: "
        f"{stats}")
    if len(stats) != torch.cuda.device_count() or \
            min(v[1] for v in stats.values()) < 10:
        fail("log_device_memory did not report the card")
    shutil.rmtree(d, ignore_errors=True)
    return counts


SP_SIZES = (2, 4)


def _sp_row(tag, fn, b, lq, n, d, k_valid, lib_args=None, k_lens=None,
            lse=False):
    """Time `fn` (CUDA events, median of 7), the bound of its attention
    and, on (q, k, v) `lib_args`, the plain version on the same inputs and
    the library's flash forward with the LSE (unmasked, a yardstick the
    port never calls); log one K1 row."""
    import torch
    from omnihuman_tpu_torch.ops.flash_attention import flash_attention_plain
    ms = bench_ms(fn)
    bound, bound_by = attention_bound(b, lq, n, d, k_valid)
    lib_ms = plain_ms = None
    if lib_args is not None:
        plain_ms = round(bench_ms(lambda: flash_attention_plain(
            *lib_args, k_lens=k_lens, return_lse=lse), reps=3, warmup=1), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in lib_args)
        try:
            lib_ms = round(bench_ms(
                lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                    qt, kt, vt)), 3)
        except (RuntimeError, AttributeError) as e:
            lib_ms = f"not measured ({e})"
    log(f"[29] K1 {tag}: {ms:.3f} ms, bound {bound:.3f} ms ({bound_by}, "
        f"{100 * bound / ms:.1f}%), plain {plain_ms} ms, library flash "
        f"forward with LSE {lib_ms} ms")
    return ms, bound


def phase_sp_programs():
    """[29a] The sequence-parallel per-rank programs at flagship width on
    one card (B=2, N=12, D=128, bf16, 32,768 tokens, 32,760 valid): for
    each virtual rank of sp 2 and 4, `ring_forward_hop` (K1 with the LSE,
    the fp32 merge) over its query shard and every K / V shard in ring
    order, concatenated and held against one K1 call over the whole; each
    hop's K1 and merge timed on rank 0's program; then every rank's
    Ulysses program (the port's buffer layouts and `ulysses_local`, K1 over
    all tokens at N / sp heads, the all-to-alls emulated) and sp_cross
    (`sp_cross_local`, K1 at Lq / sp against 128 / 512 text keys) against
    the whole call."""
    import torch
    from omnihuman_tpu_torch.ops import ring_attention as ra
    from omnihuman_tpu_torch.ops.flash_attention import (
        flash_attention_cuda, flash_fwd)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2929)
    b, n, d = 2, 12, 128
    L, valid = FLAGSHIP["seq_len"], FLAGSHIP["tokens"]

    def rnd(l, heads=n):
        return torch.randn((b, l, heads, d), generator=gen, device=dev
                           ).to(torch.bfloat16)

    q, k, v = rnd(L), rnd(L), rnd(L)
    kl = torch.tensor([valid] * b, dtype=torch.int32, device=dev)
    whole = flash_attention_cuda(q, k, v, k_lens=kl)
    whole_ms = bench_ms(lambda: flash_attention_cuda(q, k, v, k_lens=kl))
    tol = 2 ** -6 * whole.float().abs().max().item()
    log(f"[29] whole K1 call (32,768 tokens, k_len 32,760): "
        f"{whole_ms:.3f} ms; tolerance 2^-6 of the peak = {tol:.3g}")

    def check(tag, got, want):
        err = (got.float() - want.float()).abs().max().item()
        if not torch.isfinite(got.float()).all() or err > tol:
            fail(f"[29] {tag}: max abs err {err} > {tol} against the whole "
                 f"K1 call")
        return err

    scale = d ** -0.5
    for sp in SP_SIZES:
        lq = L // sp
        outs = []
        for r in range(sp):
            qs = q[:, r * lq:(r + 1) * lq].contiguous()
            o = lse = None          # the first hop seeds the accumulator
            hops = []
            for i in range(sp):
                src = (r + i) % sp
                kc = k[:, src * lq:(src + 1) * lq].contiguous()
                vc = v[:, src * lq:(src + 1) * lq].contiguous()
                klc = (kl - src * lq).clamp(0, lq)
                hops.append((kc, vc, klc))
                o, lse = ra.ring_forward_hop(qs, kc, vc, klc, o, lse,
                                             (r * lq, src * lq), scale=scale)
            outs.append(o.to(torch.bfloat16))
            if r:
                continue
            # rank 0's hops, each split into its K1 launch and the merge
            rank_ms, k1_total = 0.0, 0.0
            for i, (kc, vc, klc) in enumerate(hops):
                o_i, lse_i = flash_fwd(qs, kc, vc, k_lens=klc,
                                       return_lse=True)
                of = o_i.float()
                k1_ms, bound = _sp_row(
                    f"ring hop sp {sp} hop {i} (Lq = Lk = {lq}, k_len "
                    f"{klc.tolist()})",
                    lambda: flash_fwd(qs, kc, vc, k_lens=klc,
                                      return_lse=True),
                    b, lq, n, d, klc.tolist(),
                    lib_args=(qs, kc, vc) if i == 0 else None, k_lens=klc,
                    lse=True)
                merge_ms = (bench_ms(lambda: ra._merge(o, lse, of, lse_i))
                            if i else 0.0)   # hop 0 seeds, no merge
                log(f"[29] ring sp {sp} rank 0 hop {i}: K1 {k1_ms:.3f} ms "
                    f"(bound {bound:.3f}), merge {merge_ms:.3f} ms")
                rank_ms += k1_ms + merge_ms
                k1_total += k1_ms
            log(f"[29] ring sp {sp}: rank 0's program {rank_ms:.3f} ms "
                f"(K1 {k1_total:.3f}, merge {rank_ms - k1_total:.3f}) "
                f"against 1/{sp} of the whole call {whole_ms / sp:.3f} ms "
                f"(x{rank_ms / (whole_ms / sp):.2f}); the rank's bound "
                f"{attention_bound(b, lq, n, d, [valid] * b)[0]:.3f} ms")
        err = check(f"ring sp {sp}", torch.cat(outs, dim=1), whole)
        log(f"[29] ring sp {sp}: {sp} ranks x {sp} hops concatenated vs "
            f"the whole call: max abs err {err:.3g}")
        del outs, hops

        # Ulysses: every rank's program, the all-to-alls emulated (rank r
        # receives part r of every rank's buffer)
        nh = n // sp

        def exchange(bufs):
            return [torch.stack([x[r] for x in bufs]) for r in range(sp)]

        def to_heads(x):
            return [ra.ulysses_gather_tokens(buf) for buf in exchange(
                [ra.ulysses_split_heads(x[:, r * lq:(r + 1) * lq], sp)
                 for r in range(sp)])]

        heads = list(zip(to_heads(q), to_heads(k), to_heads(v)))
        per_rank = [ra.ulysses_local(qh, kh, vh, kl) for qh, kh, vh in heads]
        qh, kh, vh = heads[0]
        got = torch.cat([ra.ulysses_gather_heads(buf) for buf in exchange(
            [ra.ulysses_split_tokens(o, sp) for o in per_rank])], dim=1)
        err = check(f"ulysses sp {sp}", got, whole)
        u_ms, _ = _sp_row(f"ulysses sp {sp} ({nh} heads, L {L}, k_len "
                          f"{valid})",
                          lambda: ra.ulysses_local(qh, kh, vh, kl),
                          b, L, nh, d, [valid] * b, lib_args=(qh, kh, vh),
                          k_lens=kl)
        log(f"[29] ulysses sp {sp}: {sp} ranks' programs vs the whole "
            f"call: max abs err {err:.3g}; K1 {u_ms:.3f} ms against 1/{sp} "
            f"of the whole call {whole_ms / sp:.3f} ms")
        del qh, kh, vh, heads, per_rank, got

        # sp_cross: the rank's queries against the whole text context
        for lc in (128, 512):
            kt, vt = rnd(lc), rnd(lc)
            ktl = torch.tensor([37, lc], dtype=torch.int32, device=dev)
            full = flash_attention_cuda(q, kt, vt, k_lens=ktl)
            full_ms = bench_ms(lambda: flash_attention_cuda(q, kt, vt,
                                                            k_lens=ktl))
            errs = []
            for r in range(sp):
                qs = q[:, r * lq:(r + 1) * lq].contiguous()
                errs.append(check(
                    f"sp_cross sp {sp} Lc {lc} rank {r}",
                    ra.sp_cross_local(qs, kt, vt, r, sp, k_lens=ktl),
                    full[:, r * lq:(r + 1) * lq]))
            c_ms, _ = _sp_row(
                f"sp_cross sp {sp} (Lq {lq}, Lc {lc}, k_lens (37, {lc}))",
                lambda: ra.sp_cross_local(qs, kt, vt, sp - 1, sp,
                                          k_lens=ktl),
                b, lq, n, d, [37, lc], lib_args=(qs, kt, vt), k_lens=ktl)
            log(f"[29] sp_cross sp {sp} Lc {lc}: max abs err "
                f"{max(errs):.3g}; K1 {c_ms:.3f} ms against 1/{sp} of the "
                f"whole call {full_ms / sp:.3f} ms")
    del q, k, v, whole
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sp_request(pipe):
    """Phase 5's first request (17 frames at 480x832, 4 steps) as latents,
    with its seconds and stage seconds."""
    import torch
    w, h = SMOKE["size"]
    prompt, seed = SMOKE["requests"][0]
    t0 = time.perf_counter()
    lat = pipe.generate(prompt, size=(w, h), frame_num=SMOKE["frames"],
                        sampling_steps=SMOKE["steps"], seed=seed,
                        return_latents=True)
    torch.cuda.synchronize()
    return lat, time.perf_counter() - t0, dict(pipe.timings)


def phase_sp_serve(all_kernels, pipe):
    """[29b] The mesh path through the real entry points on a one-rank NCCL
    group: `WanT2V(mesh=create_mesh(MeshConfig(1, 1, 1)))` on phase 5's
    weights (the ring and sp_cross at sp 1, FSDP2 over one rank, umT5
    resident), phase 5's first request as latents, held against phase 5's
    pipeline's latents for it, and its video decoded; launch counts zeroed
    just before the request and read just after the decode. Returns (the
    counts, the latents)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from omnihuman_tpu_torch.models.vae import vae_decode
    from omnihuman_tpu_torch.ops.vae_kernels import VAE_CONV, VAE_UPSAMPLE
    from omnihuman_tpu_torch.parallel import MeshConfig, create_mesh
    from omnihuman_tpu_torch.parallel.mesh import (
        self_attention_route, use_mesh)

    want, want_s, want_t = _sp_request(pipe)
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = create_mesh(MeshConfig(1, 1, 1))
        t0 = time.perf_counter()
        mp = t2v_pipe(mesh)
        torch.cuda.synchronize()
        with use_mesh(mp.mesh):
            route = self_attention_route()
        log(f"[29] WanT2V(t2v-1.3B, mesh (1, 1, 1)) built in "
            f"{time.perf_counter() - t0:.1f} s: attn route {route}, "
            f"sp {mp.sp_size}, FSDP2 on the DiT: "
            f"{isinstance(mp.model, FSDPModule)} and its blocks: "
            f"{all(isinstance(b, FSDPModule) for b in mp.model.blocks)}")
        if route != "ring" or not isinstance(mp.model, FSDPModule):
            fail("[29] the mesh pipeline did not take the mesh plan")
        _zero(all_kernels)
        got, got_s, got_t = _sp_request(mp)
        video = vae_decode(mp.vae, got, streaming=True)
        counts = _count(all_kernels)
        if not torch.isfinite(video.float()).all() or tuple(
                video.shape[2:]) != (SMOKE["frames"], SMOKE["size"][1],
                                     SMOKE["size"][0]):
            fail(f"[29] mesh video {tuple(video.shape)} not finite / shaped")
        if not isinstance(mp._t5, FSDPModule):
            fail("[29] umT5 is not sharded by FSDP2 on the mesh")
        if next(mp._t5.parameters()).device.type != "cuda":
            fail("[29] umT5 left the card under a mesh")
        steps = SMOKE["steps"]
        want_n = NUM_LAYERS * steps
        log(f"[29] mesh request launches {counts}, expected {want_n} K1 "
            f"long-K and {want_n} short-K (the ring's one hop and sp_cross, "
            f"cond + uncond in one batch), K3 and K4 in the decode")
        if (counts["flash_fwd (Lk > 1024)"] != want_n
                or counts["flash_fwd (Lk <= 1024)"] != want_n):
            fail("[29] the mesh path did not send every attention through K1")
        if not counts[VAE_CONV.name] or not counts[VAE_UPSAMPLE.name]:
            fail("[29] the mesh video's decode did not launch K3 and K4")
        diff = got.float() - want.float()
        rel = (diff.norm() / want.float().norm()).item()
        log(f"[29] mesh latents vs phase 5's pipeline: bit-equal "
            f"{torch.equal(got, want)}, max abs {diff.abs().max().item():.3g}"
            f", relative L2 {rel:.3g} (bit-equal expected; tolerance 1e-3 "
            f"relative L2)")
        if rel > 1e-3 or not torch.isfinite(got).all():
            fail("[29] the mesh path's latents differ from phase 5's")
        log(f"[29] request seconds: mesh {got_s:.2f} (T5 encode "
            f"{got_t.get('t5_encode_s', 0):.2f}, {steps} steps "
            f"{got_t['denoise_s']:.2f} s = "
            f"{got_t['denoise_s'] / steps * 1e3:.1f} ms/step), unsharded "
            f"{want_s:.2f} ({want_t['denoise_s'] / steps * 1e3:.1f} "
            f"ms/step)")
        # where a mesh step's extra time goes: a second (warm) request,
        # then one profiled request of each pipeline
        _, _, again_t = _sp_request(mp)
        prof = {}
        for tag, p_ in (("unsharded", pipe), ("mesh", mp)):
            prof[tag] = kernel_split(lambda: _sp_request(p_), cpu=True)
        log(f"[29] mesh request again: "
            f"{again_t['denoise_s'] / steps * 1e3:.1f} ms/step; device "
            f"kernel time of one request: " + "; ".join(
                f"{tag} {total:.1f} ms (" + ", ".join(
                    f"{k.split(' (')[0]} {v:.1f}" for k, v in groups.items())
                + ")" for tag, (groups, total, _) in prof.items()))
        base = {e.key: e.self_device_time_total
                for e in prof["unsharded"][2]}
        extra = sorted(((e.self_device_time_total - base.get(e.key, 0), e)
                        for e in prof["mesh"][2]), key=lambda x: -x[0])
        for dt, e in extra[:5]:
            log(f"[29]   mesh - unsharded {dt / 1e3:+8.2f} ms "
                f"x{e.count:<5d} {e.key[:90]}")
        del mp, video
        return counts, got
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def _gloo_probe_rank(rank, port, out_dir):
    """One of two processes on one card: does gloo carry CUDA tensors for
    batch_isend_irecv and all_to_all_single?"""
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    res = {}
    x = torch.arange(8, dtype=torch.float32, device="cuda") + 10 * rank
    try:
        got = torch.empty_like(x)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, 1 - rank),
                dist.P2POp(dist.irecv, got, 1 - rank)]):
            w.wait()
        res["batch_isend_irecv"] = (
            "ok" if got[0].item() == 10 * (1 - rank)
            else f"wrong value {got[0].item()}")
    except Exception as e:       # the finding is the message
        res["batch_isend_irecv"] = f"{type(e).__name__}: {e}"[:200]
    try:
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        want = [4.0 * rank + i for i in range(4)]
        res["all_to_all_single"] = (
            "ok" if out.tolist() == want + [10 + w for w in want]
            else f"wrong values {out.tolist()}")
    except Exception as e:
        res["all_to_all_single"] = f"{type(e).__name__}: {e}"[:200]
    with open(os.path.join(out_dir, f"gloo{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def phase_sp_multi(latents_b):
    """[29c] With two or more cards: `torchrun` runs this script's
    --sp-worker mode (the mesh pipeline on phase 5's weights at sp n),
    whose latents are held against (b)'s, and `cli.generate --sp_size n`
    at phase 5's geometry. With one card, NCCL cannot hold two ranks:
    logged as not run, and two processes probe whether gloo carries CUDA
    tensors for the ring's and Ulysses' collectives."""
    import numpy as np
    import torch
    count = torch.cuda.device_count()
    os.makedirs(WORK, exist_ok=True)
    if count < 2:
        log(f"[29] (c) not run: {count} card; NCCL refuses two ranks on "
            f"one GPU (duplicate GPU), so sp > 1 over NCCL needs >= 2 cards")
        import torch.multiprocessing as tmp
        ctx = tmp.spawn(_gloo_probe_rank, args=(_free_port(), WORK),
                        nprocs=2, join=False)
        t_end = time.monotonic() + 120
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > t_end:
                    raise TimeoutError("still running after 120 s")
            found = [json.load(open(os.path.join(WORK, f"gloo{r}.json")))
                     for r in range(2)]
            log(f"[29] gloo with CUDA tensors, two processes on one card: "
                f"{found}")
        except Exception as e:
            log(f"[29] gloo probe failed: {type(e).__name__}: {e}")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return
    n = min(4, count)
    out = os.path.join(WORK, "sp_latents.npy")
    w, h = SMOKE["size"]
    prompt, seed = SMOKE["requests"][0]
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={n}"]
    t0 = time.perf_counter()
    r = subprocess.run(run + [os.path.abspath(__file__), "--sp-worker", out],
                       cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"[29] torchrun sp {n} worker failed:\n{r.stderr[-3000:]}")
    got = np.load(out)
    want = latents_b.float().cpu().numpy()
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(f"[29] (c) sp {n} over NCCL on {n} cards: {r.stdout.strip()}; "
        f"latents vs (b): relative L2 {rel:.3g} (tolerance 5e-2: the ring "
        f"merges bf16 chunk outputs in fp32); {time.perf_counter() - t0:.1f}"
        f" s with start-up")
    if rel > 5e-2:
        fail("[29] sp > 1 latents differ from the one-rank mesh's")
    r = subprocess.run(run + ["-m", "omnihuman_tpu_torch.cli.generate",
                              "--task", "t2v-1.3B", "--size", f"{h}*{w}",
                              "--frame_num", str(SMOKE["frames"]),
                              "--sample_steps", str(SMOKE["steps"]),
                              "--base_seed", str(seed), "--prompt", prompt,
                              "--sp_size", str(n), "--save_file",
                              os.path.join(WORK, "sp_cli.mp4")],
                       cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"[29] torchrun cli.generate --sp_size {n} failed:\n"
             f"{r.stderr[-3000:]}")
    log(f"[29] (c) torchrun cli.generate --sp_size {n}: "
        f"{r.stdout.strip().splitlines()[-1]}")


def sp_worker(out: str) -> None:
    """--sp-worker OUT, one rank under torchrun: the mesh (1, 1, world)
    pipeline on phase 5's weights, phase 5's first request; rank 0 saves
    the latents to OUT and prints the denoise ms a step."""
    import numpy as np
    import torch.distributed as dist
    from omnihuman_tpu_torch.parallel import (
        MeshConfig, create_mesh, init_distributed)
    dev = init_distributed()
    mesh = create_mesh(MeshConfig(1, 1, dist.get_world_size()))
    lat, _, timings = _sp_request(t2v_pipe(mesh, device=dev))
    if dist.get_rank() == 0:
        np.save(out, lat.float().cpu().numpy())
        print(f"{timings['denoise_s'] / SMOKE['steps'] * 1e3:.1f} ms/step",
              flush=True)
    dist.destroy_process_group()


def run_sp_phase(all_kernels, pipe, paths):
    """Phase 29 (a, b, c), timed, on phase 5's pipeline."""
    import torch
    t0 = time.perf_counter()
    try:
        phase_sp_programs()
        paths["sp_serve"], latents = phase_sp_serve(all_kernels, pipe)
        phase_sp_multi(latents)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[29] phase wall time {time.perf_counter() - t0:.1f} s (planned "
        f"under 90 s)")


# ---------------------------------------------------------------------------
# phase 30: sequence-parallel training


def _k2_row(tag, fn, rows_q, rows_k, pairs, n, d, lib_shape=None,
            plain=None):
    """Time `fn` (CUDA events, median of 7) beside the five-product bound,
    `plain` (its plain version, one timed run) and, for (B, Lq, Lk,
    heads) `lib_shape`, SDPA's backward at that unmasked shape (a
    yardstick the port never calls); log one K2 row. Returns (ms, bound
    ms)."""
    import torch
    import torch.nn.functional as F
    ms = bench_ms(fn)
    bound, by = backward_bound(rows_q, rows_k, pairs, n, d)
    plain_ms = (None if plain is None else
                round(bench_ms(plain, reps=1, warmup=0), 1))
    lib_ms = None
    if lib_shape is not None:
        b, lq, lk, heads = lib_shape
        g = torch.Generator(device="cuda").manual_seed(30)
        qt, kt, vt = (torch.randn((b, heads, l, d), generator=g,
                                  device="cuda", dtype=torch.bfloat16
                                  ).requires_grad_(True)
                      for l in (lq, lk, lk))
        ot = F.scaled_dot_product_attention(qt, kt, vt)
        dt = torch.randn_like(ot)
        lib_ms = round(bench_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dt, retain_graph=True)), 3)
        del qt, kt, vt, ot, dt
    log(f"[30] K2 {tag}: {ms:.3f} ms, bound {bound:.3f} ms ({by}, "
        f"{100 * bound / ms:.1f}%), plain {plain_ms} ms, SDPA backward "
        f"{lib_ms} ms")
    return ms, bound


def phase_sp_train_programs():
    """[30a] The sequence-parallel backward programs at flagship training
    width on one card (B=1, N=12, D=128, bf16, 32,768 tokens, 32,760
    valid): for every virtual rank of sp 2 and 4, the ring forward
    (`ring_forward_hop`) for the merged out / LSE, then `ring_backward_hop`
    over every K / V chunk in ring order (one K2 launch each, delta from
    the global O, dQ in one fp32 accumulator, dK / dV summed per chunk in
    fp32), concatenated and held against one K2 call over the whole;
    rank 0's hops timed against 1/sp of the whole call and the bound;
    every rank's Ulysses backward (K2 over all tokens at N/sp heads) and
    sp_cross backward (K2 at Lq/sp against 512 text keys, dK / dV summed
    over the ranks) held and timed the same way, each beside SDPA's
    backward at its shape."""
    import torch
    from omnihuman_tpu_torch.ops import ring_attention as ra
    from omnihuman_tpu_torch.ops.flash_attention import (
        bwd_delta, flash_attention_cuda, flash_bwd_cuda, flash_bwd_plain)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3030)
    b, n, d = 1, 12, 128
    L, valid = FLAGSHIP["seq_len"], FLAGSHIP["tokens"]

    def rnd(l, heads=n):
        return torch.randn((b, l, heads, d), generator=gen, device=dev
                           ).to(torch.bfloat16)

    q, k, v, do = rnd(L), rnd(L), rnd(L), rnd(L)
    kl = torch.tensor([valid], dtype=torch.int32, device=dev)
    out, lse = flash_attention_cuda(q, k, v, k_lens=kl, return_lse=True)
    whole = flash_bwd_cuda(q, k, v, out, lse, do, k_lens=kl)
    whole_ms = bench_ms(lambda: flash_bwd_cuda(q, k, v, out, lse, do,
                                               k_lens=kl))
    whole_bound = backward_bound(L, L, L * valid, n, d)[0]
    log(f"[30] whole K2 call (32,768 tokens, k_len 32,760, with its "
        f"wrapper): {whole_ms:.3f} ms, bound {whole_bound:.3f} ms")

    def check(tag, got, want):
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            err = (g.float() - w.float()).abs().max().item()
            tol = 2 ** -6 * w.float().abs().max().item()
            if not torch.isfinite(g.float()).all() or err > tol:
                fail(f"[30] {tag} {name}: max abs err {err} > {tol} "
                     f"(2^-6 of the peak) against the whole K2 call")
            errs.append(err)
        return max(errs)

    scale = d ** -0.5
    for sp in SP_SIZES:
        lq = L // sp
        sl = [slice(r * lq, (r + 1) * lq) for r in range(sp)]
        dqs = []
        dk = [torch.zeros((b, lq, n, d), dtype=torch.float32, device=dev)
              for _ in range(sp)]
        dv = [torch.zeros_like(x) for x in dk]
        for r in range(sp):
            qs, dos = q[:, sl[r]].contiguous(), do[:, sl[r]].contiguous()
            hops = []
            o = lse_r = None
            for i in range(sp):
                src = (r + i) % sp
                hop = (src, k[:, sl[src]].contiguous(),
                       v[:, sl[src]].contiguous(),
                       (kl - src * lq).clamp(0, lq))
                hops.append(hop)
                o, lse_r = ra.ring_forward_hop(
                    qs, hop[1], hop[2], hop[3], o, lse_r, (r * lq, src * lq),
                    scale=scale)
            out_r = o.to(torch.bfloat16)
            delta = bwd_delta(out_r, dos)
            dq = torch.zeros(qs.shape, dtype=torch.float32, device=dev)
            for src, kc, vc, klc in hops:
                dk_i, dv_i = ra.ring_backward_hop(
                    qs, kc, vc, out_r, dos, lse_r, delta, klc, dq,
                    (r * lq, src * lq), scale=scale)
                dk[src] += dk_i.float()
                dv[src] += dv_i.float()
            dqs.append(dq.to(torch.bfloat16))
            if r:
                continue
            # rank 0's program: delta once, then per hop K2 and the fp32
            # accumulation of the travelling dK / dV
            scratch = torch.zeros_like(dq)
            delta_ms = bench_ms(lambda: bwd_delta(out_r, dos))
            rank_ms, bound_sum = delta_ms, 0.0
            for i, (src, kc, vc, klc) in enumerate(hops):
                pairs = lq * int(klc.item())
                k2_ms, bound = _k2_row(
                    f"ring hop sp {sp} hop {i} (Lq = Lk = {lq}, k_len "
                    f"{int(klc.item())})",
                    lambda: ra.ring_backward_hop(
                        qs, kc, vc, out_r, dos, lse_r, delta, klc, scratch,
                        (0, src * lq), scale=scale),
                    lq, lq, pairs, n, d,
                    lib_shape=(b, lq, lq, n) if i == 0 else None,
                    plain=(lambda: ra.ring_backward_hop(
                        qs, kc, vc, out_r, dos, lse_r, delta, klc, scratch,
                        (0, src * lq), scale=scale, impl="dense"))
                    if i == 0 else None)
                acc_ms = bench_ms(lambda: dk[src].add(dk_i.float()))
                rank_ms += k2_ms + 2 * acc_ms
                bound_sum += bound
            log(f"[30] ring backward sp {sp}: rank 0's program "
                f"{rank_ms:.3f} ms (delta {delta_ms:.3f} ms, K2 and the "
                f"dK / dV adds) against 1/{sp} of the whole call "
                f"{whole_ms / sp:.3f} ms (x{rank_ms / (whole_ms / sp):.2f})"
                f" and its bound {bound_sum:.3f} ms (the whole's / {sp}: "
                f"{whole_bound / sp:.3f} ms)")
            del scratch
        got = (torch.cat(dqs, dim=1), torch.cat(dk, dim=1).to(torch.bfloat16),
               torch.cat(dv, dim=1).to(torch.bfloat16))
        err = check(f"ring sp {sp}", got, whole)
        log(f"[30] ring backward sp {sp}: {sp} ranks x {sp} K2 hops "
            f"concatenated vs the whole K2 call: max abs err {err:.3g}")
        del got, dqs, dk, dv

        # Ulysses: each rank's backward is one K2 call over all tokens at
        # its N/sp heads (the exchanges are their own adjoints; their
        # buffer layouts are phase 29's)
        nh = n // sp
        parts = []
        for r in range(sp):
            hs = slice(r * nh, (r + 1) * nh)
            qh, kh, vh, doh = (x[:, :, hs].contiguous()
                               for x in (q, k, v, do))
            o_h, lse_h = flash_attention_cuda(qh, kh, vh, k_lens=kl,
                                              return_lse=True)
            parts.append(flash_bwd_cuda(qh, kh, vh, o_h, lse_h, doh,
                                        k_lens=kl))
        err = check(f"ulysses sp {sp}", [torch.cat([p_[i] for p_ in parts],
                                                   dim=2)
                                         for i in range(3)], whole)
        u_ms, _ = _k2_row(
            f"ulysses sp {sp} ({nh} heads, L {L}, k_len {valid})",
            lambda: flash_bwd_cuda(qh, kh, vh, o_h, lse_h, doh, k_lens=kl),
            L, L, L * valid, nh, d, lib_shape=(b, L, L, nh),
            plain=lambda: flash_bwd_plain(qh, kh, vh, o_h, lse_h, doh,
                                          k_lens=kl))
        log(f"[30] ulysses backward sp {sp}: {sp} ranks' K2 calls vs the "
            f"whole: max abs err {err:.3g}; {u_ms:.3f} ms against 1/{sp} of "
            f"the whole call {whole_ms / sp:.3f} ms")
        del parts, qh, kh, vh, doh, o_h, lse_h

        # sp_cross: each rank's queries against all 512 text keys
        lc = 512
        kt, vt = rnd(lc), rnd(lc)
        o_c, lse_c = flash_attention_cuda(q, kt, vt, return_lse=True)
        whole_c = flash_bwd_cuda(q, kt, vt, o_c, lse_c, do)
        dq_c = []
        dk_c = torch.zeros(kt.shape, dtype=torch.float32, device=dev)
        dv_c = torch.zeros_like(dk_c)
        for r in range(sp):
            qs, dos = q[:, sl[r]].contiguous(), do[:, sl[r]].contiguous()
            o_s, lse_s = flash_attention_cuda(qs, kt, vt, return_lse=True)
            g = flash_bwd_cuda(qs, kt, vt, o_s, lse_s, dos)
            dq_c.append(g[0])
            dk_c += g[1].float()
            dv_c += g[2].float()
        err = check(f"sp_cross sp {sp}", (torch.cat(dq_c, dim=1),
                                          dk_c.to(torch.bfloat16),
                                          dv_c.to(torch.bfloat16)), whole_c)
        c_ms, _ = _k2_row(
            f"sp_cross sp {sp} (Lq {lq}, Lc {lc})",
            lambda: flash_bwd_cuda(qs, kt, vt, o_s, lse_s, dos),
            lq, lc, lq * lc, n, d, lib_shape=(b, lq, lc, n),
            plain=lambda: flash_bwd_plain(qs, kt, vt, o_s, lse_s, dos))
        log(f"[30] sp_cross backward sp {sp}: dQ rows and the ranks' summed "
            f"dK / dV vs the whole: max abs err {err:.3g}; {c_ms:.3f} ms a "
            f"rank")
        del kt, vt, o_c, lse_c, whole_c, dq_c, dk_c, dv_c, g
    del q, k, v, do, out, lse, whole
    torch.cuda.empty_cache()


class _GradRecorder:
    """An optimizer for the phase's comparisons: keeps the whole gradients
    it is given (bf16 or fp32 copies on the card) and their `global_norm`,
    then runs `inner` (or nothing)."""

    def __init__(self, inner=None):
        self.inner, self.grads, self.norm = inner, None, None

    def init(self, params):
        return self.inner.init(params) if self.inner else {}

    def step(self, params, grads, state):
        from omnihuman_tpu_torch.apt.optim import global_norm
        from omnihuman_tpu_torch.parallel.partition import full
        self.grads = [full(g).detach().clone() for g in grads.values()]
        self.norm = float(global_norm(grads.values()))
        if self.inner:
            self.inner.step(params, grads, state)


def _rel_l2_list(a, b) -> float:
    num = sum(float((x.float() - y.float()).square().sum())
              for x, y in zip(a, b))
    den = sum(float(y.float().square().sum()) for y in b)
    return (num / den) ** 0.5


def _distill_setup(plan):
    """t2v-1.3B student (bf16, seed 0, random head) with a recording AdamW
    state, sharded on `plan` (a TrainMeshPlan)."""
    import torch
    from omnihuman_tpu_torch.apt.distill import (
        init_distill_state, make_optimizer)
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    model = build_wan_model(T2V_1_3B.model, "cuda", torch.bfloat16, seed=0,
                            trainable=True)
    _random_head(model)
    plan.shard_tree(model)
    rec = _GradRecorder(make_optimizer())
    return init_distill_state(model, rec), rec


def _distill_batches(frames_lat=1):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3031 + frames_lat)
    lat = (1, 16, frames_lat, 60, 104)
    return [{"noise": torch.randn(lat, generator=gen, device="cuda"),
             "context": torch.randn((1, 512, 4096), generator=gen,
                                    device="cuda"),
             "v_teacher": torch.randn(lat, generator=gen, device="cuda")}
            for _ in range(2)]


def _omni_setup(plan):
    """OmniHuman at t2v-1.3B width (fp32 parameters, seed 0, random head),
    a gradient-capturing optimizer, sharded on `plan`; and one batch of
    3,584 packed tokens (13 latent frames of 32x32 plus the reference, 49
    audio rows, 308 heatmaps at 64x64) with its draws."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.omni.model import (
        OmniModelConfig, build_omni_model)
    from omnihuman_tpu_torch.omni.trainer import init_omni_train_state
    ocfg = OmniModelConfig(base=T2V_1_3B.model, audio_dim=1024,
                           num_keypoints=308, num_frames=13)
    model = build_omni_model(ocfg, "cuda", torch.float32, seed=0,
                             trainable=True)
    _random_head(model.base)
    plan.shard_tree(model)
    rec = _GradRecorder()
    gen = torch.Generator(device="cuda").manual_seed(3032)
    lat = (1, 16, 13, 32, 32)
    rn = lambda *s: torch.randn(s, generator=gen, device="cuda")
    batch = {"frames": rn(*lat), "context": rn(1, 512, 4096),
             "audio": rn(1, 49, 1024),
             "pose": (rn(1, 308, 13, 64, 64) * 0.1).to(torch.bfloat16),
             "reference": rn(1, 16, 1, 32, 32)}
    masks = {k: torch.ones(1, device="cuda")
             for k in ("audio", "pose", "reference")}
    draws = (masks, torch.full((1,), 0.4, device="cuda"), rn(*lat))
    return init_omni_train_state(model, rec), rec, batch, draws


def phase_sp_train_mesh(all_kernels, flagship_s=None):
    """[30b] The training steps on a one-rank NCCL mesh, MeshConfig(1, 1,
    1) built explicitly (the ring and sp_cross at sp 1, FSDP2 over one
    rank, the root resharded after each forward): two distill steps at
    t2v-1.3B width and 1,560 tokens and one OmniHuman step at 3,584
    tokens, each held against the same step unsharded (loss, every
    gradient within 3x the spread of two unsharded runs, launch counts:
    K2 adds dQ in a run-dependent order); launch counts zeroed just
    before the mesh steps and read just after them. Then a distill step
    at 81 frames on
    the mesh, timed against phase 10's unsharded step, with its peak
    memory; the mesh state saved (rank 0 gathers and writes) and restored
    into an unsharded state, bit-equal. Returns (the counts, the mesh
    distill steps' losses)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.fsdp import FSDPModule
    from omnihuman_tpu_torch.apt.distill import (
        distill_train_step, init_distill_state, make_optimizer)
    from omnihuman_tpu_torch.apt.generate import latent_rope
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.omni.trainer import omni_train_step
    from omnihuman_tpu_torch.parallel import MeshConfig, create_mesh
    from omnihuman_tpu_torch.parallel.partition import full
    from omnihuman_tpu_torch.parallel.train_mesh import (
        NO_MESH, TrainMeshPlan)
    from omnihuman_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = T2V_1_3B
    batches = _distill_batches()
    geo = latent_rope(cfg.model, batches[0]["noise"].shape, "cuda")

    def distill_steps(plan, want=None):
        state, rec = _distill_setup(plan)
        runs = []
        for i, batch in enumerate(batches):
            before = _count(all_kernels)
            held = _reset_peak()
            _, m = distill_train_step(state, batch, optimizer=rec,
                                      policy=cfg.policy, plan=plan, **geo)
            runs.append(_step_record(m, rec, before, held))
            if want is not None:
                _hold(f"distill step {i + 1} (1,560 tokens)", runs[-1],
                      want[i])
        return state, runs

    def omni_step(plan, want=None):
        state, rec, batch, (masks, t, noise) = _omni_setup(plan)
        before = _count(all_kernels)
        held = _reset_peak()
        _, m = omni_train_step(state, batch, masks, t, noise, optimizer=rec,
                               policy=cfg.policy, plan=plan)
        run = _step_record(m, rec, before, held)
        if want is not None:
            _hold("omni step (3,584 tokens)", run, want)
        del state, rec, batch
        return run

    def spread(runs, again):
        """Two unsharded runs differ too (K2 adds dQ in a run-dependent
        order): the relative L2 between them, kept on the first run."""
        for w, a in zip(runs, again):
            w["spread"] = _rel_l2_list(a["grads"], w["grads"])

    def _reset_peak():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def _step_record(m, rec, before, held):
        """The step's metrics, gradients, launches and its own peak: the
        device memory it allocated above what was held before it (the
        phase keeps other runs' gradients meanwhile)."""
        now = _count(all_kernels)
        return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                    grads=rec.grads,
                    peak=(torch.cuda.max_memory_allocated() - held) / 2 ** 30,
                    counts={k: v - before[k] for k, v in now.items()})

    def _hold(what, g, w):
        rel = _rel_l2_list(g.pop("grads"), w.pop("grads"))
        tol = max(1e-4, 3 * w["spread"])
        log(f"[30] {what}, one-rank mesh vs unsharded: loss "
            f"{g['loss']:.6g} vs {w['loss']:.6g}, grad norm "
            f"{g['grad_norm']:.6g} vs {w['grad_norm']:.6g}, gradients "
            f"relative L2 {rel:.3g} (two unsharded runs: {w['spread']:.3g};"
            f" tol {tol:.3g}, 3x that), launches {g['counts']} vs "
            f"{w['counts']}, the step's own peak (above what was held "
            f"before it) {g['peak']:.2f} vs {w['peak']:.2f} GiB")
        if (abs(g["loss"] - w["loss"]) > 1e-3 * abs(w["loss"])
                or abs(g["grad_norm"] - w["grad_norm"])
                > 1e-3 * w["grad_norm"] or not rel <= tol):
            fail(f"[30] the mesh {what} differs from the unsharded one")
        if g["counts"] != w["counts"] or not all(
                g["counts"][kn.name] for kn in all_kernels[:3]):
            fail(f"[30] the mesh {what} launched other kernels")

    # the unsharded steps first, twice, so the mesh's counts are read
    # alone and its gradients held to the unsharded runs' own spread
    state, want = distill_steps(NO_MESH)
    del state
    state, again = distill_steps(NO_MESH)
    spread(want, again)
    del state, again          # the second run's gradients: 5.2 GB
    want_omni = omni_step(NO_MESH)
    spread([want_omni], [omni_step(NO_MESH)])
    gc.collect()
    torch.cuda.empty_cache()

    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        plan = TrainMeshPlan(create_mesh(MeshConfig(1, 1, 1)),
                             torch.device("cuda", 0))
        _zero(all_kernels)
        mstate, got = distill_steps(plan, want)
        if not isinstance(mstate.model, FSDPModule):
            fail("[30] the mesh student is not sharded by FSDP2")
        omni_step(plan, want_omni)
        counts = _count(all_kernels)
        losses = [g["loss"] for g in got]
        del got, want, want_omni
        gc.collect()
        torch.cuda.empty_cache()

        # 81 frames on the mesh, as phase 10 times it unsharded
        big = _distill_batches(21)[0]
        bgeo = latent_rope(cfg.model, big["noise"].shape, "cuda",
                           sp=plan.sp)
        opt = make_optimizer()

        def step():
            _, m = distill_train_step(mstate, big, optimizer=opt,
                                      policy=cfg.policy, plan=plan, **bgeo)
            return float(m["loss"])

        step()
        held = _reset_peak()
        t0 = time.perf_counter()
        loss = step()
        sec = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        own = peak - held / 2 ** 30
        if loss != loss:
            fail("[30] 81-frame mesh distill step loss is NaN")
        versus = ("phase 10 not run" if flagship_s is None else
                  f"against phase 10's unsharded {flagship_s:.2f} s "
                  f"(x{sec / flagship_s:.3f})")
        log(f"[30] distill step at 81 frames on the one-rank mesh "
            f"({FLAGSHIP['tokens']} tokens, seq_len {bgeo['seq_len']}): "
            f"{sec:.2f} s {versus}, peak device memory {peak:.1f} GiB "
            f"({held / 2 ** 30:.1f} held before the step, {own:.1f} its "
            f"own)")
        del big, bgeo

        # the mesh state through a checkpoint into an unsharded state
        t0 = time.perf_counter()
        mgr = CheckpointManager(os.path.join(WORK, "sp_ckpt"))
        mgr.save(mstate.step, mstate)
        save_s = time.perf_counter() - t0
        model = build_wan_model(cfg.model, "cuda", torch.bfloat16, seed=None,
                                trainable=True)
        fresh = mgr.restore(target=init_distill_state(model,
                                                      make_optimizer()))

        def whole(tree):
            if isinstance(tree, dict):
                return {k: whole(v) for k, v in tree.items()}
            return full(tree.detach()) if torch.is_tensor(tree) else tree

        n_bytes = same_tree(fresh.state_dict(), whole(mstate.state_dict()),
                            "mesh state")
        log(f"[30] mesh checkpoint ({n_bytes / 2 ** 30:.2f} GiB) saved in "
            f"{save_s:.1f} s and restored unsharded bit-equal in "
            f"{time.perf_counter() - t0 - save_s:.1f} s")
        del mstate, fresh, model, opt
        return counts, losses
    finally:
        dist.destroy_process_group()
        shutil.rmtree(os.path.join(WORK, "sp_ckpt"), ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_sp_train_multi(want_losses):
    """[30c] With two or more cards: `torchrun` runs this script's
    --train-worker mode, two distill steps at 1,560 tokens from phase
    30b's weights and batches at sp 2 (and fsdp 2 with four cards), whose
    losses are held to the one-rank mesh's (rtol 2e-2). With one card
    that is logged as not run."""
    import torch
    count = torch.cuda.device_count()
    if count < 2:
        log(f"[30] (c) not run: {count} card; NCCL holds one rank a GPU")
        return
    n = 4 if count >= 4 else 2
    out = os.path.join(WORK, "sp_train.json")
    os.makedirs(WORK, exist_ok=True)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", os.path.abspath(__file__),
         "--train-worker", out], cwd=HERE, capture_output=True, text=True,
        timeout=600)
    if r.returncode != 0:
        fail(f"[30] torchrun train worker failed:\n{r.stderr[-3000:]}")
    got = json.load(open(out))
    log(f"[30] (c) {got['plan']} on {n} cards: losses {got['losses']} vs "
        f"the one-rank mesh's {want_losses}; "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    for a, b in zip(got["losses"], want_losses):
        if abs(a - b) > 2e-2 * abs(b):
            fail("[30] the multi-card steps' losses differ")


def train_worker(out: str) -> None:
    """--train-worker OUT, one rank under torchrun: two distill steps at
    1,560 tokens on a (data -1, fsdp 2 with 4+ ranks else 1, sp 2) mesh
    from phase 30b's weights and batches; rank 0 writes the losses."""
    import torch.distributed as dist
    from omnihuman_tpu_torch.apt.distill import distill_train_step
    from omnihuman_tpu_torch.apt.generate import latent_rope
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.parallel.train_mesh import TrainMeshPlan
    world = int(os.environ["WORLD_SIZE"])
    plan = TrainMeshPlan.from_sizes(2 if world >= 4 else 1, 2)
    state, rec = _distill_setup(plan)
    batches = _distill_batches()
    geo = latent_rope(T2V_1_3B.model, batches[0]["noise"].shape, "cuda",
                      sp=plan.sp)
    losses = []
    for batch in batches:
        _, m = distill_train_step(state, plan.put_batch(batch),
                                  optimizer=rec, policy=T2V_1_3B.policy,
                                  plan=plan, **geo)
        losses.append(float(m["loss"]))
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump({"plan": plan.describe(), "losses": losses}, f)
    dist.destroy_process_group()


def run_sp_train_phase(all_kernels, paths, flagship_s=None):
    """Phase 30 (a, b, c), timed; `flagship_s` is phase 10's step."""
    import torch
    t0 = time.perf_counter()
    try:
        phase_sp_train_programs()
        paths["sp_train"], losses = phase_sp_train_mesh(all_kernels,
                                                        flagship_s)
        phase_sp_train_multi(losses)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[30] phase wall time {time.perf_counter() - t0:.1f} s (planned "
        f"under 120 s)")


# ---------------------------------------------------------------------------
# phase 31: the spatial halo exchange (the W-sharded VAE, the one-step
# generator and the H-sharded pose guider on a mesh)

SPATIAL = dict(decode_ranks=(2, 4, 8), encode_ranks=(2, 4), seed=3131,
               workers=None)


def _shard_k_shapes(ranks):
    """The largest K3 / K4 call of one rank's W shard of the 81-frame
    decode (the widest rank): phase 12's rows at (W / R + 2) columns."""
    from omnihuman_tpu_torch.parallel.spatial import shard_bounds
    widest = max(e - s for s, e in shard_bounds(104, ranks))
    t, h, _, cin, cout = K3_ROW
    k3 = (t, h, 8 * widest + 2, cin, cout)
    t, h, _, cin, cout = K4_ROW
    k4 = (t, h, 4 * widest + 2, cin, cout)
    return k3, k4


def _sharded_pass(tag, run, whole, whole_s, ranks, vae_kernels, count_of):
    """[31a] `run(spatial)` (a W-sharded decode or encode) on R recorded
    virtual ranks against the unsharded output, its launches, and every
    rank's program replayed alone and timed against 1/R of the unsharded
    pass. Returns the JSON row."""
    import torch
    from omnihuman_tpu_torch.parallel.spatial import VirtualRanks
    vr = VirtualRanks(ranks, record=True)
    _zero(vae_kernels)
    got, sec, peak = _timed(lambda: run(vr))
    counts = _count(vae_kernels)
    diff = got.float() - whole.float()
    rel = (diff.norm() / whole.float().norm()).item()
    max_abs = diff.abs().max().item()
    peak_abs = whole.float().abs().max().item()
    want = {kn.name: ranks * n for kn, n in zip(vae_kernels, count_of)}
    log(f"[31] {tag} on {ranks} virtual ranks: lockstep {sec:.3f} s, peak "
        f"{peak:.2f} GiB; against the unsharded pass bit-equal "
        f"{torch.equal(got, whole)}, max abs {max_abs:.3g} (peak "
        f"{peak_abs:.3g}), relative L2 {rel:.3g}; launches {counts}, "
        f"expected {want} (every rank's K3 / K4 on its halo-extended shard)")
    if (tuple(got.shape) != tuple(whole.shape) or not torch.isfinite(
            got.float()).all() or rel > 1e-2 or max_abs > 2 ** -4 * peak_abs):
        fail(f"[31] {tag} on {ranks} ranks differs from the unsharded pass")
    if _differ(counts, want):
        fail(f"[31] {tag} on {ranks} ranks launched {counts}, not {want}")
    times = []
    for r in range(ranks):
        replay = vr.replay(r)
        run_r = (lambda rp=replay, r=r: run((rp.rewind(), r)))
        run_r()
        reps = []
        for _ in range(3):
            _, t_r, _ = _timed(run_r)
            reps.append(t_r)
        times.append(statistics.median(reps))
    slowest = max(times)
    log(f"[31] {tag} per-rank programs replayed alone (median of 3): "
        + ", ".join(f"{t * 1e3:.1f}" for t in times)
        + f" ms; slowest x{slowest / (whole_s / ranks):.3f} of 1/{ranks} of "
        f"the unsharded {whole_s * 1e3:.1f} ms")
    del got, diff, vr
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ranks=ranks, lockstep_s=sec, rel_l2=rel, max_abs=max_abs,
                rank_ms=[t * 1e3 for t in times], whole_ms=whole_s * 1e3,
                launches=counts)


def phase_spatial_programs():
    """[31a] The W-sharded VAE on virtual ranks on one card: the 81-frame
    480x832 decode (latent [1, 16, 21, 60, 104]) at R = 2, 4, 8 and the
    encode of a clip of that size at R = 2, 4, every rank's program
    (`vae_decode_shard` / `vae_encode_shard`) running K3 and K4 on its
    halo-extended shard, the assembled output held against the unsharded
    pass, each rank replayed alone and timed against 1/R of it; then K3
    and K4 at each R's widest shard shapes against their plain versions.
    Returns {"rows": [...], "k3": [...], "k4": [...], "launches": {...}}."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.vae import (
        WShard, build_vae, shard_inputs, vae_decode, vae_decode_shard,
        vae_encode, vae_encode_shard)
    from omnihuman_tpu_torch.ops.vae_kernels import VAE_CONV, VAE_UPSAMPLE
    from omnihuman_tpu_torch.parallel.spatial import VirtualRanks

    vae_kernels = (VAE_CONV, VAE_UPSAMPLE)
    vae = build_vae(T2V_1_3B.vae, "cuda", torch.bfloat16, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(SPATIAL["seed"])
    z = torch.randn((1, 16, 21, 60, 104), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    video = (torch.rand((1, 3, 81, 480, 832), generator=gen, device="cuda")
             * 2 - 1).to(torch.bfloat16)
    out = {"rows": [], "k3": [], "k4": [], "launches": {}}
    with torch.inference_mode():
        for name, whole_fn, shard_fn, inp, per_latent, ranks_list, n in (
                ("decode", lambda x, sp=None: vae_decode(
                    vae, x, clamp=False, conv_impl="cuda", spatial=sp),
                 lambda x, sp: vae_decode_shard(vae, x, sp, clamp=False,
                                                conv_impl="cuda"),
                 z, 1, SPATIAL["decode_ranks"], (588, 63)),
                ("encode", lambda x, sp=None: vae_encode(
                    vae, x, conv_impl="cuda", spatial=sp),
                 lambda x, sp: vae_encode_shard(vae, x, sp,
                                                conv_impl="cuda"),
                 video, 8, SPATIAL["encode_ranks"], (420, 0))):
            whole_fn(inp)                                   # warm-up
            whole, whole_s, _ = _timed(lambda: whole_fn(inp))
            _, again_s, _ = _timed(lambda: whole_fn(inp))
            whole_s = min(whole_s, again_s)
            for ranks in ranks_list:
                widths, shards = shard_inputs(inp, ranks, per_latent)

                def run(spatial, widths=widths, shards=shards):
                    if isinstance(spatial, VirtualRanks):   # the entry point
                        return whole_fn(inp, spatial)
                    replay, r = spatial                     # rank r alone
                    return shard_fn(shards[r], WShard(replay, widths))

                row = _sharded_pass(f"vae_{name} 81 frames", run, whole,
                                    whole_s, ranks, vae_kernels, n)
                row["pass"] = name
                out["rows"].append(row)
                out["launches"][f"vae_{name}_w{ranks}"] = row["launches"]
            del whole
            gc.collect()
            torch.cuda.empty_cache()
    del vae, z, video
    gc.collect()
    torch.cuda.empty_cache()
    rnd = _vae_rnd(SPATIAL["seed"])
    for ranks in SPATIAL["decode_ranks"]:
        k3, k4 = _shard_k_shapes(ranks)
        out["k3"].append(dict(k3_case(*k3, tag="31", rnd=rnd), ranks=ranks,
                              shape=list(k3)))
        out["k4"].append(dict(k4_case(*k4, tag="31", rnd=rnd), ranks=ranks,
                              shape=list(k4)))
    return out


def phase_spatial_mesh(all_kernels, one_step_ref):
    """[31b] A one-rank NCCL process group, MeshConfig(1, 1, 1):
    `SeaweedWanAPTGenerator` over phase 5's pipeline built on the mesh
    (the ring and sp_cross at sp 1, FSDP2 over one rank, the decode
    W-sharded over the world through the halo path) on phase 15's two
    prompts and contexts, held against phase 15's unsharded batch, launch
    counts zeroed just before and read just after; then an OmniHuman
    training step at 3,584 tokens (phase 30's) with the pose guider on its
    H-sharded path (`pose_sharding` the sp mesh: halos and the gather over
    one rank), held against the same step with the heatmaps whole, within
    3x the spread of two whole-pose runs (K2's dQ order). Returns the
    one-step counts."""
    import torch
    import torch.distributed as dist
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.omni.trainer import omni_train_step
    from omnihuman_tpu_torch.parallel import MeshConfig, create_mesh
    from omnihuman_tpu_torch.parallel.train_mesh import TrainMeshPlan
    from omnihuman_tpu_torch.pipelines.wan_inference import (
        SeaweedWanAPTGenerator)

    want, ctx, lens = one_step_ref
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = create_mesh(MeshConfig(1, 1, 1))
        mp = t2v_pipe(mesh)
        gen = SeaweedWanAPTGenerator(mp)
        w, h = FLAGSHIP["size"]
        _zero(all_kernels)
        videos, sec, peak = _timed(lambda: gen.generate_batch(
            list(ONE_STEP["prompts"]), size=(w, h),
            frame_num=ONE_STEP["frames"], seed=ONE_STEP["seed"],
            context=ctx, context_lens=lens))
        counts = _count(all_kernels)
        tm = gen.timings
        diff = videos.float() - want.float()
        rel = (diff.norm() / want.float().norm()).item()
        f_lat = f_lat_of(ONE_STEP)
        expect = [NUM_LAYERS, NUM_LAYERS, 0, 28 * f_lat, 3 * f_lat]
        log(f"[31] one-step batch on the one-rank mesh: {sec:.2f} s (DiT "
            f"{tm['dit_s']:.3f} s, W-sharded decode {tm['vae_decode_s']:.3f}"
            f" s), peak {peak:.1f} GiB; against phase 15's unsharded batch "
            f"bit-equal {torch.equal(videos, want)}, max abs "
            f"{diff.abs().max().item():.3g}, relative L2 {rel:.3g} (tol "
            f"1e-3); launches {counts}, expected {expect}")
        if rel > 1e-3 or not torch.isfinite(videos.float()).all():
            fail("[31] the mesh one-step videos differ from phase 15's")
        if _differ(counts, _want(all_kernels, *expect)):
            fail("[31] the mesh one-step batch launched other kernels")
        del mp, gen, videos, diff
        gc.collect()
        torch.cuda.empty_cache()

        plan = TrainMeshPlan(mesh, torch.device("cuda", 0))
        state, rec, batch, (masks, t, noise) = _omni_setup(plan)
        runs = []
        for tag, b in (("whole", batch),
                       ("H path", dict(batch, pose_sharding=mesh["sp"])),
                       ("whole again", batch)):
            _, m = omni_train_step(state, b, masks, t, noise, optimizer=rec,
                                   policy=T2V_1_3B.policy, plan=plan)
            runs.append((tag, float(m["loss"]), float(m["grad_norm"]),
                         rec.grads))
            if len(runs) == 3:
                spread = _rel_l2_list(runs[2][3], runs[0][3])
                runs[2] = runs[2][:3]
        rel = _rel_l2_list(runs[1][3], runs[0][3])
        tol = max(1e-4, 3 * spread)
        log(f"[31] omni step (3,584 tokens) on the mesh, pose guider on its "
            f"H path vs whole heatmaps: loss {runs[1][1]:.6g} vs "
            f"{runs[0][1]:.6g}, grad norm {runs[1][2]:.6g} vs "
            f"{runs[0][2]:.6g}, gradients relative L2 {rel:.3g} (two "
            f"whole-pose runs: {spread:.3g}; tol {tol:.3g})")
        if (abs(runs[1][1] - runs[0][1]) > 1e-3 * abs(runs[0][1])
                or rel > tol):
            fail("[31] the H-path omni step differs from the whole-pose one")
        del state, rec, batch, runs
        return counts
    finally:
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()


def phase_spatial_multi():
    """[31c] With two or more cards: `torchrun` runs this script's
    --spatial-worker mode, the 81-frame decode W-sharded over every card
    through NCCL, held against one card's unsharded decode; with one card,
    logged as not run."""
    count = __import__("torch").cuda.device_count()
    if count < 2:
        log(f"[31] (c) not run: {count} card; the W-sharded decode over "
            f"NCCL needs >= 2 cards (torchrun --nproc_per_node N "
            f"chip_smoke.py --spatial-worker OUT)")
        return
    os.makedirs(WORK, exist_ok=True)
    out = os.path.join(WORK, "spatial.json")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={min(8, count)}", os.path.abspath(__file__),
         "--spatial-worker", out],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        fail(f"[31] torchrun --spatial-worker failed:\n{r.stderr[-3000:]}")
    res = json.load(open(out))
    log(f"[31] (c) the decode W-sharded over {res['ranks']} cards (NCCL): "
        f"{res}; {time.perf_counter() - t0:.1f} s with start-up")
    if res["rel_l2"] > 1e-2:
        fail("[31] the NCCL W-sharded decode differs from one card's")


def spatial_worker(out: str) -> None:
    """--spatial-worker OUT, one rank under torchrun: the 81-frame decode
    of phase 31 (a)'s latent W-sharded over the world (NCCL); rank 0 also
    decodes unsharded and writes the comparison and times to OUT."""
    import torch
    import torch.distributed as dist
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.vae import build_vae, vae_decode
    from omnihuman_tpu_torch.parallel.mesh import init_distributed
    dev = init_distributed()
    try:
        vae = build_vae(T2V_1_3B.vae, dev, torch.bfloat16, seed=1)
        gen = torch.Generator(device=dev).manual_seed(SPATIAL["seed"])
        z = torch.randn((1, 16, 21, 60, 104), generator=gen, device=dev
                        ).to(torch.bfloat16)
        with torch.inference_mode():
            dec = lambda: vae_decode(vae, z, clamp=False, conv_impl="cuda",
                                     spatial=dist.group.WORLD)
            dec()
            got, sec, _ = _timed(dec)
            if dist.get_rank() == 0:
                whole, whole_s, _ = _timed(lambda: vae_decode(
                    vae, z, clamp=False, conv_impl="cuda"))
                rel = ((got.float() - whole.float()).norm()
                       / whole.float().norm()).item()
                with open(out, "w") as f:
                    json.dump({"ranks": dist.get_world_size(),
                               "sharded_s": sec, "whole_s": whole_s,
                               "rel_l2": rel}, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_spatial_phase(all_kernels, paths, one_step_ref):
    """Phase 31 (a), (b), (c), timed. Returns phase 31 (a)'s rows."""
    import torch
    t0 = time.perf_counter()
    try:
        rows = phase_spatial_programs()
        paths.update(rows["launches"])
        paths["spatial_one_step"] = phase_spatial_mesh(all_kernels,
                                                       one_step_ref)
        phase_spatial_multi()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[31] phase wall time {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# phase 32: block_norm, the DiT block's residual sites in one pass

BN_FORMS = ("A", "B", "C", "C_audio_norm", "C_audio_gate", "D")
BN_ROWS = (2, 32768)         # the fused CFG batch at the flagship's tokens
BN_BATCH = 20                # calls a timing, back to back


def _bn_args(form, b, l, d, rd, seed):
    """add_norm's arguments at one site form of `_block_forward`: x in rd,
    y bf16 [b, l, d], the AdaLN slices of a drawn e [b, 6, d] (1% of the
    channels at std 64), a bf16 norm weight and bias, the audio gate."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rows():
        return torch.randn(b, l, d, generator=gen, device="cuda")

    x, y = (rows() * 2 + 0.3).to(rd), rows().to(torch.bfloat16)
    e = torch.randn(b, 6, d, generator=gen, device="cuda") * 0.5
    e[..., : d // 100] *= 128.0
    sa_shift, sa_scale, sa_gate, ff_shift, ff_scale, ff_gate = (
        e[:, i:i + 1] for i in range(6))
    w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    bias = (0.02 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16)
    gate = torch.tensor(0.7, device="cuda")
    kw = {"A": dict(shift=sa_shift, scale=sa_scale),
          "B": dict(y=y, gate=sa_gate, weight=w, bias=bias),
          "C": dict(y=y, shift=ff_shift, scale=ff_scale),
          "C_audio_norm": dict(y=y, weight=w, bias=bias),
          "C_audio_gate": dict(y=y, gate=gate, round_inner=False,
                               shift=ff_shift, scale=ff_scale),
          "D": dict(y=y, gate=ff_gate, norm=False)}[form]
    a = dict(y=None, gate=None, round_inner=True, norm=True, weight=None,
             bias=None, shift=None, scale=None)
    a.update(kw)
    return (x, a["y"], a["gate"], a["round_inner"], a["norm"], a["weight"],
            a["bias"], a["shift"], a["scale"], 1e-6, torch.bfloat16)


def _bn_bytes(args) -> int:
    """Each input and output once: the rows, the AdaLN vectors, w and b."""
    x, y, gate, _, norm, w, bias, shift, scale = args[:9]
    n = x.numel()
    total = n * x.element_size()
    if y is not None:
        total += n * y.element_size() + n * x.element_size()
    if norm:
        total += n * 2
    for v in (gate, shift, scale, w, bias):
        if v is not None:
            total += v.numel() * v.element_size()
    return total


def _bn_steps(got, want):
    """(elements more than one bf16 step of their own value apart, the same
    with magnitudes floored at 2^-8 of the row's peak)."""
    import torch
    gf, wf = got.float(), want.float()
    diff = (gf - wf).abs()
    out = []
    for floor in (0.0, 2.0 ** -8):
        mag = torch.maximum(wf.abs(), wf.abs().amax(-1, keepdim=True) * floor)
        step = torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -126)))
                          - 7)
        out.append(int((diff > step).sum().item()))
    return out


def phase_block_norm():
    """block_norm against the eager chain at every site form, both
    published widths, 65,536 rows: ms back to back and for one call, the
    byte bound, the eager ms; the kernel's launches in a full-width
    t2v-1.3B DiT forward without the gradient, and in a forward and
    backward with it and per-block remat. Returns the JSON row (the 1536
    site B's numbers as the headline)."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.block_norm import (
        BLOCK_NORM, add_norm_eager, add_norm_op)
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d

    ptxas_facts(BLOCK_NORM.source, "32", "block_norm")
    b, l = BN_ROWS
    forms, worst = {}, 1.0
    for d in (1536, 5120):
        cases = [(f, torch.bfloat16) for f in BN_FORMS]
        cases += [(f, torch.float32) for f in ("B", "D")]
        for form, rd in cases:
            args = _bn_args(form, b, l, d, rd, seed=d)
            xo, h = add_norm_op(*args)
            want_x, want_h = add_norm_eager(*args)
            torch.cuda.synchronize()
            if args[1] is not None and not torch.equal(xo, want_x):
                fail(f"block_norm {form} d={d} {rd}: x' differs from eager")
            strict = floored = 0
            if want_h is not None:
                strict, floored = _bn_steps(h, want_h)
                if floored:
                    fail(f"block_norm {form} d={d} {rd}: {floored} elements "
                         "of h more than one bf16 step from eager")
            one_call_ms = bench_ms(lambda: add_norm_op(*args))
            # back to back, as the DiT runs it: the wrapper's host time
            # (checks, allocations, the ctypes call) hides behind the card
            back_to_back_ms = bench_ms(lambda: [
                add_norm_op(*args) for _ in range(BN_BATCH)]) / BN_BATCH
            plain = bench_ms(lambda: add_norm_eager(*args), reps=3)
            bound = _bn_bytes(args) / PEAK_BYTES * 1e3
            share = bound / back_to_back_ms
            tag = f"{form} d={d} {str(rd).removeprefix('torch.')}"
            log(f"[32] {tag}: {back_to_back_ms:.4f} ms a call back to back "
                f"({one_call_ms:.4f} one call with its wrapper), bound "
                f"{bound:.4f} ms (bytes), {100 * share:.1f}%; eager "
                f"{plain:.3f} ms; h elements over one bf16 step {strict} of "
                f"{h.numel()} (none at the row-peak floor)")
            forms[tag] = dict(back_to_back_ms=round(back_to_back_ms, 4),
                              one_call_ms=round(one_call_ms, 4),
                              bound_ms=round(bound, 4),
                              plain_ms=round(plain, 3),
                              h_over_one_step=strict)
            if rd == torch.bfloat16:
                worst = min(worst, share)
            del args, xo, h, want_x, want_h
    torch.cuda.empty_cache()
    log(f"[32] lowest share of the byte bound in bf16: {100 * worst:.1f}%")

    # launches a full-width t2v-1.3B forward (one frame at 480x832)
    cfg = T2V_1_3B.model
    gen = torch.Generator(device="cuda").manual_seed(32)
    x = torch.randn((1, 16, 1, 60, 104), generator=gen, device="cuda")
    ctx = torch.randn((1, 128, cfg.text_dim), generator=gen, device="cuda")
    sin, cos = rope_angles_3d((1, 30, 52), cfg.head_dim, seq_len=1560,
                              device="cuda")
    t = torch.tensor([900.0], device="cuda")
    pol = T2V_1_3B.policy
    launches = {}
    for trainable in (False, True):
        model = build_wan_model(cfg, "cuda", torch.bfloat16, seed=0,
                                trainable=trainable)
        before = BLOCK_NORM.launches
        with torch.set_grad_enabled(trainable):
            v = model(x, t, ctx, seq_len=1560, rope_sin=sin, rope_cos=cos,
                      policy=pol, remat=trainable)
        if trainable:       # remat's recompute; the op's backward is eager
            v.float().square().mean().backward()
        torch.cuda.synchronize()
        launches["train_forward_backward" if trainable
                 else "serve_forward"] = BLOCK_NORM.launches - before
        del model, v
    log(f"[32] block_norm launches a t2v-1.3B DiT forward: {launches}")
    if launches != {"serve_forward": 4 * cfg.num_layers,
                    "train_forward_backward": 8 * cfg.num_layers}:
        fail(f"block_norm launches {launches}")
    head = forms["B d=1536 bfloat16"]
    return dict(name=BLOCK_NORM.name, route="cuda",
                source="omnihuman_tpu_torch/csrc/block_norm.cu",
                replaces="none (XLA fuses the JAX block's elementwise work)",
                shape=f"site B, {b} x {l} rows, dim 1536, bf16",
                **head, forms=forms, launches_a_forward=launches)



# ---------------------------------------------------------------------------
# phase 33: qk_norm_rope, the attention's q / k RMSNorm and 3D RoPE in one pass

QK_ROWS = (2, 32768)         # the fused CFG batch at the flagship's tokens


def _qk_args(form, b, l, d, rd, seed):
    """qk_norm_rope's arguments in one form the DiT calls: q and k [b, l,
    d] in rd (or a 512-row text k), bf16 norm weights, the flagship grid's
    tables padded to l rows."""
    import torch
    from omnihuman_tpu_torch.ops.rope import rope_angles_3d
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rows(n, scale):
        return (torch.randn(b, n, d, generator=gen, device="cuda") * scale
                ).to(rd)

    q, k = rows(l, 3.0), rows(l if form == "self" else 512, 0.5)
    wq, wk = ((1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
        torch.bfloat16) for _ in range(2))
    sin, cos = rope_angles_3d((21, 30, 52), 128, seq_len=l, device="cuda")
    if form == "self":
        return q, k, wq, wk, sin, cos
    return q, k, wq, wk, None, None          # "cross": q and the text k


def _qk_bytes(args) -> int:
    """Each input and output once: q and k read and written, the tables
    and the weights read."""
    return sum(2 * t.numel() * t.element_size() if i < 2 else
               t.numel() * t.element_size()
               for i, t in enumerate(args) if t is not None)


def phase_qk_norm_rope():
    """qk_norm_rope against the eager chain (`rms_norm` then `apply_rope`)
    at both published widths, 65,536 rows: the self-attention's q and k
    with the tables (bf16 and fp32 rows), the cross-attention's q with a
    512-row text k; ms back to back and for one call, the byte bound, the
    eager ms; the kernel's launches in a full-width t2v-1.3B DiT forward
    without the gradient, and in a forward and backward with it and
    per-block remat. Returns the JSON row (the 1536 self form's numbers as
    the headline)."""
    import torch
    from omnihuman_tpu_torch.configs import T2V_1_3B
    from omnihuman_tpu_torch.models.wan_dit import build_wan_model
    from omnihuman_tpu_torch.ops.qk_norm_rope import (
        QK_NORM_ROPE, qk_norm_rope_eager, qk_norm_rope_op)
    from omnihuman_tpu_torch.ops.rope import apply_rope, rope_angles_3d

    ptxas_facts(QK_NORM_ROPE.source, "33", "qk_norm_rope")
    b, l = QK_ROWS
    forms, worst = {}, 1.0
    for d in (1536, 5120):
        for form, rd in (("self", torch.bfloat16), ("cross", torch.bfloat16),
                         ("self", torch.float32)):
            args = _qk_args(form, b, l, d, rd, seed=d)
            got = qk_norm_rope_op(*args, 1e-6)
            want = qk_norm_rope_eager(*args, 1e-6)
            normed = qk_norm_rope_op(*args[:4], None, None, 1e-6)
            torch.cuda.synchronize()
            apart = 0
            for g, w, n in zip(got, want, normed):
                if args[4] is not None:     # the rotation of its own norm
                    again = apply_rope(n.unflatten(-1, (-1, 128)), args[4],
                                       args[5]).flatten(-2)
                    if not torch.equal(g, again):
                        fail(f"qk_norm_rope {form} d={d} {rd}: the rotation "
                             "differs from apply_rope of the kernel's norm")
                apart += int((g != w).sum().item())
                tol = (2.0 ** -6 if rd == torch.bfloat16 else 2.0 ** -18) * (
                    w.float().unflatten(-1, (-1, 2)).square().sum(-1).sqrt()
                    .repeat_interleave(2, dim=-1))
                if ((g.float() - w.float()).abs() > tol).any():
                    fail(f"qk_norm_rope {form} d={d} {rd}: more than two "
                         "steps of a pair's magnitude from the eager chain")
            del got, want, normed
            one_call_ms = bench_ms(lambda: qk_norm_rope_op(*args, 1e-6))
            back_to_back_ms = bench_ms(lambda: [
                qk_norm_rope_op(*args, 1e-6)
                for _ in range(BN_BATCH)]) / BN_BATCH
            plain = bench_ms(lambda: qk_norm_rope_eager(*args, 1e-6), reps=3)
            bound = _qk_bytes(args) / PEAK_BYTES * 1e3
            share = bound / back_to_back_ms
            tag = f"{form} d={d} {str(rd).removeprefix('torch.')}"
            log(f"[33] {tag}: {back_to_back_ms:.4f} ms a call back to back "
                f"({one_call_ms:.4f} one call with its wrapper), bound "
                f"{bound:.4f} ms (bytes), {100 * share:.1f}%; eager "
                f"{plain:.3f} ms; elements apart from eager {apart}")
            forms[tag] = dict(back_to_back_ms=round(back_to_back_ms, 4),
                              one_call_ms=round(one_call_ms, 4),
                              bound_ms=round(bound, 4),
                              plain_ms=round(plain, 3), apart=apart)
            if rd == torch.bfloat16:
                worst = min(worst, share)
            del args
    torch.cuda.empty_cache()
    log(f"[33] lowest share of the byte bound in bf16: {100 * worst:.1f}%")

    # launches a full-width t2v-1.3B forward (one frame at 480x832)
    cfg = T2V_1_3B.model
    gen = torch.Generator(device="cuda").manual_seed(33)
    x = torch.randn((1, 16, 1, 60, 104), generator=gen, device="cuda")
    ctx = torch.randn((1, 128, cfg.text_dim), generator=gen, device="cuda")
    sin, cos = rope_angles_3d((1, 30, 52), cfg.head_dim, seq_len=1560,
                              device="cuda")
    t = torch.tensor([900.0], device="cuda")
    launches = {}
    for trainable in (False, True):
        model = build_wan_model(cfg, "cuda", torch.bfloat16, seed=0,
                                trainable=trainable)
        before = QK_NORM_ROPE.launches
        with torch.set_grad_enabled(trainable):
            v = model(x, t, ctx, seq_len=1560, rope_sin=sin, rope_cos=cos,
                      policy=T2V_1_3B.policy, remat=trainable)
        if trainable:       # remat's recompute; the op's backward is eager
            v.float().square().mean().backward()
        torch.cuda.synchronize()
        launches["train_forward_backward" if trainable
                 else "serve_forward"] = QK_NORM_ROPE.launches - before
        del model, v
    log(f"[33] qk_norm_rope launches a t2v-1.3B DiT forward: {launches}")
    if launches != {"serve_forward": 2 * cfg.num_layers,
                    "train_forward_backward": 4 * cfg.num_layers}:
        fail(f"qk_norm_rope launches {launches}")
    head = forms["self d=1536 bfloat16"]
    return dict(name=QK_NORM_ROPE.name, route="cuda",
                source="omnihuman_tpu_torch/csrc/qk_norm_rope.cu",
                replaces="none (XLA fuses the JAX attention's q / k norm "
                         "and RoPE)",
                shape=f"self, q and k {b} x {l} rows, dim 1536, bf16",
                **head, forms=forms, launches_a_forward=launches)

def run_slice_12_phases(all_kernels, paths):
    """Phases 25, 26 and 28, each timed (27 runs after phase 6, on phase
    5's pipeline)."""
    import torch
    for phase, fn in ((25, phase_qwen), (26, phase_xlmr),
                      (28, lambda: paths.__setitem__(
                          "profile", phase_tools(all_kernels)))):
        t0 = time.perf_counter()
        try:
            fn()
        finally:
            shutil.rmtree(WORK, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{phase}] phase wall time {time.perf_counter() - t0:.1f} s; "
            f"{_gib_in_use():.2f} GiB in use after it")


def run_training_phases(flash_kernels, all_kernels, paths):
    """Phases 8-11 (the attention kernels K1 / K2 only), then 19-22 on
    phase 8's files (all five kernels); their models and states are
    dropped on return. Returns phase 10's step seconds."""
    import torch
    try:
        counts, npz, dit = timed_phase(8, phase_training_main_path,
                                       all_kernels)
        paths.update(counts)
        state, opt = timed_phase(9, phase_distill_vs_plain, npz,
                                 flash_kernels, dit)
        flagship_s = timed_phase(10, phase_flagship_distill_step, state, opt)
        timed_phase(11, phase_apt_steps, state, npz, flash_kernels)
        del state, opt
        gc.collect()
        torch.cuda.empty_cache()
        run_slice_10_phases(npz, all_kernels, paths, dit)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    return flagship_s


def run_slice_10_phases(npz, all_kernels, paths, dit,
                        phases=(19, 20, 21, 22)):
    """Phases 19-22 (after phase 8, on its files and its frozen DiT), each
    timed; each must give back the device memory it took, or the later
    phases' peaks would read high."""
    import torch
    run = {19: ("generate_ckpt", lambda: phase_ckpt_dir(all_kernels)),
           20: ("f_distill", lambda: phase_f_distill(npz, all_kernels,
                                                     dit)),
           21: ("train_apt", lambda: phase_train_apt(npz, all_kernels,
                                                     dit)),
           22: ("eval_ema", lambda: phase_eval_ema(npz, all_kernels))}
    base = _gib_in_use()
    for phase in phases:
        t0 = time.perf_counter()
        path, fn = run[phase]
        paths[path] = fn()
        gc.collect()
        torch.cuda.empty_cache()
        left = _gib_in_use()
        log(f"[{phase}] phase wall time {time.perf_counter() - t0:.1f} s; "
            f"{left:.2f} GiB in use after it")
        if left > base + 1.0:
            fail(f"phase {phase} left {left - base:.1f} GiB on the card")




def main() -> None:
    if sys.argv[1:2] == ["--sp-worker"]:       # one rank under torchrun
        sys.path.insert(0, HERE)
        return sp_worker(sys.argv[2])
    if sys.argv[1:2] == ["--train-worker"]:    # one rank under torchrun
        sys.path.insert(0, HERE)
        return train_worker(sys.argv[2])
    if sys.argv[1:2] == ["--spatial-worker"]:  # one rank under torchrun
        sys.path.insert(0, HERE)
        return spatial_worker(sys.argv[2])
    if not os.path.isdir(os.path.join(HERE, "omnihuman_tpu_torch")):
        fail("omnihuman_tpu_torch/ is not beside chip_smoke.py: run this "
             "from the root of a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()

    card = phase_card_facts()
    phase_build()
    rows = timed_phase(3, phase_kernels)
    bwd_rows = timed_phase(7, phase_backward_kernels)
    vae_rows = timed_phase(12, phase_vae_kernels)
    bn_row = timed_phase(32, phase_block_norm)
    qk_row = timed_phase(33, phase_qk_norm_rope)
    timed_phase(4, phase_small_reference)
    from omnihuman_tpu_torch.ops.flash_attention import (
        FLASH_BWD, FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    from omnihuman_tpu_torch.ops.vae_kernels import VAE_CONV, VAE_UPSAMPLE
    from omnihuman_tpu_torch.ops.block_norm import BLOCK_NORM
    from omnihuman_tpu_torch.ops.qk_norm_rope import QK_NORM_ROPE
    kernels = (FLASH_FWD_LONG_K, FLASH_FWD_SHORT_K)
    flash_kernels = kernels + (FLASH_BWD,)
    all_kernels = flash_kernels + (VAE_CONV, VAE_UPSAMPLE, BLOCK_NORM,
                                   QK_NORM_ROPE)
    _zero(all_kernels)
    pipe, launches = timed_phase(5, phase_main_path, kernels)
    paths = {"serve": _count(all_kernels)}
    timed_phase("5b", phase_step_vs_plain, pipe)
    timed_phase(6, phase_flagship_step, pipe)
    t0 = time.perf_counter()
    try:
        paths["export"] = phase_export(all_kernels, pipe)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"[27] phase wall time {time.perf_counter() - t0:.1f} s")
    run_sp_phase(all_kernels, pipe, paths)
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    flagship_s = run_training_phases(flash_kernels, all_kernels, paths)
    gc.collect()
    torch.cuda.empty_cache()
    run_sp_train_phase(all_kernels, paths, flagship_s)
    paths.update(timed_phase(13, phase_vae_full, (VAE_CONV, VAE_UPSAMPLE)))
    paths["i2v"] = timed_phase(14, phase_i2v, all_kernels, kernels)
    paths["one_step"], one_step_ref = timed_phase(15, phase_one_step,
                                                  all_kernels, kernels)
    spatial = run_spatial_phase(all_kernels, paths, one_step_ref)
    del one_step_ref
    paths["omni"], omni_pipe = timed_phase(16, phase_omni, all_kernels,
                                          kernels)
    try:
        t0 = time.perf_counter()
        paths["omni_pose"], proc = phase_pose(all_kernels, kernels, card,
                                              omni_pipe)
        del omni_pipe
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[23] phase wall time {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_eval(card, proc)
        del proc
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[24] phase wall time {time.perf_counter() - t0:.1f} s; "
            f"{_gib_in_use():.2f} GiB in use after it")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    timed_phase(17, phase_int8_step)
    try:
        paths["omni_train"], _ = timed_phase(18, phase_omni_train,
                                             all_kernels, flash_kernels)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    run_slice_12_phases(all_kernels, paths)
    log(f"smoke wall time {time.perf_counter() - t_start:.0f} s")

    def by_path(kn):
        return {p: c.get(kn.name, 0) for p, c in paths.items()}

    # every path that ran a DiT block ran its residual sites through
    # block_norm and its attentions' q / k through qk_norm_rope (K1 runs
    # only inside the DiT's attention)
    for kn in (BLOCK_NORM, QK_NORM_ROPE):
        without = [p for p, c in paths.items() if kn.name in c and (
            c[FLASH_FWD_LONG_K.name] or c[FLASH_FWD_SHORT_K.name])
            and not c[kn.name]]
        log(f"{kn.name} launches by path: {by_path(kn)}")
        if without:
            fail(f"paths that ran the DiT without {kn.name}: {without}")

    fwd_src = "omnihuman_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "omnihuman_tpu_torch/csrc/flash_bwd.cu"
    out = []
    for key, kn, n, replaces in (
            ("long", FLASH_FWD_LONG_K, launches[0],
             "omnihuman_tpu/ops/flash_pallas.py:193"),
            ("short", FLASH_FWD_SHORT_K, launches[1],
             "omnihuman_tpu/ops/flash_pallas.py:94")):
        out.append(dict(name=kn.name, route="cuda", source=fwd_src,
                        replaces=replaces, launches=n, **rows[key],
                        launches_by_path=by_path(kn)))
    out.append(dict(name=FLASH_BWD.name, route="cuda", source=bwd_src,
                    replaces="omnihuman_tpu/ops/flash_pallas.py:387 and "
                             "omnihuman_tpu/ops/flash_pallas.py:437",
                    launches=paths["train_distill"][FLASH_BWD.name],
                    **bwd_rows["k2"], launches_by_path=by_path(FLASH_BWD)))
    for key, kn, src, replaces in (
            ("k3", VAE_CONV, "omnihuman_tpu_torch/csrc/vae_conv.cu",
             "omnihuman_tpu/ops/vae_pallas.py:58"),
            ("k4", VAE_UPSAMPLE, "omnihuman_tpu_torch/csrc/vae_upsample.cu",
             "omnihuman_tpu/ops/vae_pallas.py:278")):
        out.append(dict(name=kn.name, route="cuda", source=src,
                        replaces=replaces, launches=paths["i2v"][kn.name],
                        **vae_rows[key], launches_by_path=by_path(kn),
                        w_shard_rows=spatial[key]))
    out.append(dict(bn_row, launches=paths["serve"][BLOCK_NORM.name],
                    launches_by_path=by_path(BLOCK_NORM)))
    out.append(dict(qk_row, launches=paths["serve"][QK_NORM_ROPE.name],
                    launches_by_path=by_path(QK_NORM_ROPE)))
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
