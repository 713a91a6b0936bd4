#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (upnerf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --kernel_times [--profile DIR]

Phases, each of which must pass (the script exits non-zero otherwise):
  1. the card: name and power limit from nvidia-smi;
  2. build: nvcc compiles upnerf_torch/csrc/*.cu for sm_90a, one process per
     source (and per timing variant), all at once; each kernel's ptxas report,
     and none of the heads forward's or the probe's wgmma serialized
     (C7512);
  3. the forward kernel's serving mode against its plain PyTorch version on
     one 4096-ray chunk at the brandenburg_gate width, S = 64, 100, 128 and
     256 samples, float32 and bfloat16, and two calls bit for bit;
  4. the serving path: a seeded checkpoint at that width is rendered for 2
     frames at 128x128 by `upnerf_torch.cli.render_video.main`, every
     coarse and fine pass through the kernel; then rays of frame 0 rendered
     on the card are held against the same rays rendered on the CPU;
  5. timings of the serving kernel and the plain version per chunk and per
     frame; then (5b) the forward's two bf16 designs per 4096 x 256 chunk
     in turns (the route's wgmma kernel and the mma.sync design it replaced;
     render_train.FWD_DESIGNS) in
     the serving, phase-1 and phase-0 residual, recompute residual, kernel-4
     and F = 32 modes: ms, TFLOP/s, share of the bound, L2 weight bytes, the
     designs against each other and two calls bit for bit;
  6. the forward kernel in the phase-0 and phase-1 training modes, with the
     residuals the backward reads, against its plain version at the train
     batch (2048 rays), S = 64, 100, 128 and 256, float32 and bfloat16; and
     at the validation configs' feature width F = 32 (S = 256);
  7. the backward kernel against `render_train_rays_bwd_plain` on the same
     inputs and residuals and random cotangents, every cotangent (F = 384
     and 32);
  8. the flagship train step, `upnerf_torch.train.step.make_train_step`, on
     an in-memory scene as the JAX package's benchmark builds it (16 images
     of 256x256, 55x55x384 bf16 features, batch 2048, 128 + 128 samples,
     bfloat16): 1 warm-up and 3 steps in each of phases 0, 1 and 2, each
     step 2 forward and 2 backward kernel launches (each bf16 backward, per
     slab of rays, the Hopper walk's three launches, its pre-pass, walk and
     finishing pass, and a dW kernel launch); then one phase-1 step of
     256 rays on the card (kernels) against the same step on the CPU (plain
     versions), on the loss terms and every gradient;
  9. step ms and rays/s per phase (CUDA events), the backward kernel against
     the plain backward per 4096-ray chunk (F = 384 and 32), the step's peak
     memory; the backward's pieces per chunk in turns (the walk with its
     operand stores and the dW kernel over all slabs, the frozen walk), the
     bf16 backward's two designs in turns (the Hopper walk and the mma.sync
     walk it replaced, render_train.BWD_DESIGNS), the Hopper walk's three
     kernels over all slabs, each against its plain twin on the first slab
     (the pre-pass's coefficient rows within WALK_COEF_TOL and its mask words
     bit for bit, the walk's per-tile partial sums and bias rows and the
     finishing pass's outputs within BWD_TOL) and timed beside it; the
     call's peak memory, its bound and the design's byte floor; the dW kernel against its
     plain version at full width (DW_TOL), and two dW calls and two backward
     calls bit for bit; with
     --profile, a torch.profiler table of one phase-1 step into DIR (and of
     one fast frame, phase 15);
 10. the flash-attention kernel against its plain PyTorch version at the
     DINO extractor's shape (6 heads x 12,322 tokens x 64), bfloat16 and
     float32, unit-normal and logits x 20, and at N = 300 (ragged tiles);
     ms of each at N = 12,322 bfloat16, in turns (plain, kernel, kernel,
     plain, then F.scaled_dot_product_attention), with the kernel's TFLOP/s,
     its share of the bound (tensor cores, SFU exponentials, bytes) and its
     L2 read estimate;
 11. the offline extractors through `upnerf_torch.cli.preprocess.main` at
     full width (DINO ViT-S/8 at 448 stride 4, DPT-Large at 384) on two PNGs
     of 500x375 and 640x480, from seeded npz weights: the files, their
     shapes and dtypes, 9 kernel launches per DINO image; image 0's DINO map
     from the card held against the CPU (plain version); ms per image and
     peak memory of each extractor;
 12. the backward kernel's frozen-model mode (param_grads=False, test-time
     optimization's) at 4096 rays, S = 256, phase 2 bf16 / f32 and phase 1
     bf16: its data cotangents equal the train mode's bit for bit and meet the
     plain frozen backward; both modes timed in turns per chunk, and the
     frozen mode's two bf16 designs in turns (phase 2);
 13. TTO -> eval through `upnerf_torch.cli.tto.main` and
     `upnerf_torch.cli.eval.main` at the brandenburg_gate width, on a
     Phototourism-layout scene the port writes (COLMAP binaries, tsv, PNGs of
     the checkpoint's renders at the GT poses, read through the LANCZOS
     downscale 2): the files, finite metrics, 2 forward + 1 frozen backward
     launches a step, refined test poses near GT, eval's train pose errors ~0,
     SSIM on the card against the CPU; ms of a TTO step (4 x 1024 rays) and of
     an eval chunk;
 14. the trunk kernel (the trunk-only mode of heads_fwd.cu) against its plain
     version at 262,144 rows (the fast render's probe) and at a ragged N, bf16
     and f32; ms of each in turns; the bf16 forward's two designs
     (heads.HEADS_FWD_DESIGNS: wg_fwd_kernel and the mma.sync design it
     replaced) against each other and in turns (ms, TFLOP/s, share of the
     bound);
 15. `upnerf_torch.cli.render_video --fast` for 2 frames at 128x128: the
     files and the trunk kernel's launches; a fast frame's ms against phase
     5's full-budget frame;
 16. the trunk + heads kernels (kernel 5: `ops.heads`, csrc/heads_fwd.cu and
     heads_bwd.cu) against their plain versions, the forward and every
     backward output, at 524,288 rows (2048 rays x 256 samples) in bf16 with
     and without the candidate branch and in f32 at 65,536 rows and a ragged
     N, the backward also against its plain version in float64; forward and
     backward timed in turns, the forward's two bf16 designs as in phase 14,
     the bf16 forward at N = 1 .. 1037 around the tiles' edges (F = 32 / 64 /
     384, each mode), and the backward's route in pieces (the Hopper
     walk with its operand stores, the dW kernel, per slab of rows) with the
     call's peak memory; then the F = 32 instances (524,288 rows bf16, 65,536 and 1,037 rows f32),
     timed in turns;
 17. the static render from PE rows (kernel 4: the x0 mode of the render
     forward, `ops.render`) against its plain version and against the
     serving mode on the same rays, 4096 x 256, bf16 and f32, at F = 384 and
     32; timed in turns;
 18. `upnerf_torch.cli.train.main` at brandenburg_gate's width and batch 2048
     on a Phototourism-layout scene of PNGs with seeded DINO / DPT maps, 12
     steps (phases 0, 1, 2; a val render and a checkpoint every 6 steps):
     (a) the default flags, (b) `tpu.fused_train false`, (c) (a) resumed to
     14 steps; each run's kernel launches (kernels 1/2 in the steps of (a),
     kernel 5 in the steps of (b) and kernel 4 in its val renders), finite
     losses and val PSNR; (b)'s checkpoint rendered by `render_video`; ms of a
     phase-1 step of (b) against phase 9's, and the loop's rays/s;
 19. the trunk kernel's backward (the trunk-only mode of heads_bwd.cu, the
     feature-less field's) against its plain version at 524,288 rows bf16,
     65,536 rows f32 and a ragged N, and against the plain backward in
     float64; timed in turns with the plain version;
 20. the feature-less field: `upnerf_torch.cli.train.main` with
     `--config configs/brandenburg_gate.yaml nerf.feat_dim 0` (full width,
     batch 2048, 128 + 128 samples) on phase 18's scene, 12 steps across
     phases 0, 1, 2 with a val render: 2 trunk forward + 2 trunk backward
     launches a step and none of kernels 1, 2, 4, 5; then `cli.tto` and
     `cli.eval` on its checkpoint (1 pose and 1 appearance epoch) and
     `cli.render_video --result_dir` on its run directory; ms of a phase-1
     step against phase 9's fused step;
 21. a scene written by `upnerf_torch.data.synthetic.generate_scene` at
     configs/validation/synth_pose.yaml's size, trained by `cli.train
     --config configs/validation/synth_pose.yaml` for 12 steps (phases 0, 1,
     2): (a) the default flags, through the F = 32 instances of kernels 1 and
     2; (b) `tpu.fused_train false`, through those of kernels 5 and 4; each
     run's launches and finite losses;
 22. the recompute mode (save_chain=False) at 4096 rays x 256 samples, bf16
     and f32, phases 0, 1, 2, F = 384 and 32: kernel 1's forward without a
     chain (outputs and the sig / feat / c_feat / rgb residuals) against its
     plain version; kernel 2's recompute train mode against the plain
     recompute backward (data cotangents by RMS with a float64 witness,
     weight gradients at REC_DW_TOL and by the witness) and against the
     saved-chain kernel (everything at BWD_TOL); the frozen recompute mode
     equal to the train mode bit for bit; then, in
     turns at F = 384 bf16, each recompute kernel against its saved-chain
     counterpart and its plain version, and the recompute backward's route
     in pieces over the chunk's slabs (the chain rebuilt by the forward
     kernel, the walk, the dW kernel) beside the whole call;
 23. the memory-saving configuration: the flagship step with save_chain off
     (ms and peak memory per phase beside phase 9's, the peak within
     REC_STEP_PEAK_GIB, the backward's chain rebuilds); the host prefetcher on
     a memmapped store of 1.3e8 rays (gather ms, the step's wait, streaming
     rays/s against the device-resident store); `cli.train` with
     `tpu.save_chain false tpu.store_on_device false` on phase 18's scene
     (12 steps, 2 + 2 recompute launches a step, the loop's rays/s); then
     `cli.tto` (2 forwards + 1 frozen recompute backward a step) and
     `cli.eval` on its checkpoint, and a TTO step's ms against phase 13's;
 24. kernel 1b, the fused render from pre-built PE rows (the X0_IN mode of
     both render kernels, `ops.render_train.render_train_fwd` /
     `render_train_bwd`) at 4096 rays x 256 samples, F = 384 and 32, bf16 and
     f32, phases 0, 1, 2, the saved chain and the recompute mode, on the PE
     rows of seeded rays (in0 = 63) and at F = 384 phase 1 on rows of width
     40: the forward with residuals against its plain version and the rays
     mode's kernel; the d_x0 backward's train and frozen modes against the
     plain backward (by the max on the saved chain; by RMS with the float64
     witness in the recompute mode), frozen equal to train bit for bit; both
     kernels timed in turns with the rays mode's and the plain versions at
     4096 x 256 and 2048 x 384; then `upnerf_torch.scripts.
     bench_render_train_kernel` at its defaults with 3 steps (4 forward and 4
     backward launches);
 25. the matrix-unit probe (`ops.mxu_probe`, csrc/mxu_probe.cu: the route's
     wg_probe_kernel) at the JAX probe's shapes (M 2048, W 256, L 16, 64
     copies): the pure / epi / int8 chains against their plain versions
     (int8 bit for bit, bf16 by RMS), then `upnerf_torch.scripts.
     bench_mxu_probe` at its defaults (31 launches a chain): ms, TFLOP/s or
     TOPS, share of the dense peak, the plain version's and the library
     products' ms; then both designs (mxu_probe.PROBE_DESIGNS: wgmma and the
     mma.sync design it replaced) against each other and in turns: ms, rate,
     share of the bound, and the L2 bytes of each design's weight reads with
     the rate they imply;
 26. run-to-run bits: each mode twice on the same inputs (the render
     kernels at 2048 x 256; kernels 5 and 6 at 524,288 rows; the probe's
     chains at phase 25's shapes), how many outputs differ and by how much;
     same bits required of every mode in bf16 and f32: the forward (saved
     chain and recompute), kernel 2's train backward (saved chain and
     recompute), the frozen mode, kernels 5 and 6's forward and backward
     (no backward adds a weight gradient with atomics), and the probe;
 27. the pose-warp mitigations and the optimizer kinds at brandenburg_gate's
     width: (a) the candidate scorer (`train.warp.make_pose_scorer`, 10
     candidates x 1024 rays in one render call) on an image whose feature
     map is the model's own render from its base pose and whose incumbent is
     warped, through kernel 1's forward (tpu.fused_train on) and kernel 5's
     (off), each against its plain route on the card in f32 (score_tol), the
     base pose first, the call's ms in bf16; (b) `cli.train` with
     `pose.warp.mitigate multistart` and a hair-trigger detector on phase
     18's scene, 102 steps, both fused_train settings: one event, the
     adopted rows' Adam moments zero right after it, finite losses after it,
     the scorer's launches; (c) the same with `reset`: the flagged se3 rows
     zero at the event; (d) `optimizer.type adamw` with a cosine schedule and
     `optimizer_pose.type sgd` with a constant one: finite, every logged LR
     its closed form;
 28. data parallel (`upnerf_torch.parallel`): (a) two ranks on the one card
     over gloo (`parallel.launch`, the kernels built before the spawn) at
     brandenburg_gate's width on phase 8's scene, phase 1, bf16, batch 2048
     (1024 a rank): a teacher-forced step against one rank (loss terms and
     metrics within DP_METRIC_TOL, every gradient within DW_TOL of its max;
     each rank's per-ray render outputs against the one-rank rows, differing
     values counted), then 3 steps drawn by step_fn (launches, ms, each
     rank's peak memory, the ranks' parameters bit for bit) and the
     all-reduce alone; (d) in the same ranks, a TTO step and an eval chunk
     through a two-rank TTORunner against one rank (the eval bit for bit
     against one rank rendering the same rays a call); (b) `cli.train
     dist.num_processes 1`, a one-rank NCCL group, 4 steps; (c) two
     `cli.train` processes with dist.* keys on phase 18's scene, 12 steps:
     rank 0's files only, its checkpoint through `cli.tto`.
 29. the quality-protocol drivers (`upnerf_torch.scripts.pose_protocol`,
     `tto_protocol`) at cut lengths into a temporary directory: the pose
     recipe, seed 42, PROTOCOL_POSE_STEPS steps through kernels 1 / 2 and
     the dW kernel at F = 32; the TTO recipe, seed 42, PROTOCOL_TTO_STEPS
     steps, then `cli.tto` (epochs cut) and `cli.eval`; each record's keys
     against the JAX record's plus "device", the rel-R trace, finite TTO
     PSNR / SSIM, each run's launches (2 + 2 a train step, the dW kernel a
     slab, the frozen backward a TTO step); each call again reuses the
     finished seed and launches no kernel.
 30. JPEG scenes, with no PIL on the host: (a) the ported generator writes
     a Phototourism-layout scene of JPEGs (12 + 4 views of 512x384, quality
     95, 4:2:0); `cli.preprocess` runs on them with phase 11's seeded
     full-width npz weights (9 flash launches an image), then
     `cli.prepare_cache`, `cli.train` at brandenburg_gate's settings
     (img_downscale 2, from the cache; 12 steps: kernels 1 / 2, the Hopper
     walk and the dW kernel), `cli.tto` (kernel 2 frozen, kernel 1) and
     `cli.eval`; each run's launches, finite losses and metrics; (b) ms of
     `decode_jpeg`, `encode_jpeg` and `read_png_rgb` on a 1024x768 image
     and the scene's load from its JPEGs and from the cache; (c) the
     fixtures in tests/torch_jpeg_fixtures/ decode to PIL's pixels and the
     seeded array encodes to PIL's bytes; "PIL" never imported.

The last two lines are one JSON object describing each kernel (with its
bound from the shapes and the library call's time where PyTorch has one),
and {"ok": true, "device": {...}}. Needs torch with CUDA, nvcc and one card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

# The keys the port reads, as upnerf/config/default.yaml + configs/brandenburg_gate.yaml
# resolve them (tests/test_torch_render_slice.py checks the two agree).
BRANDENBURG_GATE = {
    "nerf.D": 8,
    "nerf.W": 256,
    "nerf.skips": (4,),
    "nerf.N_emb_xyz": 10,
    "nerf.N_emb_dir": 4,
    "nerf.feat_dim": 384,
    "nerf.appearance_dim": 48,
    "nerf.candidate_dim": 16,
    "nerf.N_samples": 128,
    "nerf.N_importance": 128,
    "nerf.near": 0.1,
    "nerf.far": 5.0,
    "nerf.use_disp": False,
    "nerf.perturb": 1.0,
    "pose.c2f": (0.1, 0.5),
    "val.chunk_size": 4096,
    "tpu.matmul_precision": "bfloat16",
    "t_net.beta_min": 0.1,
    "t_net.transient_dim": 128,
    "t_net.feat_dim": 384,
}

# Kernel against plain version on the card. f32: both sum in f32 in another
# order (cuBLAS against the kernel's k-loop), ~1e-6 relative a layer. bf16:
# an activation whose f32 sum lands on the other side of a bf16 rounding
# boundary moves by one bf16 ulp (2^-8 relative), rarely.
TOL = {"float32": 1e-5, "bfloat16": 1e-3}
# The saved walk chain, max |d| over max |value|: f32 as above; bf16 values
# are stored rounded, so a rounding flip is one bf16 ulp (2^-8) of the value.
CHAIN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Backward kernel against the plain backward, per cotangent, max |d| over the
# leaf's max |g|: f32 sums in another order (the dW kernel's fixed order
# against cuBLAS's) over up to 2048 x 256 samples; bf16 also rounds every
# cotangent to bf16 before each product, where one flip is 2^-8 of a term.
BWD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# The Hopper walk's pre-pass against walk_coef_plain, per coefficient column, max
# |d| over the column's max: the compositing in the same f32 order, but p and q
# sum the bf16 products of the feat / c_feat head in another order (xyzf (Wf g)).
WALK_COEF_TOL = 1e-3
# A frame's rays on the card (kernel) against the CPU (plain version):
# besides the above, fine samples move with the coarse weights, and the top
# PE band (2^9 pi) turns a 1e-6 move of a sample into a ~2e-3 change of x0.
E2E_TOL = 1e-2
# One train step of 256 rays, card (kernels) against CPU (plain versions),
# bf16: loss terms relative; gradients max |d| over the leaf's max |g|. The
# kernels and the plain versions round in the same places, but a product
# summed in another order can round a bf16 operand the other way, and the
# fine samples follow the coarse weights (sample_pdf), so the two steps see
# slightly different samples.
STEP_LOSS_TOL = 1e-3
STEP_GRAD_TOL = 5e-2
CHUNK = 4096
FRAME_WH = (128, 128)
FOCAL = 128.0
TRAIN_RAYS = 2048
STEP_PHASES = (0, 1, 2)
MAX_STEPS = 600000
PHASE_PROGRESS = {0: 0.0, 1: 0.3, 2: 0.6}  # inside each phase of the candidate schedule (0.1, 0.5)
# Flash attention, kernel against plain version at the kernel's key tile,
# absolute on unit-normal q, k, v: f32 sums in another order (f32); an f32
# score or sum on the other side of a bf16 rounding boundary moves a p by one
# bf16 ulp, 2^-8 relative (bf16). With logits x 20 the softmax is peaked, so
# such a flip lands on a weight near 1.
ATTN_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
ATTN_PEAKED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
DINO_HEADS, DINO_TOKENS = 6, 12322  # ViT-S/8 at 448x448, stride 4: 111 x 111 + CLS
DINO_GRID, DINO_DIM = 111, 384
# Image 0's DINO map, card (kernel) against CPU (plain version at the same
# tile), max |d| over max |value|: the bf16 flips above, through 9 blocks.
DINO_E2E_TOL = 1e-2
EXTRACT_IMAGES = (("scene_a.png", (375, 500)), ("scene_b.png", (480, 640)))
# The trunk kernel against its plain version, max |d| over max |value| of the
# (N, 256) f32 output: f32 sums in another order over 8 layers; in bf16 an
# activation whose f32 sum lands on the other side of a bf16 rounding boundary
# moves by one bf16 ulp (2^-8 relative) and carries into the next layers.
# Such flips are sparse but reach the max: the f32 plain trunk is ~2.6e-3 from
# the bf16 one by this measure, so the max alone cannot tell a kernel that
# skips the bf16 rounding. TRUNK_RMS_RATIO does: the kernel's RMS distance to
# the plain version of its own precision must be under this share of its RMS
# distance to the plain version of the other precision (a summation order
# that differs in every sum reads ~0.05 on the CPU; no rounding reads ~1).
TRUNK_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
TRUNK_RMS_RATIO = 0.25
# Kernel 5's backward against its plain version. Both recompute the forward
# chain, each in its own summation order, so a ReLU pre-activation within
# rounding of zero can land on the other side in one of them, and that row's
# gradient through the unit switches on or off (the render backward reads one
# saved chain and has no such flips): on the card dx0 moves by up to ~0.17 of
# its max in bf16 and ~0.05 in f32, but by ~4e-3 of its RMS. So weight
# gradients (sums over all rows): max |d| over max |g| <= 2e-2; the per-row dx0
# and dc_emb by RMS: RMS distance over RMS value <= 2e-2, and RMS distance to
# the plain version of the kernel's precision under TRUNK_RMS_RATIO of the
# distance to the other precision's (bf16 rounds its operands, f32 does not).
# A second witness shows that these gaps are rounding: the plain backward in
# float64 on the same inputs. The kernel's RMS distance to it, on dx0, dc_emb
# and all weight gradients together, must be within HEADS_F64_RATIO of the
# plain version's own distance to it.
HEADS_BWD_TOL = 2e-2
HEADS_ROW_RMS_TOL = 2e-2
HEADS_F64_RATIO = 2.0
# The render backward's recompute mode against its plain version: the kernel
# rebuilds the chain in the forward kernel's summation order, the plain version
# in cuBLAS's, so ReLU masks flip between them as in kernel 5's backward; in f32
# a flipped sample moves a weight gradient by up to ~4e-4 of its max at
# 4096 x 256 (measured on the card), over BWD_TOL's 1e-4. Weight gradients
# there: max |d| over max |g| <= REC_DW_TOL, and the float64 witness above.
REC_DW_TOL = {"float32": 1e-3, "bfloat16": 1e-2}
# The memory-saving step's peak (phase 23 (1)): the recompute mode exists to save memory (the saved chain's step
# peaks at ~5 GiB); its slab buffers (render_train.REC_BUFFER_BYTES) add at most 0.5 GiB to the ~2.6 GiB the step
# held with a per-block scratch in their place (measured on one H100).
REC_STEP_PEAK_GIB = 3.2
# The dW kernel (csrc/dw_gemm.cu) against its plain version on the same stored bf16
# operands, per weight gradient and the biases, max |d| over max |g|: both sum the
# same exact products in f32, in another order, over ~100,000 samples a slab.
DW_TOL = 1e-4
PROBE_ROWS = CHUNK * 64  # the fast render's sigma-only probe: 4096 rays x 64 samples
# Phase 13's scene: a ring of 8 train and 4 test cameras, PNGs of 128x96 that
# the loader's img_downscale 2 (brandenburg_gate's) reads as 64x48, TTO in one
# group of 4 with batch 1024 (4096 rays a step).
TTO_TRAIN, TTO_TEST, TTO_PNG_WH, TTO_FOCAL = 8, 4, (128, 96), 100.0
TTO_EPOCHS = (4, 3)  # pose, appearance
TRAIN_IMAGES = 8  # phase 18's train images (+ 2 test), read at brandenburg_gate's img_downscale 2 as 64 x 48
# The test images are the checkpoint's renders at the GT test poses, and its
# se3 table holds the GT train poses, so TTO starts at the GT test pose; the
# only pull away from it is the fresh appearance embedding. Adam moves each se3
# component by at most lr (1 - b1) / sqrt(1 - b2) = 3.16 lr = 3.2e-4 a step, so
# 4 epochs x 3 steps move a rotation by at most 12 x 3.2e-4 x sqrt(3) rad = 0.38
# degrees. A wrong alignment or composition order would land degrees away.
TTO_POSE_DEG = 0.5
# eval's train-pose errors: the se3 table is the GT, so only f32 rounding
# (arccos near 1 floors the angle at ~0.03 degrees).
EVAL_POSE_DEG = 0.1
SSIM_TOL = 1e-5  # SSIM card vs CPU: the same f32 operations, sums in another order
# Phase 29: the protocol drivers at cut lengths. The pose recipe logs its rel-R every max(500, steps // 30)
# steps and a run is reused when its last log is its last step, so 500 steps log one row, at the end;
# synth_tto logs poses every 1000 steps, so a 1000-step TTO run logs the pose keys of the JAX record's rows.
# TTO's pose / appearance epochs are cut to these (eval every 10).
PROTOCOL_POSE_STEPS, PROTOCOL_TTO_STEPS, PROTOCOL_TTO_EPOCHS = 500, 1000, (20, 4)
# Phase 30: a Phototourism-layout scene of JPEGs (quality 95, 4:2:0) from the ported generator, 12 train and
# 4 test views, read at brandenburg_gate's img_downscale 2; the host codec timed on a 1024 x 768 image; the
# fixtures PIL wrote (tests/test_torch_jpeg.py:write_fixtures).
JPEG_VIEWS, JPEG_WH, JPEG_FOCAL, JPEG_STEPS = (12, 4), (512, 384), 420.0, 12
JPEG_HOST_WH = (1024, 768)
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_jpeg_fixtures")
# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them; HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean ms of fn() over `reps` runs, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chunk_inputs(field, S: int, seed: int, dev, R: int = CHUNK):
    """R rays as the render path gives them to the kernel: unit directions,
    sorted depths in [near, far], the field's ray_cond, a candidate embedding."""
    from upnerf_torch.render.render_rays import ray_conditioning

    rng = np.random.RandomState(seed)
    o = torch.tensor(rng.randn(R, 3).astype(np.float32) * 0.3, device=dev)
    d = torch.tensor(rng.randn(R, 3).astype(np.float32), device=dev)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    z = torch.tensor(rng.uniform(0.1, 5.0, (R, S)).astype(np.float32), device=dev)
    z = torch.sort(z, -1).values.contiguous()
    a_emb = torch.tensor(rng.randn(R, field.cfg.appearance_dim).astype(np.float32), device=dev)
    c_emb = torch.tensor(rng.randn(R, field.cfg.candidate_dim).astype(np.float32), device=dev)
    with torch.no_grad():
        cond = ray_conditioning(field, d, a_emb, 1.0)
    return o, d, z, torch.ones(field.cfg.xyz_L, device=dev), cond, c_emb


def read_png_size(path: str):
    """(width, height) of an 8-bit RGB PNG, checking its pixel stream."""
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path} is not a PNG")
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    i, idat = 8, b""
    while i < len(data):
        n = int.from_bytes(data[i : i + 4], "big")
        if data[i + 4 : i + 8] == b"IDAT":
            idat += data[i + 8 : i + 8 + n]
        i += 12 + n
    check(len(zlib.decompress(idat)) == h * (1 + 3 * w), f"{path}: pixel stream size")
    return w, h


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    scale = want.float().abs().max().item()
    return (got.float() - want.float()).abs().max().item() / max(scale, 1e-30)


def train_static(nerf_cfg, precision: str, phase: int):
    from upnerf_torch.ops import render_train as rt

    return rt.RTStatic(D=nerf_cfg.D, skips=nerf_cfg.skips, xyz_L=nerf_cfg.xyz_L, precision=precision,
                       use_cand=phase < 2, use_rgb=phase > 0, out_feat=phase < 2)


def mode_args(field, inputs, st):
    """Kernel arguments of one mode: the head subset and the mode's inputs."""
    from upnerf_torch.render.render_rays import field_weights

    o, d, z, pe_w, cond, c_emb = inputs
    trunk, heads = field_weights(field)
    heads = {k: heads[k] for k in st.head_keys}
    return (o, d, z, pe_w, cond if st.use_rgb else None, trunk, heads, st), (c_emb if st.use_cand else None)


def fwd_call(design: str, args, c_emb=None, save_res: bool = False, x0=None):
    """One launch of the forward kernel in one of render_train.FWD_DESIGNS on a
    mode's arguments (mode_args): the rays frontend, or with x0 the x0
    frontend. The designs other than "wgmma" are timing variants that no route
    reaches; this counts no launch."""
    from upnerf_torch.ops import render_train as rt

    o, d, z, pe_w, cond, trunk, heads, st = args
    if x0 is None:
        return rt._launch_fwd([o, d, z, pe_w, cond, c_emb, None], 3 + 6 * st.xyz_L, st.xyz_L, z, cond, trunk, heads,
                              st, c_emb, save_res, False, design)
    return rt._launch_fwd([None, None, z, None, cond, c_emb, x0], x0.shape[1], 0, z, cond, trunk, heads, st, c_emb,
                          save_res, True, design)


def fwd_l2_weight_bytes(args, design: str, R: int, S: int) -> float:
    """Bytes of weights a forward call reads from L2, from its tiles and its
    weight stream: the network's packed bf16 matrices once per tile of 64
    samples (the mma.sync design) or 128 (the wgmma design); the narrow
    heads, resident per block, left out."""
    from upnerf_torch.ops import render_train as rt

    o, d, z, pe_w, cond, trunk, heads, st = args
    FP = rt.feat_pad(heads["feat_b"].shape[0], True)
    _, sched = rt.wgmma_weights(trunk, rt.pad_feat(heads, FP), st, 3 + 6 * st.xyz_L)
    net = sum(b for _, b in sched[:-1])
    tile = 64 if design == "mma_sync" else 128
    return net * R * -(-S // tile)


def phase_fwd_designs(fields, dev, card: str):
    """Phase 5b: the forward kernel's two designs (render_train.FWD_DESIGNS:
    the route's wgmma kernel and the mma.sync design it replaced) per 4096 x
    256 chunk, bf16, in turns (a, b, b, a), in each mode the port runs: serving (phase 5's), phase-1 and
    phase-0 residuals (the train step's), recompute residuals, kernel 4 (the
    x0 mode, static render), and F = 32 phase-1 residuals: ms, TFLOP/s, share
    of the bound, L2 weight bytes; each variant's outputs against the
    route's (TOL) and two calls of the route's kernel bit for bit. Returns
    {mode: {design: ms}}."""
    from upnerf_torch.ops import render_train as rt

    (field, cfg), (field32, cfg32) = fields
    out = {}
    for label, fld, c, phase, save, rec, x0m in (
            ("serving", field, cfg, 2, False, False, False),
            ("residuals phase 1", field, cfg, 1, True, False, False),
            ("residuals phase 0", field, cfg, 0, True, False, False),
            ("recompute residuals phase 1", field, cfg, 1, True, True, False),
            ("kernel 4 (x0 mode, static render)", field, cfg, 2, False, False, True),
            ("F=32 residuals phase 1", field32, cfg32, 1, True, False, False)):
        st = train_static(c, "bfloat16", phase)._replace(save_chain=not rec)
        inputs = chunk_inputs(fld, 256, seed=51, dev=dev)
        args, c_emb = mode_args(fld, inputs, st)
        x0 = rt._pe(*inputs[:4], c.xyz_L)[0].contiguous() if x0m else None
        with torch.no_grad():
            got = {des: fwd_call(des, args, c_emb, save, x0)[0] for des in rt.FWD_DESIGNS}
            again = fwd_call("wgmma", args, c_emb, save, x0)[0]
            torch.cuda.synchronize()
            same = all(torch.equal(got["wgmma"][k], again[k]) for k in again)
            agree = max((got[des][k] - got["wgmma"][k]).abs().max().item() for des in rt.FWD_DESIGNS for k in again
                        if "depth" not in k)
            check(same, f"[5b] {label}: two calls of the forward kernel differ")
            check(agree <= TOL["bfloat16"], f"[5b] {label}: the designs disagree by {agree}")
            runs = {des: [] for des in rt.FWD_DESIGNS}
            for des in list(rt.FWD_DESIGNS) + list(reversed(rt.FWD_DESIGNS)):
                runs[des].append(cuda_ms(lambda: fwd_call(des, args, c_emb, save, x0), 3))
        ms = {des: sum(v) / len(v) for des, v in runs.items()}
        kind = "static" if x0m else ("fwd" if save else "serve")
        b_ms, b_by = render_bound(fld, st, CHUNK, 256, kind)
        flop = 2.0 * render_macs(c, st) * CHUNK * 256
        print(f"[5b] {label}, per {CHUNK}x256 chunk bf16, in turns: " + "; ".join(
            f"{des} {ms[des]:.3f} ms ({' '.join(f'{v:.3f}' for v in runs[des])}; {flop / ms[des] / 1e9:.0f} TFLOP/s,"
            f" {b_ms / ms[des]:.2f} of the bound, L2 weights {fwd_l2_weight_bytes(args, des, CHUNK, 256) / 1e9:.1f} GB)"
            for des in rt.FWD_DESIGNS) + f"; bound {b_ms:.3f} ms ({b_by}); designs agree to {agree:.2e}, two calls"
            f" bit for bit: {same} ({card})", flush=True)
        out[label] = ms
    return out


def phase_train_kernels(field, nerf_cfg, dev, samples=(128, 256)):
    """Phases 6 and 7: forward (with residuals) and backward kernels against
    their plain versions at the train batch, the field's feature width.
    Returns the worst errors."""
    from upnerf_torch.ops import render_train as rt

    fwd_err, bwd_err, bwd_abs = 0.0, 0.0, 0.0
    F = nerf_cfg.feat_dim
    for S in samples:
        inputs = chunk_inputs(field, S, seed=100 + S, dev=dev, R=TRAIN_RAYS)
        for prec in ("float32", "bfloat16"):
            for phase in (0, 1):
                st = train_static(nerf_cfg, prec, phase)
                args, c_emb = mode_args(field, inputs, st)
                with torch.no_grad():
                    got, got_res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
                    want, want_res = rt.render_train_rays_plain(*args, c_emb=c_emb, save_res=True)
                torch.cuda.synchronize()
                e = {}
                for k in st.out_keys:
                    check(bool(torch.isfinite(got[k]).all()), f"forward output {k} not finite (S={S} {prec} phase {phase})")
                    diff = (got[k] - want[k]).abs()
                    e[k] = (diff / want[k].abs().clamp(min=1e-6)).max().item() if "depth" in k else diff.max().item()
                for k in ("sig_s", "sig_c", "rgb"):
                    if k in want_res:
                        e[k] = rel_err(got_res[k], want_res[k])
                e_chain = rel_err(got_res["chain"], want_res["chain"])
                worst = max(e.values())
                print(f"[6] F={F} S={S} {prec} phase {phase}: max err {worst:.3e} (tol {TOL[prec]:.0e}) "
                      + " ".join(f"{k} {v:.2e}" for k, v in e.items())
                      + f"  chain {e_chain:.3e} (tol {CHAIN_TOL[prec]:.0e})", flush=True)
                check(worst <= TOL[prec], f"forward kernel disagrees with its plain version: {e}")
                check(e_chain <= CHAIN_TOL[prec], f"forward kernel's chain disagrees: {e_chain}")
                fwd_err = max(fwd_err, max(v for k, v in e.items() if "depth" not in k))

                # 7. backward on the kernel's residuals, random cotangents
                g = torch.Generator(device=dev).manual_seed(S + phase)
                cots = {k: torch.randn(want[k].shape, generator=g, device=dev) for k in st.out_keys}
                with torch.no_grad():
                    kb = rt.render_train_rays_bwd(*args[:7], st, c_emb, got_res, cots)
                    pb = rt.render_train_rays_bwd_plain(*args[:7], st, c_emb, got_res, cots)
                torch.cuda.synchronize()
                pairs = {name: (a_, b_) for name, a_, b_ in zip(["rays_o", "rays_d", "ray_cond", "c_emb"], kb[:4], pb[:4])
                         if b_ is not None}
                for i, ((aw, ab), (bw, bb)) in enumerate(zip(kb[4], pb[4])):
                    pairs[f"trunk{i}.w"], pairs[f"trunk{i}.b"] = (aw, bw), (ab, bb)
                for k in st.head_keys:
                    pairs[k] = (kb[5][k], pb[5][k].reshape(kb[5][k].shape))
                errs = {k: rel_err(a_, b_) for k, (a_, b_) in pairs.items()}
                bwd_abs = max([bwd_abs] + [(a_ - b_).abs().max().item() for a_, b_ in pairs.values()])
                for k, v in errs.items():
                    check(np.isfinite(v), f"backward {k} not finite")
                worst_k = max(errs, key=errs.get)
                print(f"[7] F={F} S={S} {prec} phase {phase}: {len(errs)} cotangents, worst {worst_k} {errs[worst_k]:.3e}"
                      f" (tol {BWD_TOL[prec]:.0e}); rays_o {errs['rays_o']:.2e} trunk0.w {errs['trunk0.w']:.2e}",
                      flush=True)
                check(errs[worst_k] <= BWD_TOL[prec], f"backward kernel disagrees with its plain version: {errs}")
                bwd_err = max(bwd_err, errs[worst_k])
                del got, got_res, want, want_res, kb, pb
                torch.cuda.empty_cache()
    return fwd_err, bwd_err, bwd_abs


def flagship_world(dev, seed: int = 0):
    """The JAX package's benchmark scene (__graft_entry__.py:_build) on the
    card: 16 images of 256x256, identity poses, 55x55x384 bf16 features, the
    full ray store; and the brandenburg_gate train step config."""
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.models.transient import TransientConfig
    from upnerf_torch.render.render_rays import RenderConfig
    from upnerf_torch.train import LossConfig, RayStore, SceneConstants, StepConfig

    n_images, H, W, fh, fw = 16, 256, 256, 55, 55
    g = torch.Generator(device=dev).manual_seed(seed)
    Ks = torch.zeros((n_images, 3, 3), device=dev)
    Ks[:, 0, 0] = Ks[:, 1, 1] = W * 1.2
    Ks[:, 0, 2], Ks[:, 1, 2], Ks[:, 2, 2] = W / 2, H / 2, 1.0
    scene = SceneConstants(
        Ks=Ks, poses=torch.eye(3, 4, device=dev).expand(n_images, 3, 4).contiguous(),
        near_far=torch.tensor([[0.1, 5.0]], device=dev).expand(n_images, 2).contiguous(),
        wh=torch.tensor([[W, H]], device=dev, dtype=torch.int32).expand(n_images, 2).contiguous(),
        feat_maps=torch.randn((n_images, fh, fw, 384), generator=g, device=dev).to(torch.bfloat16),
    )
    n = n_images * H * W
    pix = torch.arange(H * W, device=dev, dtype=torch.int32)
    store = RayStore(
        px=(pix % W).repeat(n_images), py=(pix // W).repeat(n_images),
        img_idx=torch.arange(n_images, device=dev).repeat_interleave(H * W),
        rgb=torch.randint(0, 256, (n, 3), generator=g, device=dev, dtype=torch.uint8),
        inv_depth=(torch.rand(n, generator=g, device=dev) * 5 + 0.2).to(torch.float16),
    )
    hp = BRANDENBURG_GATE
    cfg = StepConfig(
        nerf=NeRFConfig.from_hparams(hp), transient=TransientConfig.from_hparams(hp),
        render=RenderConfig.from_hparams(hp), loss=LossConfig(encode_feat=True, fine=True),
        candidate_schedule=(0.1, 0.5), max_steps=MAX_STEPS, pose_optimize=True, near=0.1, far=5.0,
        batch_size=TRAIN_RAYS,
    )
    return cfg, scene, store, n_images


def fresh_state(cfg, n_images, dev, seed: int = 0):
    from upnerf_torch.train import init_params, init_pose_params, make_optimizer, make_train_state

    model = init_params(cfg.nerf, cfg.transient, n_images, generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer("adam", 5e-4, 5e-5, cfg.max_steps)
    pose_opt = make_optimizer("adam", 2e-3, 1e-5, cfg.max_steps)
    return make_train_state(model, init_pose_params(n_images), opt, pose_opt, seed=seed + 1, device=dev), opt, pose_opt


def time_steps(step, state, scene, store, dev, label: str, n_steps: int = 3):
    """In each of STEP_PHASES: a warm-up step, then n_steps timed with CUDA
    events, with the peak memory over them; finite losses checked. Returns
    (state, {phase: ms a step}, {phase: peak bytes})."""
    times, peaks = {}, {}
    for phase in STEP_PHASES:
        state = state._replace(step=int(PHASE_PROGRESS[phase] * MAX_STEPS))
        state, m = step(state, scene, store, phase)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        losses = []
        for _ in range(n_steps):
            state, m = step(state, scene, store, phase)
            losses.append(m["loss"])
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / n_steps
        peaks[phase] = torch.cuda.max_memory_allocated(dev)
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"phase {phase}: loss not finite {losses}")
        times[phase] = ms
        terms = " ".join(f"{k[5:]} {float(v):.4g}" for k, v in m.items() if k.startswith("loss/"))
        print(f"[{label}] phase {phase}: losses {['%.5g' % x for x in losses]} ({terms}); psnr {float(m['psnr']):.3f}",
              flush=True)
    return state, times, peaks


def phase_train_step(dev, card: str, profile_dir=None):
    """Phases 8 and 9 for the train step. Returns (launch counts, step times,
    peak memory per phase)."""
    from upnerf_torch.ops import dw_gemm as dg
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.train import make_train_step
    from upnerf_torch.train import step as tstep
    from upnerf_torch.train.schedules import pe_progress, schedule_mult

    cfg, scene, store, n_images = flagship_world(dev)
    state, opt, pose_opt = fresh_state(cfg, n_images, dev)
    step, _ = make_train_step(cfg, opt, pose_opt)
    se3_0 = state.pose_params.se3_refine.weight.detach().clone()
    ds_0 = state.pose_params.depth_scale.weight.detach().clone()

    n_steps = 3
    rt.launches = rt.bwd_launches = dg.dw_launches = 0
    rt.walk_pre_launches = rt.walk_launches = rt.walk_finish_launches = 0
    state, times, peaks = time_steps(step, state, scene, store, dev, "8", n_steps)
    steps = len(STEP_PHASES) * (n_steps + 1)
    launches = {"render_train_fwd": rt.launches, "render_train_bwd": rt.bwd_launches, "dw_gemm": dg.dw_launches,
                "walk_pre": rt.walk_pre_launches, "walk": rt.walk_launches, "walk_finish": rt.walk_finish_launches}
    print(f"[8] {steps} steps: forward launches {launches['render_train_fwd']}, backward launches"
          f" {launches['render_train_bwd']} (expected {2 * steps} each); dW kernel launches {launches['dw_gemm']}"
          f" (one a slab of rays, at least {2 * steps})", flush=True)
    check(launches["render_train_fwd"] == 2 * steps and launches["render_train_bwd"] == 2 * steps,
          "the train step did not make 2 forward + 2 backward kernel launches a step")
    check(launches["dw_gemm"] >= 2 * steps, "the train step's backward did not launch the dW kernel")
    print(f"[8] the Hopper walk's launches: pre-pass {launches['walk_pre']}, walk {launches['walk']}, finishing pass"
          f" {launches['walk_finish']} (one each a slab of rays, at least {2 * steps})", flush=True)
    check(launches["walk_pre"] == launches["walk"] == launches["walk_finish"] >= 2 * steps,
          "the train step's backward did not run the Hopper walk's three kernels a slab")
    d_se3 = (state.pose_params.se3_refine.weight.detach() - se3_0).abs().max().item()
    d_ds = (state.pose_params.depth_scale.weight.detach() - ds_0).abs().max().item()
    print(f"[8] pose tables moved: max |d se3| {d_se3:.3e}, max |d depth_scale| {d_ds:.3e}", flush=True)
    check(d_se3 > 0 and d_ds > 0, "the pose tables did not move")

    # one phase-1 step of 256 rays: card (kernels) against CPU (plain versions)
    n = 256
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randint(0, store.n_rays, (n,), generator=g, device=dev)
    batch = tstep.gather_batch(store, idx)
    noise = {"coarse": torch.rand((n, cfg.render.N_samples), generator=g, device=dev),
             "fine": torch.rand((n, cfg.render.N_importance), generator=g, device=dev)}
    progress = pe_progress(int(PHASE_PROGRESS[1] * MAX_STEPS), MAX_STEPS)
    sched = schedule_mult(progress, cfg.candidate_schedule)
    cpu_model, cpu_pose = copy.deepcopy(state.params).cpu(), copy.deepcopy(state.pose_params).cpu()
    cpu_scene = type(scene)(*[None if t is None else t.cpu() for t in scene])
    grads = {}
    for where, model, pose, sc, b, nz in (
        ("card", state.params, state.pose_params, scene, batch, noise),
        ("cpu", cpu_model, cpu_pose, cpu_scene, {k: v.cpu() for k, v in batch.items()},
         {k: v.cpu() for k, v in noise.items()}),
    ):
        model.zero_grad(set_to_none=True)
        pose.zero_grad(set_to_none=True)
        t0 = time.perf_counter()
        loss, metrics = tstep._loss_and_metrics(model, pose, cfg, sc, b, nz, 1, sched, progress)
        loss.backward()
        named = list(model.named_parameters()) + list(pose.named_parameters())
        grads[where] = ({k: float(v.detach()) for k, v in metrics.items() if k.startswith("loss")},
                        {k: p.grad.detach().cpu() for k, p in named if p.grad is not None})
        print(f"    {where}: 256-ray phase-1 step in {time.perf_counter() - t0:.2f} s", flush=True)
    (lc, gc), (lp, gp) = grads["card"], grads["cpu"]
    loss_err = max(abs(lc[k] - lp[k]) / max(abs(lp[k]), 1e-30) for k in lp)
    check(set(gc) == set(gp), "card and CPU steps reach different parameters")
    grad_errs = {k: rel_err(gc[k], gp[k]) for k in gp}
    worst = max(grad_errs, key=grad_errs.get)
    print(f"[8] 256 rays, card vs CPU: max rel d loss term {loss_err:.3e} (tol {STEP_LOSS_TOL:.0e}); "
          f"{len(grad_errs)} gradients, worst {worst} {grad_errs[worst]:.3e} (tol {STEP_GRAD_TOL:.0e}); "
          f"se3 {grad_errs['se3_refine.weight']:.3e}", flush=True)
    check(loss_err <= STEP_LOSS_TOL, f"the card's step loss disagrees with the CPU's: {lc} vs {lp}")
    check(grad_errs[worst] <= STEP_GRAD_TOL, f"the card's gradients disagree with the CPU's: {grad_errs}")

    # 9. step times
    for phase in STEP_PHASES:
        print(f"[9] train step phase {phase}: {times[phase]:.2f} ms, {TRAIN_RAYS / times[phase] * 1e3:.0f} rays/s,"
              f" peak memory {peaks[phase] / 2**30:.2f} GiB ({card})", flush=True)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        state = state._replace(step=int(PHASE_PROGRESS[1] * MAX_STEPS))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            state, _ = step(state, scene, store, 1)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
        with open(os.path.join(profile_dir, "train_step_phase1.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        prof.export_chrome_trace(os.path.join(profile_dir, "train_step_phase1.json"))
        print(f"[9] profile of one phase-1 step -> {profile_dir}", flush=True)
    return launches, times, peaks


def dw_work(lay, R: int, S: int):
    """(FLOPs, bytes) of the dW kernel's products and sums over R rays x S
    samples: each job's kept outputs over its rows, and its operands (the
    saved chain, the operand buffer, the per-ray operands and bias rows) read
    once, the result written once."""
    from upnerf_torch.ops import render_train as rt

    flop = sum(2 * j.m_out * j.n_out * (R if j.x_src == rt.SRC_RAY else R * S) for j in lay.jobs)
    chain_w = max(j.x_col + j.x_cols for j in lay.jobs if j.x_src == rt.SRC_CHAIN)
    nbytes = 2 * R * S * (chain_w + lay.ops_w) + 2 * R * lay.ray_w + 4 * R * lay.nb + 4 * (lay.n_dw + lay.nb)
    return flop, nbytes


def dw_library(srcs, jobs):
    """The dW kernel's products by one PyTorch call a job: torch.mm of the same
    stored bf16 operands (cuBLAS, f32 accumulation, bf16 out), X^T G, without
    the bias sums. The yardstick of the library_ms column; the port never
    calls it."""
    def run():
        for j in jobs:
            x = srcs[j.x_src][:, j.x_col : j.x_col + j.x_cols][:, : j.m_out]
            g = srcs[j.g_src][:, j.g_col + j.g0 : j.g_col + j.g0 + j.n_out]
            torch.mm(x.t(), g)
    return run


def walk_bounds(field, st, lay, R: int, S: int) -> dict:
    """bound() of the Hopper walk's three kernels (csrc/render_train_bwd.cu)
    over R rays x S samples in bf16 mode st (lay: the train mode's dW
    layout, None in the frozen mode): the pre-pass reads the chain once and
    writes the coefficient rows and mask words; the walk does the data path's
    products (at the padded feature width, with the train mode's re-derived
    feat) and reads the masks and coefficients, writing the partial sums and,
    in the train mode, the operand buffer and bias rows; the finishing pass
    reads the partial sums."""
    from upnerf_torch.ops import render_train as rt

    cfg = field.cfg
    W, F, HH, HC, C = cfg.W, cfg.feat_dim, cfg.W // 2, cfg.W // 2, cfg.candidate_dim
    FP = rt.feat_pad(F, True)
    M = R * S
    chain_w = sum(w for _, w in st.chain_cols(W, HH, HC))
    tiles = R * -(-S // rt.WALK_TILE)
    per_sample_in = 4 * (2 + 3) + 4 * (2 if st.use_cand else 0)  # z, sig_s, rgb (3), and j / s weights' cotangents
    pre_bytes = 2 * M * chain_w + M * per_sample_in + 2 * (W * F + F * HC) + 4 * M * rt.WALK_COEF_W + M * chain_w / 8
    pre_flop = 2 * R * (W * F + F * HC * st.use_cand) + 2 * M * (W + HC * st.use_cand) * st.out_feat
    skips = [i for i in cfg.skips if 0 < i < cfg.D]
    macs = (cfg.D - 1) * W * W + (1 + len(skips)) * rt.X0_PAD * W + W * W + FP * W
    macs += (HH * FP + 3 * HH) * st.use_rgb + (FP * HC + HC * HC + HC * W) * st.use_cand
    walk_bytes = M * chain_w / 8 + 4 * M * rt.WALK_COEF_W + 4 * tiles * rt.WALK_PART_W
    if lay is not None:
        macs += W * FP * (st.use_rgb and st.save_chain)
        walk_bytes += 2 * M * lay.ops_w + 4 * tiles * lay.nb + 2 * M * W * (st.use_rgb and st.save_chain)
    finish_bytes = 4 * tiles * rt.WALK_PART_W + 4 * R * (HH * st.use_rgb + C * st.use_cand + 6)
    if lay is not None:
        finish_bytes += 2 * R * lay.ray_w + 4 * tiles * HC * st.use_cand
    return {"pre": bound(pre_flop, pre_bytes, "bfloat16"), "walk": bound(2.0 * macs * M, walk_bytes, "bfloat16"),
            "finish": bound(2.0 * R * C * HC * st.use_cand, finish_bytes, "bfloat16")}


def walk_kernels(call, args, st, c_emb, res, cots, slabs):
    """The Hopper walk's three kernels in a bf16 train backward call (phase
    9's, `call` a render_train.BwdLaunch) over all its slabs, each timed in
    turns with its plain twin over the same slabs (plain, kernel, kernel,
    plain): the pre-pass against walk_coef_plain and walk_mask_plain, the walk
    against _bwd_walk_plain with walk_part_plain and dw_operands_plain (its
    stores), the finishing pass against ray_sums_plain and the d_c_emb
    product; then each held against its twin on the first slab. Returns
    {kernel: (ms, plain ms, max |d|)} and checks the coefficient rows within
    WALK_COEF_TOL of each column's max, the mask words bit for bit, the
    partial sums, the bias rows and the finishing pass's outputs within
    BWD_TOL of their max."""
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.ops.linear import matmul

    o, d, z, pe_w, cond, trunk, heads = args[:7]
    S, L, tpr = z.shape[1], st.xyz_L, call.tpr
    HH, HC = 128, 128
    cut = lambda t, r0, r1, per=1: None if t is None else t[r0 * per : r1 * per]  # noqa: E731

    def slab(r0, r1):
        x0, xyz = rt._pe(o[r0:r1], d[r0:r1], z[r0:r1], pe_w, L)
        sres = {k: cut(v, r0, r1, S if k in ("rgb", "chain", "feat", "cfeat") else 1) for k, v in res.items()}
        return x0, xyz, z[r0:r1], cut(cond, r0, r1), cut(c_emb, r0, r1), sres, {k: v[r0:r1] for k, v in cots.items()}

    def pre_plain():
        for r0, r1 in slabs:
            x0, _, zs, cs, ce, sres, scots = slab(r0, r1)
            rt.walk_coef_plain(x0, zs, cs, trunk, heads, st, ce, sres, scots)
            rt.walk_mask_plain(sres["chain"])

    def walk_plain():
        for r0, r1 in slabs:
            x0, xyz, zs, cs, ce, sres, scots = slab(r0, r1)
            dx0, _, _, ops = rt._bwd_walk_plain(x0, zs, cs, trunk, heads, st, ce, sres, scots)
            rt.walk_part_plain(ops, dx0, xyz, zs, pe_w, st)
            rt.dw_operands_plain(ops, call.lay, st, r1 - r0, S, torch.bfloat16, rt.WALK_TILE)

    part = call.scratch[2]

    def finish_plain():
        for r0, r1 in slabs:
            sums = rt.ray_sums_plain(part[: (r1 - r0) * tpr], tpr)
            if st.use_cand:
                matmul(sums[:, HH : HH + HC], heads["c1c_w"].t(), "bfloat16")

    pieces = {"pre": (lambda: [call.pre(*sl) for sl in slabs], pre_plain),
              "walk": (lambda: [call.walk_tiles(*sl) for sl in slabs], walk_plain),
              "finish": (lambda: [call.finish(*sl) for sl in slabs], finish_plain)}
    out = {}
    for name, (kern, plain) in pieces.items():
        p1, k1, k2, p2 = cuda_ms(plain, 1), cuda_ms(kern, 2), cuda_ms(kern, 2), cuda_ms(plain, 1)
        out[name] = [(k1 + k2) / 2, (p1 + p2) / 2]

    # each kernel against its twin on the first slab
    r0, r1 = slabs[0]
    n = r1 - r0
    call.pre(r0, r1)
    call.walk_tiles(r0, r1)
    call.finish(r0, r1)
    torch.cuda.synchronize()
    x0, xyz, zs, cs, ce, sres, scots = slab(r0, r1)
    coef = rt.walk_coef_plain(x0, zs, cs, trunk, heads, st, ce, sres, scots)
    got = call.scratch[0][: n * S]
    coef_rel = max(((got[:, k] - coef[:, k]).abs().max() / coef[:, k].abs().max().clamp_min(1e-30)).item()
                   for k in range(7) if coef[:, k].abs().max() > 0)
    mask_diff = int((call.scratch[1][: n * S] != rt.walk_mask_plain(sres["chain"])).sum())
    dx0, d_cond, d_cemb, ops = rt._bwd_walk_plain(x0, zs, cs, trunk, heads, st, ce, sres, scots)
    want_part = rt.walk_part_plain(ops, dx0, xyz, zs, pe_w, st)
    got_part = part[: n * tpr]
    sections = [(0, HH * st.use_rgb), (HH, HH + HC * st.use_cand), (HH + HC, HH + HC + 6)]
    part_rel = max(rel_err(got_part[:, a:b], want_part[:, a:b]) for a, b in sections if b > a)
    want_rows = rt.dw_operands_plain(ops, call.lay, st, n, S, torch.bfloat16, rt.WALK_TILE)[2]
    rows_rel = rel_err(call.bufs[2][: n * tpr], want_rows)
    d_o, d_d = rt._pe_bwd(dx0, xyz, zs, pe_w, L)
    d_front, got_cond, got_cemb = call.result
    fin = [(d_front[0][r0:r1], d_o), (d_front[1][r0:r1], d_d)]
    fin += [(got_cond[r0:r1], d_cond)] if st.use_rgb else []
    fin += [(got_cemb[r0:r1], d_cemb)] if st.use_cand else []
    fin_rel = max(rel_err(a, b) for a, b in fin)
    out["pre"].append((got - coef).abs().max().item())
    out["walk"].append((got_part - want_part).abs().max().item())
    out["finish"].append(max((a - b).abs().max().item() for a, b in fin))
    print(f"[9] the Hopper walk's kernels against their plain twins on the first slab ({n} rays): pre-pass coefficient"
          f" rows {coef_rel:.3e} (tol {WALK_COEF_TOL:.0e}), mask words differing {mask_diff}; walk partial sums"
          f" {part_rel:.3e}, bias rows {rows_rel:.3e}; finishing pass {fin_rel:.3e} (tol {BWD_TOL['bfloat16']:.0e})",
          flush=True)
    check(coef_rel <= WALK_COEF_TOL and mask_diff == 0, "the walk's pre-pass disagrees with its plain twin")
    check(max(part_rel, rows_rel, fin_rel) <= BWD_TOL["bfloat16"], "the walk or its finishing pass disagrees")
    return {k: tuple(v) for k, v in out.items()}


def phase_bwd_timing(field, nerf_cfg, dev, card: str):
    """Phase 9's backward per 4096-ray chunk, S = 256, phase 1, bfloat16: the
    call (walk per slab + the dW kernel) against the plain backward, and the
    forward with residuals against its plain version, in turns (plain,
    kernel, kernel, plain); then the design's pieces in turns: the walk with
    its operand stores over all slabs, the dW kernel over all slabs (and its
    plain version), the walk in the frozen mode; the call's peak memory above
    what was allocated before it; the dW kernel against its
    plain version on the first slab's operands (DW_TOL of each gradient's
    max), two dW calls and two whole calls bit for bit. Returns ({"bwd",
    "fwd", "dw": (kernel ms, plain ms)}, dW max |d|, the layout)."""
    from upnerf_torch.ops import dw_gemm as dg
    from upnerf_torch.ops import render_train as rt

    st = train_static(nerf_cfg, "bfloat16", 1)
    frozen = st._replace(param_grads=False)
    inputs = chunk_inputs(field, 256, seed=9, dev=dev, R=CHUNK)
    args, c_emb = mode_args(field, inputs, st)
    F = nerf_cfg.feat_dim
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=dev).manual_seed(3)
        cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out.items()}
        kern = lambda: rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)  # noqa: E731
        plain = lambda: rt.render_train_rays_bwd_plain(*args[:7], st, c_emb, res, cots)  # noqa: E731
        fwd_k = lambda: rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)  # noqa: E731
        fwd_p = lambda: rt.render_train_rays_plain(*args, c_emb=c_emb, save_res=True)  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain, 2), cuda_ms(kern, 2), cuda_ms(kern, 2), cuda_ms(plain, 2)
        fp1, fk1, fk2, fp2 = cuda_ms(fwd_p, 2), cuda_ms(fwd_k, 2), cuda_ms(fwd_k, 2), cuda_ms(fwd_p, 2)

        # the call's peak memory, and two calls bit for bit
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        a = kern()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        b = kern()
        def outputs(r):
            return [t for t in r[:4] if t is not None] + [t for wb in r[4] for t in wb] + list(r[5].values())

        same = all(torch.equal(x, y) for x, y in zip(outputs(a), outputs(b)))
        check(same, "two calls of the bf16 train backward differ")
        del a, b

        # the pieces of the design
        call = rt.render_train_rays_bwd_launch(*args[:7], st, c_emb, res, cots)
        slabs = [(r0, min(CHUNK, r0 + call.slab)) for r0 in range(0, CHUNK, call.slab)]
        walk = lambda: [call.walk(r0, r1) for r0, r1 in slabs]  # noqa: E731
        dwk = lambda: [call.dw(r0, r1) for r0, r1 in slabs]  # noqa: E731
        zcall = rt.render_train_rays_bwd_launch(*args[:7], frozen, c_emb, res, cots)
        lay = call.lay
        ops, ray, rows = call.bufs
        chain = res["chain"]

        def dw_plain_chunk():  # the plain dW over the chunk's slabs, on the buffers as they stand
            for r0, r1 in slabs:
                n = r1 - r0
                dg.dw_gemm_plain([chain[r0 * 256 : r1 * 256], ops[: n * 256], None if ray is None else ray[:n]],
                                 lay.jobs, call.flat, lay.n_dw, rows[:n], r0 > 0)

        def dw_lib_chunk():  # one torch.mm a job over the chunk's slabs, on the same buffers
            for r0, r1 in slabs:
                n = r1 - r0
                dw_library([chain[r0 * 256 : r1 * 256], ops[: n * 256], None if ray is None else ray[:n]],
                           lay.jobs)()

        t = {}
        for name, fn in (("frozen", zcall.run), ("walk", walk), ("dw", dwk), ("dw_lib", dw_lib_chunk),
                         ("dw_plain", dw_plain_chunk)):
            t[name] = [cuda_ms(fn, 2)]
        for name, fn in (("dw_plain", dw_plain_chunk), ("dw_lib", dw_lib_chunk), ("dw", dwk), ("walk", walk),
                         ("frozen", zcall.run)):
            t[name].append(cuda_ms(fn, 2))
        t = {k: sum(v) / 2 for k, v in t.items()}

        # the two bf16 designs in turns: the whole call and its walk over the slabs, the frozen mode's call
        mcall = rt.render_train_rays_bwd_launch(*args[:7], st, c_emb, res, cots, design="mma_sync")
        mzcall = rt.render_train_rays_bwd_launch(*args[:7], frozen, c_emb, res, cots, design="mma_sync")
        des = {}
        for name, fn in (("call", call.run), ("call mma_sync", mcall.run), ("call mma_sync", mcall.run),
                         ("call", call.run), ("walk", walk), ("walk mma_sync", lambda: [mcall.walk(*sl) for sl in slabs]),
                         ("walk mma_sync", lambda: [mcall.walk(*sl) for sl in slabs]), ("walk", walk),
                         ("frozen", zcall.run), ("frozen mma_sync", mzcall.run), ("frozen mma_sync", mzcall.run),
                         ("frozen", zcall.run)):
            des.setdefault(name, []).append(cuda_ms(fn, 2))
        del mcall, mzcall
        wk = walk_kernels(call, args, st, c_emb, res, cots, slabs)

        # the dW kernel against its plain version on the first slab's operands, and twice bit for bit
        r1 = slabs[0][1]
        srcs = [chain[: r1 * 256], ops[: r1 * 256], None if ray is None else ray[:r1]]
        call.walk(0, r1)
        got = [dg.dw_gemm(srcs, lay.jobs, torch.empty_like(call.flat), lay.n_dw, rows[:r1], False) for _ in range(2)]
        want = dg.dw_gemm_plain(srcs, lay.jobs, torch.empty_like(call.flat), lay.n_dw, rows[:r1], False)
        torch.cuda.synchronize()
        check(torch.equal(got[0], got[1]), "two calls of the dW kernel differ")
        errs = {}
        for name, (off, (r, c)) in lay.outs.items():
            errs[name] = rel_err(got[0][off : off + r * c], want[off : off + r * c])
        errs["biases"] = rel_err(got[0][lay.n_dw :], want[lay.n_dw :])
        dw_abs = (got[0] - want).abs().max().item()
        worst = max(errs, key=errs.get)
        del got, want
    flop, nbytes = dw_work(lay, CHUNK, 256)
    dw_bound = bound(flop, nbytes, "bfloat16")
    bwd_bound = render_bound(field, st, CHUNK, 256, "bwd")
    chain_bytes_ = res["chain"].numel() * 2
    floor = (2 * chain_bytes_ + 2 * 2 * CHUNK * 256 * lay.ops_w) / PEAK_BYTES * 1e3
    ops_gib = call.bufs[0].numel() * 2 / 2**30
    print(f"[9] F={F}, per {CHUNK}-ray chunk, S=256, phase 1, bfloat16: backward {(k1 + k2) / 2:.2f} ms ({k1:.2f},"
          f" {k2:.2f}), plain {(p1 + p2) / 2:.2f} ms; forward with residuals kernel {(fk1 + fk2) / 2:.2f} ms, plain"
          f" {(fp1 + fp2) / 2:.2f} ms ({card})", flush=True)
    print(f"[9] F={F} the design, per chunk in turns: walk with its operand stores {t['walk']:.2f} ms over"
          f" {len(slabs)} slabs of {call.slab} rays, dW kernel {t['dw']:.2f} ms (plain {t['dw_plain']:.2f} ms,"
          f" one torch.mm a job {t['dw_lib']:.2f} ms over {len(lay.jobs)} jobs a slab), walk frozen"
          f" {t['frozen']:.2f} ms ({card})", flush=True)
    print(f"[9] F={F} backward call peak memory {peak / 2**30:.3f} GiB above its inputs (operand buffer"
          f" {ops_gib:.3f} GiB, {lay.ops_w} columns); bound {bwd_bound[0]:.3f} ms ({bwd_bound[1]}); this design's byte"
          f" floor (chain read twice, operand buffer written and read once) {floor:.3f} ms; dW kernel bound"
          f" {dw_bound[0]:.3f} ms ({dw_bound[1]}: {flop / 1e12:.3f} TFLOP, {nbytes / 1e9:.2f} GB), "
          f"{flop / t['dw'] / 1e9:.0f} TFLOP/s", flush=True)
    print(f"[9] F={F} dW kernel vs plain on the first slab ({r1} rays): worst {worst} {errs[worst]:.3e} (tol"
          f" {DW_TOL:.0e}), max |d| {dw_abs:.3e}; two dW calls and two backward calls bit for bit: {same}", flush=True)
    print(f"[9] F={F} the bf16 backward's designs per chunk in turns (Hopper walk / mma.sync walk): call"
          f" {des['call']} / {des['call mma_sync']} ms, walk over the slabs {des['walk']} / {des['walk mma_sync']} ms,"
          f" frozen call {des['frozen']} / {des['frozen mma_sync']} ms ({card})", flush=True)
    wb = walk_bounds(field, st, lay, CHUNK, 256)
    for name, (ms, pms, err) in wk.items():
        print(f"[9] F={F} Hopper walk, {name}: {ms:.3f} ms over {len(slabs)} slabs, plain twin {pms:.2f} ms, bound"
              f" {wb[name][0]:.3f} ms ({wb[name][1]}), max |d| {err:.3e} ({card})", flush=True)
    check(errs[worst] <= DW_TOL, f"the dW kernel disagrees with its plain version: {errs}")
    check(ops_gib <= 1.0, "the operand buffer exceeds 1 GiB")
    return ({"bwd": ((k1 + k2) / 2, (p1 + p2) / 2), "fwd": ((fk1 + fk2) / 2, (fp1 + fp2) / 2),
             "dw": (t["dw"], t["dw_plain"], t["dw_lib"]), "walk_kernels": wk, "walk_bounds": wb}, dw_abs, lay)


def flash_l2_bytes(G: int, N: int) -> float:
    """The bf16 kernel's L2 reads in one call, from its tiling
    (csrc/flash_attn_fwd.cu): each block of BLOCK_Q query rows reads its
    group's bf16 k and v once, plus its own q tile."""
    from upnerf_torch.ops import attention

    blocks = -(-N // attention.BLOCK_Q) * G
    kv_rows = -(-N // attention.BLOCK_K) * attention.BLOCK_K
    return blocks * (2 * kv_rows + attention.BLOCK_Q) * 64 * 2


def phase_flash_kernel(dev, card: str):
    """Phase 10: the flash-attention kernel against its plain version.
    Returns (worst max |d|, kernel ms, plain ms, SDPA ms) at N = 12,322
    bfloat16."""
    from upnerf_torch.ops import attention

    worst = 0.0
    for N, mult in ((DINO_TOKENS, 1.0), (DINO_TOKENS, 20.0), (300, 1.0)):
        g = torch.Generator(device=dev).manual_seed(N + int(mult))
        q, k, v = (torch.randn(DINO_HEADS, N, 64, generator=g, device=dev) for _ in range(3))
        q = q * mult
        for prec in ("bfloat16", "float32"):
            with torch.no_grad():
                got = attention.flash_attention(q, k, v, scale=0.125, compute_dtype=prec)
                want = attention.flash_attention_plain(q, k, v, scale=0.125, compute_dtype=prec,
                                                       block_k=attention.BLOCK_K)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"attention output not finite (N={N}, x{mult}, {prec})")
            err = (got - want).abs().max().item()
            tol = (ATTN_PEAKED_TOL if mult != 1.0 else ATTN_TOL)[prec]
            print(f"[10] attention G={DINO_HEADS} N={N} logits x{mult:g} {prec}: max err {err:.3e} (tol {tol:.0e})",
                  flush=True)
            check(err <= tol, f"flash kernel disagrees with its plain version: N={N} x{mult} {prec} {err}")
            worst = max(worst, err)
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(DINO_HEADS, DINO_TOKENS, 64, generator=g, device=dev) for _ in range(3))
    # the yardstick, never called by the port: one PyTorch call of the same function in bf16
    qb, kb, vb = (t.to(torch.bfloat16)[None] for t in (q, k, v))
    with torch.no_grad():
        kern = lambda: attention.flash_attention(q, k, v, scale=0.125)  # noqa: E731
        plain = lambda: attention.flash_attention_plain(q, k, v, scale=0.125)  # noqa: E731
        lib = lambda: torch.nn.functional.scaled_dot_product_attention(qb, kb, vb, scale=0.125)  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern, 10), cuda_ms(kern, 10), cuda_ms(plain)
        lms = cuda_ms(lib, 10)
    kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
    terms = flash_bound_terms(DINO_HEADS, DINO_TOKENS)
    bms, by = max(terms.values()), max(terms, key=terms.get)
    flop = 4.0 * DINO_HEADS * DINO_TOKENS**2 * 64
    print(f"[10] attention G={DINO_HEADS} N={DINO_TOKENS} bfloat16: kernel {kms:.4f} ms ({k1:.4f}, {k2:.4f}; "
          f"{flop / kms / 1e9:.0f} TFLOP/s, {bms / kms:.1%} of the {bms:.4f} ms bound), plain {pms:.3f} ms, "
          f"F.scaled_dot_product_attention (bf16 in, bf16 out) {lms:.4f} ms ({card})", flush=True)
    print("[10] bound terms: " + ", ".join(f"{name} {ms:.4f} ms" for name, ms in terms.items())
          + f" ({by} binds); L2 reads ~{flash_l2_bytes(DINO_HEADS, DINO_TOKENS) / 1e9:.2f} GB a call", flush=True)
    return worst, kms, pms, lms


def _flatten(tree, prefix: str = ""):
    """{"a": {"b": x}} -> {"a/b": x}: the npz layout's keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def phase_extractors(dev, card: str):
    """Phase 11: `upnerf_torch.cli.preprocess` at full width. Returns the
    flash kernel's launches in the CLI run."""
    from upnerf_torch.cli import preprocess
    from upnerf_torch.cli.render_video import write_png
    from upnerf_torch.features import dino, dpt, vit
    from upnerf_torch.features.images import read_rgb_u8
    from upnerf_torch.ops import attention
    from upnerf_torch.utils.weights import dpt_params_from_jax, vit_params_from_jax

    with tempfile.TemporaryDirectory() as tmp:
        # seeded weights at full width, written in the npz layout the CLI reads
        t0 = time.perf_counter()
        dino_tree = vit.init_vit_params(np.random.default_rng(10), vit.ViTConfig())
        dpt_tree = dpt.init_dpt_params(np.random.default_rng(11))
        np.savez(os.path.join(tmp, "dino_vits8.npz"), **_flatten(dino_tree))
        np.savez(os.path.join(tmp, "dpt_large.npz"), **_flatten(dpt_tree))
        n_dpt = sum(a.size for a in _flatten(dpt_tree).values())
        img_dir = os.path.join(tmp, "images")
        os.makedirs(img_dir)
        rng = np.random.RandomState(12)
        for name, (h, w) in EXTRACT_IMAGES:
            yy, xx = np.mgrid[0:h, 0:w]
            smooth = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 200
            write_png(os.path.join(img_dir, name), np.clip(smooth + rng.randint(0, 56, (h, w, 3)), 0, 255)
                      .astype(np.uint8))
        print(f"[11] seeded npz weights (DINO ViT-S/8, DPT-Large {n_dpt / 1e6:.0f} M parameters) and"
              f" {len(EXTRACT_IMAGES)} PNGs written in {time.perf_counter() - t0:.1f} s", flush=True)

        save = os.path.join(tmp, "out")
        argv = ["--image_dir", img_dir, "--save_dir", save, "--what", "dino", "dpt", "--device", "cuda",
                "--dino_weights", os.path.join(tmp, "dino_vits8.npz"), "--dpt_weights", os.path.join(tmp, "dpt_large.npz")]
        attention.launches = 0
        t0 = time.perf_counter()
        preprocess.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = attention.launches
        expected = 9 * len(EXTRACT_IMAGES)
        print(f"[11] preprocess --what dino dpt: {cli_s:.1f} s (weights loaded from npz included); flash kernel"
              f" launches {launches} (expected 9 blocks x {len(EXTRACT_IMAGES)} images = {expected})", flush=True)
        check(launches == expected, f"flash kernel launched {launches} times, expected {expected}")

        for name, (h, w) in EXTRACT_IMAGES:
            stem = name[:-4]
            want = {
                f"DINO/feature_maps/{stem}.npy": (DINO_GRID, DINO_GRID, DINO_DIM),
                f"DINO/pca_infos/{stem}_mean.npy": (DINO_DIM,),
                f"DINO/pca_infos/{stem}_components.npy": (3, DINO_DIM),
                f"DPT/{stem}.npy": (h, w),
            }
            for rel_path, shape in want.items():
                arr = np.load(os.path.join(save, rel_path))
                check(arr.shape == shape and arr.dtype == np.float32, f"{rel_path}: {arr.dtype} {arr.shape}, want {shape}")
                check(bool(np.isfinite(arr).all()), f"{rel_path} is not finite")
            depth = np.load(os.path.join(save, f"DPT/{stem}.npy"))
            print(f"    {stem}: features {want[f'DINO/feature_maps/{stem}.npy']}, pca ({DINO_DIM},) + (3, {DINO_DIM}), depth"
                  f" {depth.shape} in [{depth.min():.4g}, {depth.max():.4g}]", flush=True)

        # image 0 on the card (the CLI's file) against the CPU (plain version at the kernel's tile)
        img0 = read_rgb_u8(os.path.join(img_dir, EXTRACT_IMAGES[0][0]))
        on_card = np.load(os.path.join(save, f"DINO/feature_maps/{EXTRACT_IMAGES[0][0][:-4]}.npy"))
        t0 = time.perf_counter()
        cpu_ex = dino.DinoExtractor(vit_params_from_jax(dino_tree, "cpu"), cfg=vit.ViTConfig(attn_impl="flash"))
        on_cpu = cpu_ex(img0)
        d = float(np.abs(on_card - on_cpu).max() / np.abs(on_cpu).max())
        print(f"[11] image 0 DINO map, card vs CPU: max |d| / max |value| {d:.3e} (tol {DINO_E2E_TOL:.0e});"
              f" CPU extract {time.perf_counter() - t0:.1f} s", flush=True)
        check(d <= DINO_E2E_TOL, "the card's DINO map disagrees with the CPU's")

    # ms per image and peak memory, extractors built in memory from the same trees, one at a time
    extractors = {"dino": lambda: dino.DinoExtractor(vit_params_from_jax(dino_tree, dev)),
                "dpt": lambda: dpt.DPTDepth(dpt_params_from_jax(dpt_tree, dev))}
    for name, build in extractors.items():
        model = build()
        model(img0)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            model(img0)  # returns numpy: ends synchronised
        ms = (time.perf_counter() - t0) / reps * 1e3
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[11] {name}: {ms:.1f} ms per {EXTRACT_IMAGES[0][1][1]}x{EXTRACT_IMAGES[0][1][0]} image (host clock,"
              f" resize and copy back included), peak memory {peak:.2f} GiB ({card})", flush=True)
        del model
        torch.cuda.empty_cache()
    return launches


def bound(flop: float, nbytes: float, dtype: str):
    """(ms, "operations" | "bytes"): the least time the card could take for
    `flop` operations in `dtype` and `nbytes` of device-memory traffic, at
    the H100 SXM's published peaks."""
    t_ops = flop / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@functools.lru_cache(maxsize=None)
def sfu_rate() -> float:
    """Exponentials a second: 16 a clock per SM (ex2 on the special-function
    units) x the SMs x the card's maximum SM clock (nvidia-smi)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    mhz = float(out.stdout.strip().splitlines()[0])
    return 16.0 * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def flash_bound_terms(G: int, N: int) -> dict:
    """The three lower bounds (ms) of one bf16 flash-attention call: its
    4 G N^2 64 product FLOPs at the bf16 peak, its G N^2 exponentials at
    sfu_rate(), and q, k, v read and o written once in f32. The call's bound
    is the largest; "bytes" binds only if that term does."""
    return {
        "tensor cores": 4.0 * G * N**2 * 64 / PEAK_FLOPS["bfloat16"] * 1e3,
        "SFU": G * N**2 / sfu_rate() * 1e3,
        "bytes": 4 * 4 * G * N * 64 / PEAK_BYTES * 1e3,
    }


def trunk_macs(nerf_cfg) -> int:
    """Multiply-adds of the D-layer trunk for one sample."""
    in0, W = nerf_cfg.in_channels_xyz, nerf_cfg.W
    return sum((in0 if i == 0 else W + in0 if i in nerf_cfg.skips else W) * W for i in range(nerf_cfg.D))


def render_macs(nerf_cfg, st) -> int:
    """Multiply-adds of the fused render's products for one sample in mode st
    (the forward's; the backward's data path walks the same products
    transposed, and its dW products are as many again)."""
    W, F, HH, HC = nerf_cfg.W, nerf_cfg.feat_dim, nerf_cfg.W // 2, nerf_cfg.W // 2
    macs = trunk_macs(nerf_cfg) + W * W + W + W * F
    if st.use_rgb:
        macs += F * HH + HH * 3
    if st.use_cand:
        macs += W * HC + HC * HC + HC + HC * F
    return macs


def recompute_macs(nerf_cfg, st) -> int:
    """Multiply-adds of the recompute backward's chain rebuild for one sample
    in mode st: the trunk, xyzf, rgbh from the stored feat, h1 and h2 (the
    sigmas, rgb, feat and c_feat come from the residuals)."""
    W, F, HH, HC = nerf_cfg.W, nerf_cfg.feat_dim, nerf_cfg.W // 2, nerf_cfg.W // 2
    return trunk_macs(nerf_cfg) + W * W + F * HH * st.use_rgb + (W * HC + HC * HC) * st.use_cand


def feat_res_bytes(nerf_cfg, st, n_samples: int) -> int:
    """Bytes of the recompute mode's feat / c_feat residuals (f32, store_f32)."""
    return 4 * n_samples * nerf_cfg.feat_dim * (st.use_feat + (st.out_feat and st.use_cand))


def chain_bytes(nerf_cfg, st, n_samples: int, kind: str) -> int:
    """Bytes of the saved walk chain in bf16: all of it written by the forward
    ("fwd"); read by the backward ("bwd"), which in the frozen mode without a
    feat_map reads no xyzf (its readers there are the dW products and feat_map's
    cotangent, render_train_bwd.cu)."""
    W, HH, HC = nerf_cfg.W, nerf_cfg.W // 2, nerf_cfg.W // 2
    cols = st.chain_cols(W, HH, HC)
    if kind == "bwd" and not st.param_grads and not st.out_feat:
        cols = [c for c in cols if c[0] != "xyzf"]
    return 2 * n_samples * sum(w for _, w in cols)


def render_bound(field, st, R: int, S: int, kind: str, x0_in0: int = 0):
    """bound() of one fused-render call on R rays x S samples in bf16: kind
    "fwd" is the forward with residuals, "serve" the forward without them,
    "static" the x0 mode (kernel 4),
    "bwd" the backward in st's mode (the frozen mode does the walk's products
    only and writes no dW); with st.save_chain off the forward writes the feat /
    c_feat residuals in place of the chain, and "recompute" is the backward
    that reads them and rebuilds the chain (recompute_macs) besides the walk.
    x0_in0: the x0 frontend (kernel 1b) in the fwd / bwd / recompute kinds: the
    PE rows (R*S, x0_in0) read in place of the rays, and the backward writes
    d_x0 of the same size in place of d_rays_o / d_rays_d."""
    from upnerf_torch.render.render_rays import field_weights

    cfg = field.cfg
    M = R * S
    trunk, heads = field_weights(field)
    n_w = sum(t.numel() for wb in trunk for t in wb) + sum(heads[k].numel() for k in st.head_keys)
    per_ray = {"s_depth": 1, "rgb_map": 3, "feat_map": cfg.feat_dim, "c_depth": 1, "t_weight": 1}
    outs = sum(M if k in ("s_weights", "j_weights") else R * per_ray[k] for k in st.out_keys)
    res = M * (1 + st.use_cand + 3 * st.use_rgb)  # sig_s, sig_c, rgb in f32
    front = M * x0_in0 if x0_in0 else 6 * R  # x0, or o and d (and the backward's cotangents of them)
    per_ray_in = front + R * (cfg.W // 2 * st.use_rgb + cfg.candidate_dim * st.use_cand)  # + ray_cond, c_emb
    macs = render_macs(cfg, st) * M
    if kind == "serve":
        return bound(2 * macs, 4 * (per_ray_in + M + outs) + 2 * n_w, "bfloat16")
    if kind == "static":  # the serving mode reading x0 (R*S, 3 + 6L) instead of o and d
        return bound(2 * macs, 4 * (per_ray_in - 6 * R + M * (1 + cfg.in_channels_xyz) + outs) + 2 * n_w, "bfloat16")
    if st.save_chain:
        chain = chain_bytes(cfg, st, M, "bwd" if kind == "bwd" else "fwd")
    else:
        chain = feat_res_bytes(cfg, st, M)
    if kind == "fwd":
        return bound(2 * macs, 4 * (per_ray_in + M + outs + res) + 2 * n_w + chain, "bfloat16")
    grads = per_ray_in + (n_w if st.param_grads else 0)  # per-ray cotangents out, dW out
    flop = 2 * macs * (2 if st.param_grads else 1)
    if kind == "recompute":
        flop += 2 * recompute_macs(cfg, st) * M
    return bound(flop, 4 * (per_ray_in + M + outs + res + grads) + 2 * n_w + chain, "bfloat16")


def phase_frozen_bwd(field, nerf_cfg, dev, card: str):
    """Phase 12: the backward's frozen-model mode (param_grads=False) at 4096
    rays, S = 256, in phase 2 (test-time optimization's mode) and phase 1,
    bf16 and f32: its data cotangents equal the train mode's bit for bit and
    meet the plain frozen backward; then both modes timed in turns (train,
    frozen, frozen, train) in phase 2, bf16. Returns (worst max |d| against
    plain, frozen ms, train ms, plain frozen ms)."""
    from upnerf_torch.ops import render_train as rt

    worst = 0.0
    for phase, prec in ((2, "bfloat16"), (2, "float32"), (1, "bfloat16")):
        st = train_static(nerf_cfg, prec, phase)
        frozen = st._replace(param_grads=False)
        inputs = chunk_inputs(field, 256, seed=120 + phase, dev=dev, R=CHUNK)
        args, c_emb = mode_args(field, inputs, st)
        with torch.no_grad():
            out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
            g = torch.Generator(device=dev).manual_seed(12 + phase)
            cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out.items()}
            kt = rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)
            kf = rt.render_train_rays_bwd(*args[:7], frozen, c_emb, res, cots)
            pf = rt.render_train_rays_bwd_plain(*args[:7], frozen, c_emb, res, cots)
        torch.cuda.synchronize()
        check(kf[4] is None and kf[5] is None and pf[4] is None and pf[5] is None,
              "the frozen backward returned weight gradients")
        names = ["rays_o", "rays_d", "ray_cond", "c_emb"]
        errs, same = {}, {}
        for name, a_, t_, p_ in zip(names, kf[:4], kt[:4], pf[:4]):
            if p_ is None:
                continue
            check(bool(torch.isfinite(a_).all()), f"frozen backward {name} not finite")
            same[name] = torch.equal(a_, t_)
            errs[name] = rel_err(a_, p_)
            worst = max(worst, (a_ - p_).abs().max().item())
        print(f"[12] phase {phase} {prec}: frozen == train mode bit for bit: {same}; frozen vs plain frozen: "
              + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {BWD_TOL[prec]:.0e})", flush=True)
        check(all(same.values()), f"the frozen backward's data cotangents differ from the train mode's: {same}")
        check(max(errs.values()) <= BWD_TOL[prec], f"the frozen backward disagrees with its plain version: {errs}")
        del out, res, kt, kf, pf
    st = train_static(nerf_cfg, "bfloat16", 2)
    frozen = st._replace(param_grads=False)
    inputs = chunk_inputs(field, 256, seed=9, dev=dev, R=CHUNK)
    args, c_emb = mode_args(field, inputs, st)
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
        g = torch.Generator(device=dev).manual_seed(3)
        cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out.items()}
        train = lambda: rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)  # noqa: E731
        kern = lambda: rt.render_train_rays_bwd(*args[:7], frozen, c_emb, res, cots)  # noqa: E731
        plain = lambda: rt.render_train_rays_bwd_plain(*args[:7], frozen, c_emb, res, cots)  # noqa: E731
        t1, f1, f2, t2 = cuda_ms(train, 2), cuda_ms(kern, 2), cuda_ms(kern, 2), cuda_ms(train, 2)
        p1 = cuda_ms(plain, 2)
        # the frozen mode's two bf16 designs in turns (the Hopper walk, the mma.sync walk it replaced)
        mma = rt.render_train_rays_bwd_launch(*args[:7], frozen, c_emb, res, cots, design="mma_sync").run
        w1, m1, m2, w2 = cuda_ms(kern, 2), cuda_ms(mma, 2), cuda_ms(mma, 2), cuda_ms(kern, 2)
    fms, tms = (f1 + f2) / 2, (t1 + t2) / 2
    print(f"[12] per {CHUNK}-ray chunk, S=256, phase 2, bfloat16: frozen backward {fms:.2f} ms ({f1:.2f}, {f2:.2f}),"
          f" train mode {tms:.2f} ms ({t1:.2f}, {t2:.2f}), plain frozen {p1:.2f} ms ({card})", flush=True)
    print(f"[12] the frozen backward's designs in turns: Hopper walk {w1:.3f}, {w2:.3f} ms; mma.sync walk {m1:.3f},"
          f" {m2:.3f} ms ({card})", flush=True)
    return worst, fms, tms, p1


def phase_trunk_kernel(field, nerf_cfg, dev, card: str):
    """Phase 14: the trunk kernel against its plain version at the fast
    render's probe batch (4096 rays x 64 samples = 262,144 rows) and at a
    ragged N, bf16 and f32; then both timed in turns at 262,144 rows, bf16,
    and the forward's two bf16 designs in turns (fwd_designs). Returns (worst
    max |d|, kernel ms, plain ms)."""
    from upnerf_torch.models.nerf import positional_encoding
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp

    trunk = [(lay.weight.t(), lay.bias) for lay in field.trunk_layers()]
    worst, xs = 0.0, {}
    rms = lambda t: t.pow(2).mean().sqrt().item()  # noqa: E731
    for n in (PROBE_ROWS, 1037):
        g = torch.Generator(device=dev).manual_seed(n)
        xyz = torch.randn((n, 3), generator=g, device=dev)
        xs[n] = positional_encoding(xyz, nerf_cfg.xyz_L).contiguous()
        with torch.no_grad():
            plain = {p: mlp.fused_trunk_plain(xs[n], trunk, nerf_cfg.skips, p) for p in ("bfloat16", "float32")}
        for prec, other in (("bfloat16", "float32"), ("float32", "bfloat16")):
            with torch.no_grad():
                got = mlp.fused_trunk(xs[n], trunk, nerf_cfg.skips, prec)
            torch.cuda.synchronize()
            want = plain[prec]
            check(bool(torch.isfinite(got).all()), f"trunk kernel output not finite (N={n}, {prec})")
            err = rel_err(got, want)
            ratio = rms(got - want) / rms(got - plain[other])
            worst = max(worst, (got - want).abs().max().item())
            print(f"[14] trunk N={n} {prec}: max |d| / max |value| {err:.3e} (tol {TRUNK_TOL[prec]:.0e}),"
                  f" max |value| {want.abs().max().item():.3g}; against the {other} plain version"
                  f" {rel_err(got, plain[other]):.3e}; RMS distance to {prec} plain / to {other} plain"
                  f" {ratio:.3e} (limit {TRUNK_RMS_RATIO})", flush=True)
            check(err <= TRUNK_TOL[prec], f"trunk kernel disagrees with its plain version: N={n} {prec} {err}")
            check(ratio <= TRUNK_RMS_RATIO, f"the {prec} trunk kernel does not round as its plain version: {ratio}")
    x = xs[PROBE_ROWS]
    with torch.no_grad():
        kern = lambda: mlp.fused_trunk(x, trunk, nerf_cfg.skips, "bfloat16")  # noqa: E731
        plain = lambda: mlp.fused_trunk_plain(x, trunk, nerf_cfg.skips, "bfloat16")  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern, 10), cuda_ms(kern, 10), cuda_ms(plain)
    kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
    flop = 2.0 * trunk_macs(nerf_cfg) * PROBE_ROWS
    print(f"[14] trunk N={PROBE_ROWS} bfloat16: kernel {kms:.3f} ms ({k1:.3f}, {k2:.3f}; {flop / kms / 1e9:.0f}"
          f" TFLOP/s), plain {pms:.3f} ms ({card})", flush=True)
    fwd_designs("14", f"trunk N={PROBE_ROWS}", lambda des: hk.fused_trunk_heads_fwd_launch(
        x, None, trunk, None, nerf_cfg.skips, "bfloat16", des), flop, trunk_fwd_bound(field, nerf_cfg, PROBE_ROWS),
        card, 10)
    return worst, kms, pms


def trunk_fwd_bound(field, nerf_cfg, n: int):
    """bound() of one trunk-forward call on n rows in bf16: reads x0 (f32) and
    the weights, writes h (f32)."""
    return bound(2.0 * trunk_macs(nerf_cfg) * n, 4 * n * (nerf_cfg.in_channels_xyz + nerf_cfg.W)
                 + 2 * sum(lay.weight.numel() + lay.bias.numel() for lay in field.trunk_layers()), "bfloat16")


def fwd_designs(label: str, what: str, call, flop: float, bnd, card: str, reps: int) -> dict:
    """Kernels 5 and 6's bf16 forward in both designs (heads.HEADS_FWD_DESIGNS:
    the route's wgmma kernel and the mma.sync design it replaced, a timing
    variant), call(design) -> outputs: each design's outputs against the
    route's (TRUNK_TOL of each output's max), then both timed in turns (a, b,
    b, a): ms, TFLOP/s and share of the bound. Returns {design: ms}."""
    from upnerf_torch.ops import heads as hk

    with torch.no_grad():
        got = {des: call(des) for des in hk.HEADS_FWD_DESIGNS}
        torch.cuda.synchronize()
        agree = max(rel_err(a, b) for des in hk.HEADS_FWD_DESIGNS for a, b in zip(got[des], got["wgmma"]))
        del got
        check(agree <= TRUNK_TOL["bfloat16"], f"[{label}] {what}: the forward's designs disagree by {agree}")
        runs = {des: [] for des in hk.HEADS_FWD_DESIGNS}
        for des in list(hk.HEADS_FWD_DESIGNS) + list(reversed(hk.HEADS_FWD_DESIGNS)):
            runs[des].append(cuda_ms(lambda: call(des), reps))
    ms = {des: sum(v) / len(v) for des, v in runs.items()}
    b_ms, b_by = bnd
    print(f"[{label}] {what} bfloat16, the forward's designs in turns: " + "; ".join(
        f"{des} {ms[des]:.3f} ms ({' '.join(f'{v:.3f}' for v in runs[des])}; {flop / ms[des] / 1e9:.0f} TFLOP/s,"
        f" {b_ms / ms[des]:.2f} of the bound)" for des in hk.HEADS_FWD_DESIGNS)
        + f"; bound {b_ms:.3f} ms ({b_by}); the designs agree to {agree:.2e} of the max ({card})", flush=True)
    return ms


def heads_macs(nerf_cfg, cand: bool) -> int:
    """Multiply-adds of kernel 5's forward for one row (trunk, sigma, xyzf, feat;
    c1, c2, c_sigma, c_feat with the candidate branch)."""
    W, F, HC, C = nerf_cfg.W, nerf_cfg.feat_dim, nerf_cfg.W // 2, nerf_cfg.candidate_dim
    macs = trunk_macs(nerf_cfg) + W + W * W + W * F
    if cand:
        macs += (W + C) * HC + HC * HC + HC + HC * F
    return macs


def heads_bound(field, nerf_cfg, n: int, cand: bool, kind: str):
    """bound() of one kernel-5 call on n rows in bf16: kind "fwd" reads x0 (and
    c_emb) and writes the f32 head outputs; "bwd" reads them and the cotangents,
    writes dx0 (and dc_emb) and every weight gradient, and does the recompute,
    the walk's data path and the dW products (3 x the forward's multiply-adds)."""
    trunk, heads = field.trunk_heads_weights(cand)
    n_w = sum(t.numel() for wb in trunk for t in wb) + sum(t.numel() for t in heads.values())
    C = nerf_cfg.candidate_dim if cand else 0
    rows_in = nerf_cfg.in_channels_xyz + C
    rows_out = (1 + nerf_cfg.feat_dim) * (2 if cand else 1)
    macs = heads_macs(nerf_cfg, cand) * n
    if kind == "fwd":
        return bound(2 * macs, 4 * n * (rows_in + rows_out) + 2 * n_w, "bfloat16")
    return bound(6 * macs, 4 * n * (2 * rows_in + rows_out) + 2 * n_w + 4 * n_w, "bfloat16")


def phase_heads_kernel(field, nerf_cfg, dev, card: str, cases=None, pieces: bool = True):
    """Phase 16: kernel 5 (trunk + heads, csrc/heads_fwd.cu and heads_bwd.cu)
    against its plain versions, forward and every backward output: N = 524,288
    rows (2048 rays x 256 fine samples, a train step's fine pass) in bf16, with
    the candidate branch (phase 1) and without (phase 2); f32 at 65,536 rows and
    a ragged N; the backward also against the plain backward in float64. Then
    forward and backward timed in turns at 524,288 rows, bf16, with the
    candidate branch, the forward's two bf16 designs in turns (fwd_designs),
    and (pieces) the bf16 forward at ragged N (heads_fwd_sweep) and the
    backward's route in turns: the Hopper
    walk with its operand stores over the slabs, the dW kernel over them; and
    the call's peak memory above its inputs (one slab's operand buffer within
    render_train.DW_BUFFER_BYTES). cases: (rows, precision, candidate) to check, by
    default the above. Returns (worst fwd max |d|, worst bwd max |d|, times
    {fwd, bwd}: (kernel ms, plain ms), with pieces also walk and dw ms)."""
    from upnerf_torch.models.nerf import positional_encoding
    from upnerf_torch.ops import heads as hk

    worst_f = worst_b = 0.0
    F = nerf_cfg.feat_dim
    cases = cases or [(TRAIN_RAYS * 256, "bfloat16", True), (TRAIN_RAYS * 256, "bfloat16", False),
                      (65536, "float32", True), (1037, "float32", True), (1037, "float32", False)]
    for n, prec, cand in cases:
        g = torch.Generator(device=dev).manual_seed(n + cand)
        x0 = positional_encoding(torch.randn((n, 3), generator=g, device=dev), nerf_cfg.xyz_L).contiguous()
        c_emb = torch.randn((n, nerf_cfg.candidate_dim), generator=g, device=dev) if cand else None
        trunk, heads = field.trunk_heads_weights(cand)
        other = "float32" if prec == "bfloat16" else "bfloat16"
        with torch.no_grad():
            got = hk.fused_trunk_heads_fwd(x0, c_emb, trunk, heads, nerf_cfg.skips, prec)
            want = hk.fused_trunk_heads_plain(x0, c_emb, trunk, heads, nerf_cfg.skips, prec)
            cots = [torch.randn(t.shape, generator=g, device=dev) for t in want]
            kb = hk.fused_trunk_heads_bwd(x0, c_emb, trunk, heads, nerf_cfg.skips, prec, cots)
            pb = hk.fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, nerf_cfg.skips, prec, cots)
            po = hk.fused_trunk_heads_bwd_plain(x0, c_emb, trunk, heads, nerf_cfg.skips, other, cots)[:2]
            f64 = lambda t: None if t is None else t.double()  # noqa: E731
            p64 = hk.fused_trunk_heads_bwd_plain(
                f64(x0), f64(c_emb), [(f64(w), f64(b)) for w, b in trunk], {k: f64(v) for k, v in heads.items()},
                nerf_cfg.skips, "float32", [f64(c) for c in cots])
        torch.cuda.synchronize()
        rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
        flat = lambda b: torch.cat([t.double().flatten() for wb in b[2] for t in wb]  # noqa: E731
                                   + [b[3][k].double().flatten() for k in sorted(b[3])])
        names = ["s_sigma", "s_feat", "c_sigma", "c_feat"]
        ferr = {}
        for name, a_, p_ in zip(names, got, want):
            check(bool(torch.isfinite(a_).all()), f"kernel 5 forward {name} not finite (N={n} {prec})")
            ferr[name] = rel_err(a_, p_)
            worst_f = max(worst_f, (a_ - p_).abs().max().item())
        rows = [("dx0", 0)] + ([("dc_emb", 1)] if cand else [])
        row_rms = {name: rms(kb[i] - pb[i]) / rms(pb[i]) for name, i in rows}
        row_ratio = {name: rms(kb[i] - pb[i]) / rms(kb[i] - po[i]) for name, i in rows}
        berr = {}
        for i, ((kw_, kb_), (pw_, pb_)) in enumerate(zip(kb[2], pb[2])):
            berr[f"trunk{i}.w"], berr[f"trunk{i}.b"] = rel_err(kw_, pw_), rel_err(kb_, pb_)
        for k in pb[3]:
            berr[k] = rel_err(kb[3][k], pb[3][k])
        for a_, p_ in [(kb[0], pb[0])] + ([(kb[1], pb[1])] if cand else []):
            check(bool(torch.isfinite(a_).all()), f"kernel 5 backward not finite (N={n} {prec})")
            worst_b = max(worst_b, (a_ - p_).abs().max().item())
        # the float64 witness: kernel's RMS distance over the plain version's, both to float64
        w64 = {name: rms(kb[i] - p64[i]) / rms(pb[i] - p64[i]) for name, i in rows}
        w64["dW"] = rms(flat(kb) - flat(p64)) / rms(flat(pb) - flat(p64))
        fw, bw = max(ferr, key=ferr.get), max(berr, key=berr.get)
        print(f"[16] heads F={F} N={n} {prec} candidate={cand}: forward worst {fw} {ferr[fw]:.3e} (tol"
              f" {TRUNK_TOL[prec]:.0e}); backward {len(berr)} weight gradients, worst {bw} {berr[bw]:.3e} (tol"
              f" {HEADS_BWD_TOL:.0e}); per-row RMS " + " ".join(f"{k} {v:.3e}" for k, v in row_rms.items())
              + f" (tol {HEADS_ROW_RMS_TOL:.0e}), RMS distance to {prec} plain / to {other} plain "
              + " ".join(f"{k} {v:.3e}" for k, v in row_ratio.items()) + f" (limit {TRUNK_RMS_RATIO})"
              + f"; max |d| / max |g| " + " ".join(f"{k} {rel_err(kb[i], pb[i]):.3e}" for k, i in rows)
              + "; RMS distance to float64 plain, kernel / plain " + " ".join(f"{k} {v:.3f}" for k, v in w64.items())
              + f" (limit {HEADS_F64_RATIO})", flush=True)
        check(max(ferr.values()) <= TRUNK_TOL[prec], f"kernel 5 forward disagrees with its plain version: {ferr}")
        check(max(berr.values()) <= HEADS_BWD_TOL, f"kernel 5 backward disagrees with its plain version: {berr}")
        check(max(row_rms.values()) <= HEADS_ROW_RMS_TOL, f"kernel 5 backward's per-row outputs: {row_rms}")
        check(max(row_ratio.values()) <= TRUNK_RMS_RATIO, f"kernel 5 backward does not round as its plain: {row_ratio}")
        check(max(w64.values()) <= HEADS_F64_RATIO, f"kernel 5 backward is further from float64 than its plain: {w64}")
        del got, want, cots, kb, pb, po, p64
    n = TRAIN_RAYS * 256
    g = torch.Generator(device=dev).manual_seed(16)
    x0 = positional_encoding(torch.randn((n, 3), generator=g, device=dev), nerf_cfg.xyz_L).contiguous()
    c_emb = torch.randn((n, nerf_cfg.candidate_dim), generator=g, device=dev)
    trunk, heads = field.trunk_heads_weights(True)
    cots = [torch.randn((n, 1), generator=g, device=dev), torch.randn((n, nerf_cfg.feat_dim), generator=g, device=dev),
            torch.randn((n, 1), generator=g, device=dev), torch.randn((n, nerf_cfg.feat_dim), generator=g, device=dev)]
    args = (x0, c_emb, trunk, heads, nerf_cfg.skips, "bfloat16")
    times = {}
    with torch.no_grad():
        for kind, kern, plain in (
            ("fwd", lambda: hk.fused_trunk_heads_fwd(*args), lambda: hk.fused_trunk_heads_plain(*args)),
            ("bwd", lambda: hk.fused_trunk_heads_bwd(*args, cots), lambda: hk.fused_trunk_heads_bwd_plain(*args, cots)),
        ):
            p1, k1, k2, p2 = cuda_ms(plain, 2), cuda_ms(kern, 3), cuda_ms(kern, 3), cuda_ms(plain, 2)
            times[kind] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"[16] heads F={F} {kind} N={n} bfloat16 candidate: kernel {times[kind][0]:.2f} ms ({k1:.2f}, {k2:.2f}),"
                  f" plain {times[kind][1]:.2f} ms ({p1:.2f}, {p2:.2f}) ({card})", flush=True)
        fwd_designs("16", f"heads F={F} fwd N={n} candidate", lambda des: hk.fused_trunk_heads_fwd_launch(*args, des),
                    2.0 * heads_macs(nerf_cfg, True) * n, heads_bound(field, nerf_cfg, n, True, "fwd"), card, 3)
        if not pieces:
            return worst_f, worst_b, times
        worst_f = max(worst_f, heads_fwd_sweep(field, nerf_cfg, dev))
        times.update(bwd_pieces(hk.fused_trunk_heads_bwd_launch(*args, cots), lambda: hk.fused_trunk_heads_bwd(
            *args, cots), "16", f"heads bwd N={n} bfloat16 candidate", dev, card))
    return worst_f, worst_b, times


def heads_fwd_sweep(field, nerf_cfg, dev) -> float:
    """Phase 16: the bf16 forward of kernels 5 and 6 (wg_fwd_kernel) against
    its plain version at N around a tile (64) and a tile pair (128), F = 32,
    64 and 384 (the field's feature columns cut to F), with the candidate
    branch, without it and trunk-only: TRUNK_TOL of each output's max (the
    outputs hold N rows). Returns the worst max |d|."""
    from upnerf_torch.models.nerf import positional_encoding
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp

    worst, worst_rel = 0.0, 0.0
    trunk = field.trunk_weights()
    for n in (1, 63, 64, 65, 127, 128, 129, 1037):
        g = torch.Generator(device=dev).manual_seed(1600 + n)
        x0 = positional_encoding(torch.randn((n, 3), generator=g, device=dev), nerf_cfg.xyz_L).contiguous()
        c_emb = torch.randn((n, nerf_cfg.candidate_dim), generator=g, device=dev)
        cases = [("trunk", None, None)]
        for F in (32, 64, 384):
            for cand in (True, False):
                heads = {k: (v[..., :F] if k in ("feat_w", "feat_b", "cfeat_w", "cfeat_b") else v)
                         for k, v in field.trunk_heads_weights(cand)[1].items()}
                cases.append((f"F={F} candidate={cand}", heads, c_emb if cand else None))
        with torch.no_grad():
            for label, heads, ce in cases:
                if heads is None:
                    got = (mlp.fused_trunk_fwd(x0, trunk, nerf_cfg.skips, "bfloat16"),)
                    want = (mlp.fused_trunk_plain(x0, trunk, nerf_cfg.skips, "bfloat16"),)
                else:
                    got = hk.fused_trunk_heads_fwd(x0, ce, trunk, heads, nerf_cfg.skips, "bfloat16")
                    want = hk.fused_trunk_heads_plain(x0, ce, trunk, heads, nerf_cfg.skips, "bfloat16")
                torch.cuda.synchronize()
                for a_, p_ in zip(got, want):
                    check(a_.shape == p_.shape and bool(torch.isfinite(a_).all()), f"[16] forward N={n} {label}")
                    err = rel_err(a_, p_)
                    check(err <= TRUNK_TOL["bfloat16"], f"[16] forward N={n} {label} disagrees: {err}")
                    worst, worst_rel = max(worst, (a_ - p_).abs().max().item()), max(worst_rel, err)
    print(f"[16] the bf16 forward at N = 1, 63, 64, 65, 127, 128, 129, 1037, F = 32 / 64 / 384, candidate on and off,"
          f" trunk-only: worst max |d| / max |value| {worst_rel:.3e} (tol {TRUNK_TOL['bfloat16']:.0e})", flush=True)
    return worst


def bwd_pieces(call, whole, label: str, what: str, dev, card: str) -> dict:
    """Kernels 5 and 6's backward route (a heads.BwdCall) in pieces, in turns:
    the walk over its slabs (the Hopper kernel with its operand stores), the
    dW kernel over them; and one whole call's peak memory above its inputs.
    Returns {walk, dw: ms}."""
    from upnerf_torch.ops import render_train as rt

    slabs = [(r0, min(call.N, r0 + call.slab)) for r0 in range(0, call.N, call.slab)]
    walk = lambda: [call.walk(r0, r1) for r0, r1 in slabs]  # noqa: E731
    dwk = lambda: [call.dw(r0, r1) for r0, r1 in slabs]  # noqa: E731
    lib = lambda: [dw_library([call.ops[: r1 - r0]], call.lay.jobs)() for r0, r1 in slabs]  # noqa: E731
    w1, d1, l1, l2, d2, w2 = (cuda_ms(f, 3) for f in (walk, dwk, lib, lib, dwk, walk))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = whole()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - base
    outs = sum(t.numel() * t.element_size() for t in flat_tensors(out))
    ops = call.ops.numel() * call.ops.element_size() + call.bias_rows.numel() * 4
    print(f"[{label}] {what}, the route in turns: walk {(w1 + w2) / 2:.2f} ms ({w1:.2f}, {w2:.2f}) over {len(slabs)}"
          f" slabs of {call.slab} rows, dW kernel {(d1 + d2) / 2:.2f} ms ({d1:.2f}, {d2:.2f}), one torch.mm a job"
          f" {(l1 + l2) / 2:.2f} ms ({l1:.2f}, {l2:.2f}) over {len(call.lay.jobs)} jobs a slab; call peak memory"
          f" {peak / 2**30:.3f} GiB above its inputs (slab buffers {ops / 2**30:.3f} GiB, {call.lay.ops_w} columns;"
          f" outputs {outs / 2**30:.3f} GiB) ({card})", flush=True)
    check(ops <= rt.DW_BUFFER_BYTES, "a slab's operand buffer and bias rows exceed their budget")
    return {"walk": (w1 + w2) / 2, "dw": (d1 + d2) / 2, "dw_lib": (l1 + l2) / 2}


def phase_static_render(field, nerf_cfg, dev, card: str):
    """Phase 17: kernel 4, the x0 mode of the render forward (ops/render.py),
    against its plain version and against the render forward's serving mode
    on the same rays (kernel 1 builds the PE from the rays, kernel 4 reads
    it), 4096 rays x 256 samples, bf16 and f32; then timed in turns against
    the plain version in bf16. Returns (worst max |d|, kernel ms, plain ms)."""
    from upnerf_torch.ops import render as srk
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.render.render_rays import field_weights

    trunk, heads = field_weights(field)
    head = {k: heads[k] for k in srk.HEAD_KEYS}
    o, d, z, pe_w, cond, _ = chunk_inputs(field, 256, seed=17, dev=dev)
    x0, _ = rt._pe(o, d, z, pe_w, nerf_cfg.xyz_L)
    x0 = x0.contiguous()
    worst = 0.0
    for prec in ("bfloat16", "float32"):
        st = rt.RTStatic(D=nerf_cfg.D, skips=nerf_cfg.skips, xyz_L=nerf_cfg.xyz_L, precision=prec)
        with torch.no_grad():
            rgb, dep, w = srk.fused_static_render_fwd(x0, z, cond, trunk, head, nerf_cfg.skips, prec)
            prgb, pdep, pw = srk.fused_static_render_plain(x0, z, cond, trunk, head, nerf_cfg.skips, prec)
            serve = rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, {k: heads[k] for k in st.head_keys}, st)
        torch.cuda.synchronize()
        for t in (rgb, dep, w):
            check(bool(torch.isfinite(t).all()), f"kernel 4 output not finite ({prec})")
        e_plain = {"rgb_map": (rgb - prgb).abs().max().item(), "weights": (w - pw).abs().max().item(),
                   "depth_rel": ((dep - pdep).abs() / pdep.abs()).max().item()}
        e_serve = {"rgb_map": (rgb - serve["rgb_map"]).abs().max().item(),
                   "weights": (w - serve["s_weights"]).abs().max().item(),
                   "depth_rel": ((dep[:, 0] - serve["s_depth"]).abs() / serve["s_depth"].abs()).max().item()}
        worst = max(worst, e_plain["rgb_map"], e_plain["weights"])
        print(f"[17] static render F={nerf_cfg.feat_dim} {CHUNK}x256 {prec}: vs plain " + " ".join(f"{k} {v:.3e}" for k, v in e_plain.items())
              + "; vs the serving mode " + " ".join(f"{k} {v:.3e}" for k, v in e_serve.items())
              + f" (tol {TOL[prec]:.0e})", flush=True)
        check(max(e_plain.values()) <= TOL[prec], f"kernel 4 disagrees with its plain version: {e_plain}")
        check(max(e_serve.values()) <= TOL[prec], f"kernel 4 disagrees with the serving mode: {e_serve}")
    with torch.no_grad():
        kern = lambda: srk.fused_static_render_fwd(x0, z, cond, trunk, head, nerf_cfg.skips, "bfloat16")  # noqa: E731
        plain = lambda: srk.fused_static_render_plain(x0, z, cond, trunk, head, nerf_cfg.skips, "bfloat16")  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
    kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"[17] static render F={nerf_cfg.feat_dim} per {CHUNK}-ray chunk, S=256, bfloat16: kernel {kms:.2f} ms ({k1:.2f}, {k2:.2f}),"
          f" plain {pms:.2f} ms ({card})", flush=True)
    return worst, kms, pms


def ring_poses(n: int, radius: float = 3.0, height: float = 0.6, arc: float = 0.3) -> np.ndarray:
    """(n, 3, 4) c2w poses (right-up-back) on an arc around the origin, looking at
    it, at heights alternating by +-0.3: camera centres in one plane would make
    the centre-only Procrustes of the pose metric reflection-bistable."""
    poses = []
    for i in range(n):
        ang = 2 * np.pi * arc * (i / n - 0.5)
        eye = np.array([radius * np.sin(ang), height + 0.3 * (-1) ** i, radius * np.cos(ang)])
        forward = -eye / np.linalg.norm(eye)
        right = np.cross(forward, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, forward)
        poses.append(np.concatenate([np.stack([right, up, -forward], 1), eye[:, None]], 1))
    return np.stack(poses)


def write_phototourism_scene(root: str, name: str, poses: np.ndarray, split, wh, focal: float, seed: int = 0):
    """tsv + COLMAP binaries (PINHOLE, one camera per image, 256 points on the
    unit sphere) of a Phototourism-layout scene, with the port's writers; the
    images go to root/dense/images/NNN.png afterwards."""
    from upnerf_torch.data import colmap

    sparse = os.path.join(root, "dense", "sparse")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(os.path.join(root, "dense", "images"), exist_ok=True)
    cameras, images = {}, {}
    w, h = wh
    with open(os.path.join(root, f"{name}.tsv"), "w") as f:
        f.write("filename\tid\tsplit\tdataset\n")
        for i, c2w in enumerate(poses):
            img_id, fname = i + 1, f"{i:03d}.png"
            f.write(f"{fname}\t{img_id}\t{split[i]}\t{name}\n")
            cameras[img_id] = colmap.Camera(id=img_id, model="PINHOLE", width=w, height=h,
                                            params=np.array([focal, focal, w / 2, h / 2], np.float64))
            c2w = np.array(c2w, np.float64)
            c2w[:, 1:3] *= -1  # right-up-back -> COLMAP's right-down-front
            w2c = np.linalg.inv(np.concatenate([c2w, [[0, 0, 0, 1.0]]]))
            images[img_id] = colmap.Image(id=img_id, qvec=colmap.rotmat2qvec(w2c[:3, :3]), tvec=w2c[:3, 3],
                                          camera_id=img_id, name=fname, xys=np.zeros((0, 2)),
                                          point3D_ids=np.zeros(0, np.int64))
    pts = np.random.RandomState(seed).randn(256, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    points = {j + 1: colmap.Point3D(id=j + 1, xyz=p, rgb=np.array([128, 128, 128]), error=np.array(0.5),
                                    image_ids=np.array([1], np.int32), point2D_idxs=np.array([0], np.int32))
              for j, p in enumerate(pts)}
    colmap.write_cameras_binary(cameras, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    colmap.write_points3d_binary(points, os.path.join(sparse, "points3D.bin"))


def phase_tto_eval(dev, card: str, profile_dir=None):
    """Phase 13: TTO -> eval through `upnerf_torch.cli.tto.main` and
    `upnerf_torch.cli.eval.main` on a Phototourism-layout scene written by the
    port, at the brandenburg_gate width; with profile_dir, a torch.profiler
    table of one TTO step. Returns (frozen backward launches, TTO step ms,
    eval chunk ms)."""
    from upnerf_torch.cli import eval as eval_cli
    from upnerf_torch.cli import tto as tto_cli
    from upnerf_torch.cli.render_video import write_png
    from upnerf_torch.data import load_scene_meta
    from upnerf_torch.evaluate import metrics
    from upnerf_torch.evaluate.render import make_pose_renderer, render_image
    from upnerf_torch.geometry import procrustes, se3
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.render.render_rays import RenderConfig
    from upnerf_torch.utils.weights import init_reference_ckpt, load_reference_ckpt, render_params

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root, name = os.path.join(tmp, "scene"), "scene"
        n = TTO_TRAIN + TTO_TEST
        split = ["test" if i % 3 == 1 else "train" for i in range(n)]  # test views between train views
        write_phototourism_scene(root, name, ring_poses(n), split, TTO_PNG_WH, TTO_FOCAL)
        hp = dict(BRANDENBURG_GATE, dataset_name="phototourism", root_dir=root, scene_name=name,
                  **{"phototourism.img_downscale": 2, "pose.noise": -1, "seed": 0})
        meta = load_scene_meta(hp)
        check(meta.N_images_train == TTO_TRAIN and meta.N_images_test == TTO_TEST, "the scene's split")
        ckpt = init_reference_ckpt(os.path.join(tmp, "bg.ckpt"), hp, n_images=TTO_TRAIN, seed=1)
        saved = torch.load(ckpt, weights_only=False)
        gt_train = torch.tensor(np.stack([meta.GT_poses_dict[i] for i in meta.img_ids_train]), dtype=torch.float32)
        saved["state_dict"]["se3_refine.weight"] = se3.SE3_to_se3(gt_train)  # the learned frame is the GT frame
        torch.save(saved, ckpt)
        # every image: the checkpoint's render at its GT pose (train image 0's appearance), written full size
        sd, _, _ = load_reference_ckpt(ckpt)
        params, _ = render_params(sd, NeRFConfig.from_hparams(hp), dev)
        renderer = make_pose_renderer(RenderConfig.from_hparams(hp)._replace(perturb=0.0), chunk=CHUNK)
        K_full = np.array([[TTO_FOCAL, 0, TTO_PNG_WH[0] / 2], [0, TTO_FOCAL, TTO_PNG_WH[1] / 2], [0, 0, 1]], np.float32)
        for id_ in meta.img_ids:
            rgb, _ = render_image(renderer, params, K_full, meta.GT_poses_dict[id_], TTO_PNG_WH,
                                  [hp["nerf.near"], hp["nerf.far"]], 0, chunk=CHUNK, device=dev)
            write_png(os.path.join(meta.image_dir, meta.image_paths[id_]),
                      (np.clip(rgb, 0, 1) * 255).round().astype(np.uint8))
        print(f"[13] scene ({TTO_TRAIN} train + {TTO_TEST} test, {TTO_PNG_WH[0]}x{TTO_PNG_WH[1]} PNGs, COLMAP"
              f" binaries, tsv) and checkpoint written in {time.perf_counter() - t0:.1f} s", flush=True)

        result_dir = os.path.join(tmp, "result")
        argv = ["--ckpt", ckpt, "--result_dir", result_dir, "--group_size", str(TTO_TEST), "--batch_size", "1024",
                "--pose_epochs", str(TTO_EPOCHS[0]), "--appearance_epochs", str(TTO_EPOCHS[1]), "--device", dev.type]
        rt.launches = rt.bwd_launches = rt.frozen_bwd_launches = 0
        t0 = time.perf_counter()
        metrics_path = tto_cli.main(argv)
        torch.cuda.synchronize()
        tto_s = time.perf_counter() - t0
        launches = {"fwd": rt.launches, "bwd": rt.bwd_launches, "frozen": rt.frozen_bwd_launches}
        w, h = TTO_PNG_WH[0] // 2, TTO_PNG_WH[1] // 2
        steps_a = -(-w * h // 1024)
        steps = TTO_EPOCHS[0] * steps_a + TTO_EPOCHS[1] * max(1, steps_a // 2)
        evals = sum(TTO_EPOCHS)  # one chunk each (64 x 64 padded region, group of 4)
        want = {"fwd": 2 * steps + 2 * evals, "bwd": 0, "frozen": steps}
        print(f"[13] tto: {steps} steps + {evals} eval renders in {tto_s:.2f} s; launches {launches} (expected {want}:"
              " 2 forward + 1 frozen backward a step, 2 forward an eval chunk)", flush=True)
        check(launches == want, f"TTO kernel launches {launches}, expected {want}")
        with open(metrics_path) as f:
            m = json.load(f)
        check(sorted(m) == [str(i) for i in range(TTO_TEST)], f"metrics.json keys {sorted(m)}")
        check(all(np.isfinite(v["psnr"]) and np.isfinite(v["ssim"]) for v in m.values()), f"metrics not finite: {m}")
        gt_test = torch.tensor(np.stack([meta.GT_poses_dict[i] for i in meta.img_ids_test]), dtype=torch.float32)
        worst_deg = 0.0
        for i in range(TTO_TEST):
            pose = np.load(os.path.join(result_dir, "a_optimize", "optimized_pose", f"best_pose_{i:02d}.npy"))
            emb = np.load(os.path.join(result_dir, "a_optimize", "optimized_emb_a", f"best_emb_{i:02d}.npy"))
            check(pose.shape == (3, 4) and emb.shape == (hp["nerf.appearance_dim"],), "pose / embedding file shapes")
            rad = procrustes.rotation_distance(torch.from_numpy(pose[:, :3]).float(), gt_test[i, :, :3])
            deg = float(rad) * 180 / np.pi
            dt = float(np.linalg.norm(pose[:, 3] - gt_test[i, :, 3].numpy()))
            worst_deg = max(worst_deg, deg)
            print(f"    test image {i}: psnr {m[str(i)]['psnr']:.2f} ssim {m[str(i)]['ssim']:.4f}; refined pose vs GT"
                  f" {deg:.4f} deg, |d t| {dt:.2e}", flush=True)
        check(worst_deg <= TTO_POSE_DEG, f"a refined test pose is {worst_deg:.3f} deg from GT (bound {TTO_POSE_DEG})")

        ev = eval_cli.main(["--ckpt", ckpt, "--result_dir", result_dir, "--device", dev.type])
        check(all(np.isfinite(v) for v in ev.values()), f"eval printed non-finite numbers: {ev}")
        check(ev["train/pose_R"] <= EVAL_POSE_DEG and ev["train/pose_R_rel"] <= EVAL_POSE_DEG,
              f"train pose errors should be ~0: {ev}")
        print(f"[13] eval: {ev}", flush=True)

        # SSIM of one pair of 64x48 images on the card against the CPU
        img = torch.from_numpy(np.random.RandomState(13).rand(h, w, 3).astype(np.float32))
        ref = torch.from_numpy(np.random.RandomState(14).rand(h, w, 3).astype(np.float32)) * 0.2 + img * 0.8
        d_ssim = abs(float(metrics.ssim(img.to(dev), ref.to(dev))) - float(metrics.ssim(img, ref)))
        print(f"[13] SSIM card vs CPU: |d| {d_ssim:.2e} (tol {SSIM_TOL:.0e})", flush=True)
        check(d_ssim <= SSIM_TOL, "SSIM on the card disagrees with the CPU")

        # a TTO step of group 4 x batch 1024, and an eval chunk (group 4 x 4096 rays), CUDA events
        Ks = np.stack([meta.Ks[i] for i in meta.img_ids_test])
        step_ms, chunk_ms, peak, step_a = time_tto(ckpt, Ks, gt_test, dev)
        print(f"[13] TTO step ({TTO_TEST} x 1024 rays, phase A): {step_ms:.2f} ms, peak memory {peak:.2f} GiB; eval"
              f" chunk ({TTO_TEST} x {CHUNK} rays): {chunk_ms:.2f} ms, {chunk_ms / TTO_TEST:.2f} ms per {CHUNK} rays"
              f" ({card})", flush=True)
        if profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                step_a()
                torch.cuda.synchronize()
            with open(os.path.join(profile_dir, "tto_step.txt"), "w") as f:
                f.write(f"{card}\n{prof.key_averages().table(sort_by='cuda_time_total', row_limit=30)}\n")
            print(f"[13] profile of one TTO step -> {profile_dir}", flush=True)
    return launches["frozen"], step_ms, chunk_ms


def time_tto(ckpt: str, Ks: np.ndarray, base_poses: torch.Tensor, dev):
    """A TTO step of phase A (a group of len(Ks) images x batch 1024, on the
    checkpoint's frozen model and render flags, 64 x 48 images) and an eval
    chunk (the group x 4096 rays), CUDA events. Returns (step ms, chunk ms,
    the step's peak GiB, a callable running one more step)."""
    from upnerf_torch.cli import tto as tto_cli
    from upnerf_torch.evaluate.tto import TTOConfig, TTOGroup, TTORunner
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.render.render_rays import RenderConfig

    hp, frozen, _, _ = tto_cli.load_trained(ckpt, dev)
    n, (w, h) = len(Ks), (TTO_PNG_WH[0] // 2, TTO_PNG_WH[1] // 2)
    rcfg = RenderConfig.from_hparams(hp)._replace(perturb=1.0, param_grads=False)
    cfg = TTOConfig(nerf=NeRFConfig.from_hparams(hp), render=rcfg, batch_size=1024)
    runner = TTORunner(frozen, cfg, hp["nerf.appearance_dim"], region_A=(64, 64), region_B=(64, 64))
    gen = torch.Generator(device=dev).manual_seed(0)
    group = TTOGroup(
        Ks=torch.from_numpy(np.asarray(Ks, np.float32)).to(dev), base_poses=base_poses.to(dev),
        rgbs=torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8, device=dev, generator=gen),
        wh=torch.tensor([[w, h]] * n, dtype=torch.int32, device=dev),
        near_far=torch.tensor([[0.1, 5.0]] * n, device=dev),
    )
    trainables = {"fine_a": torch.randn((n, hp["nerf.appearance_dim"]), generator=gen, device=dev).requires_grad_(True),
                  "se3": torch.zeros((n, 6), device=dev, requires_grad=True)}
    opt = runner.opt_A(trainables)
    step_a = lambda: runner.step_A(trainables, opt, group, gen)  # noqa: E731
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms = cuda_ms(step_a, reps=5)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    chunk_ms = cuda_ms(lambda: runner.eval_A(trainables, group, 64, 64), reps=3)
    return step_ms, chunk_ms, peak, step_a


def phase_fast_render(dev, card: str, frame_ms: float, pose: np.ndarray, profile_dir=None):
    """Phase 15: `upnerf_torch.cli.render_video --fast` for 2 frames at 128x128
    on a seeded full-width checkpoint: the files, the trunk kernel's launches
    (one per 4096-ray chunk: the sigma-only probe), and a fast frame's time
    against the full-budget frame of phase 5; with profile_dir, a
    torch.profiler table of one fast frame. Returns the trunk launches."""
    from upnerf_torch.cli import render_video
    from upnerf_torch.evaluate.render import make_pose_renderer, render_image
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.ops import mlp
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.render.fast import FastRenderConfig
    from upnerf_torch.render.render_rays import RenderConfig
    from upnerf_torch.utils.weights import init_reference_ckpt, load_reference_ckpt, render_params

    hp = dict(BRANDENBURG_GATE)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = init_reference_ckpt(os.path.join(tmp, "bg.ckpt"), hp, n_images=4, seed=0)
        out_dir = os.path.join(tmp, "video")
        argv = ["--ckpt", ckpt, "--out", out_dir, "--frames", "2", "--wh", str(FRAME_WH[0]), str(FRAME_WH[1]),
                "--focal", str(FOCAL), "--anchor", "1", "--device", dev.type, "--fast"]
        n_chunks = FRAME_WH[0] * FRAME_WH[1] // CHUNK
        mlp.launches = rt.launches = 0
        t0 = time.perf_counter()
        written = render_video.main(argv)
        torch.cuda.synchronize()
        launches = {"trunk": mlp.launches, "render_train_fwd": rt.launches}
        want = {"trunk": 2 * n_chunks, "render_train_fwd": 2 * n_chunks * 2}
        print(f"[15] render_video --fast: 2 frames in {time.perf_counter() - t0:.2f} s, launches {launches} (expected"
              f" {want}: a probe and 2 passes per chunk)", flush=True)
        check(launches == want, f"fast render launches {launches}, expected {want}")
        for png, npy in zip(written["frames"], written["depths"]):
            check(read_png_size(png) == FRAME_WH, f"{png} has the wrong size")
            depth = np.load(npy)
            check(depth.shape == FRAME_WH[::-1] and bool(np.isfinite(depth).all()), f"{npy}: bad depth")
            check(0.0 <= float(depth.min()) and float(depth.max()) <= 5.0 + 1e-3, f"{npy}: depth outside [0, far]")
        sd, hparams, _ = load_reference_ckpt(ckpt)
        params, _ = render_params(sd, NeRFConfig.from_hparams(hparams), dev)
    # phase 5's frame: the same weights (seed 0) and pose, at the reduced budget
    rcfg = RenderConfig.from_hparams(hparams)._replace(perturb=0.0)
    renderer = make_pose_renderer(rcfg, chunk=CHUNK, fast=FastRenderConfig())
    K = np.array([[FOCAL, 0, FRAME_WH[0] / 2], [0, FOCAL, FRAME_WH[1] / 2], [0, 0, 1]], np.float32)
    render_image(renderer, params, K, pose, FRAME_WH, [0.1, 5.0], 1, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        render_image(renderer, params, K, pose, FRAME_WH, [0.1, 5.0], 1, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    fast_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"[15] fast frame {FRAME_WH[0]}x{FRAME_WH[1]} (probe 64, 64 + 64 samples, bfloat16): {fast_ms:.1f} ms,"
          f" against the full-budget frame's {frame_ms:.1f} ms (phase 5; ratio {fast_ms / frame_ms:.2f}) ({card})", flush=True)
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            render_image(renderer, params, K, pose, FRAME_WH, [0.1, 5.0], 1, chunk=CHUNK, device=dev)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
        with open(os.path.join(profile_dir, "fast_frame.txt"), "w") as f:
            f.write(f"{card}\n{table}\n")
        print(f"[15] profile of one fast frame -> {profile_dir}", flush=True)
    return launches["trunk"], fast_ms


def write_train_scene(root: str, name: str, seed: int = 0) -> None:
    """Phase 18's scene: phase 13's Phototourism layout (COLMAP binaries, tsv)
    with seeded textured PNGs, and seeded DINO maps (DINO_DIM-d, 12 x 16 cells)
    and DPT inverse-depth maps (.npy, the PNGs' size) as the preprocess CLI
    writes them."""
    from upnerf_torch.features.images import npy_name, write_png

    n = TRAIN_IMAGES + 2
    split = ["test" if i % 5 == 4 else "train" for i in range(n)]
    write_phototourism_scene(root, name, ring_poses(n), split, TTO_PNG_WH, TTO_FOCAL, seed=seed)
    rng = np.random.RandomState(seed)
    w, h = TTO_PNG_WH
    dino, dpt = os.path.join(root, "DINO", "feature_maps"), os.path.join(root, "DPT")
    os.makedirs(dino, exist_ok=True)
    os.makedirs(dpt, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        fname = f"{i:03d}.png"
        base = 128 + 80 * np.sin(xx[..., None] / (6.0 + i) + yy[..., None] / 9.0 + np.arange(3) * 2.0)
        write_png(os.path.join(root, "dense", "images", fname),
                  np.clip(base + rng.randint(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8))
        np.save(os.path.join(dino, npy_name(fname)), rng.randn(12, 16, DINO_DIM).astype(np.float32))
        np.save(os.path.join(dpt, npy_name(fname)), (1.0 + rng.rand(h, w)).astype(np.float32))


def _launch_counters():
    """(zero, read) over every kernel wrapper's launch counts (zero also
    zeroes the recompute backward's rebuilds, rt.rebuild_launches, and the dW
    kernel's, dw_gemm.dw_launches, which read leaves out: a backward call
    launches one of each a slab)."""
    from upnerf_torch.ops import dw_gemm as dg
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp
    from upnerf_torch.ops import mxu_probe as mp
    from upnerf_torch.ops import render as srk
    from upnerf_torch.ops import render_train as rt

    def zero():
        rt.launches = rt.bwd_launches = rt.frozen_bwd_launches = 0
        rt.recompute_launches = rt.recompute_bwd_launches = rt.recompute_frozen_bwd_launches = 0
        rt.rebuild_launches = rt.x0_launches = rt.x0_bwd_launches = dg.dw_launches = 0
        hk.launches = hk.bwd_launches = srk.launches = mlp.launches = mlp.bwd_launches = 0
        for c in mp.CHAINS:
            mp.launches[c] = 0

    def read():
        return {"render_fwd": rt.launches, "render_bwd": rt.bwd_launches, "render_frozen": rt.frozen_bwd_launches,
                "rec_fwd": rt.recompute_launches, "rec_bwd": rt.recompute_bwd_launches,
                "rec_frozen": rt.recompute_frozen_bwd_launches, "heads_fwd": hk.launches, "heads_bwd": hk.bwd_launches,
                "static": srk.launches, "trunk_fwd": mlp.launches, "trunk_bwd": mlp.bwd_launches,
                "x0_fwd": rt.x0_launches, "x0_bwd": rt.x0_bwd_launches,
                **{f"probe_{c}": mp.launches[c] for c in mp.CHAINS}}

    return zero, read


def _run_train(argv, label: str, zero, read, want):
    """cli.train.main(argv) with the launch counts zeroed just before and read
    just after; checks them against `want`, at least one dW kernel launch
    for each train-mode backward call, finite losses and val PSNR. Returns
    the Trainer."""
    from upnerf_torch.cli import train as train_cli
    from upnerf_torch.ops import dw_gemm as dg

    zero()
    t0 = time.perf_counter()
    tr = train_cli.main(argv)
    torch.cuda.synchronize()
    got = read()
    with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    psnrs = [r["val/psnr"] for r in recs if "val/psnr" in r]
    print(f"[{label}] {tr.state.step} steps in {time.perf_counter() - t0:.1f} s, launches {got} (expected {want});"
          f" losses {losses}, val psnr {psnrs}; checkpoints {tr.ckpt.all_steps()}", flush=True)
    check(got == want, f"[{label}] kernel launches {got}, expected {want}")
    bwd = sum(got[k] for k in ("render_bwd", "rec_bwd", "x0_bwd", "heads_bwd", "trunk_bwd"))
    print(f"[{label}] dW kernel launches {dg.dw_launches} for {bwd} train-mode backward calls", flush=True)
    check(dg.dw_launches >= bwd, f"[{label}] a backward call launched no dW kernel")
    check(bool(losses) and all(np.isfinite(losses)) and bool(psnrs) and all(np.isfinite(psnrs)),
          f"[{label}] losses {losses}, val psnr {psnrs}")
    return tr


def phase_train_cli(dev, card: str, fused_step_ms):
    """Phase 18: `upnerf_torch.cli.train.main` on the card at brandenburg_gate's
    full width and batch 2048, on write_train_scene's scene, max_steps 12
    (phase 0 at steps 0-1, 1 at 2-5, 2 at 6-11; a val render and a checkpoint
    every 6 steps): (a) the default flags, (b) tpu.fused_train false, (c) (a)
    again with max_steps 14, which resumes from step 12. Checks each run's
    kernel launches, finite losses and val PSNR, and renders (b)'s last
    checkpoint through `cli.render_video`. Then a phase-1 step of (b)'s
    configuration (CUDA events, 3 steps after a warm-up) against phase 9's
    fused step, and the loop's rays/s in (a)'s configuration against phase 9's
    phase-0 step. Returns ({kernel: launches in (b)} with kernel 1/2's in (a),
    the unfused step's ms)."""
    from upnerf_torch.cli import render_video
    from upnerf_torch.train.loop import Trainer

    zero, read = _launch_counters()
    none = {k: 0 for k in read()}
    with tempfile.TemporaryDirectory() as tmp:
        root, name = os.path.join(tmp, "scene"), "scene"
        write_train_scene(root, name)
        base = ["--config", "configs/brandenburg_gate.yaml", "--device", "cuda", "root_dir", root, "scene_name", name,
                "feat_dir", os.path.join(root, "DINO"), "depth_dir", os.path.join(root, "DPT"),
                "out_dir", os.path.join(tmp, "out"), "max_steps", "12", "val.log_interval", "6",
                "train.ckpt_interval", "6", "train.log_pose_interval", "6", "val.img_idx", "[0]",
                "phototourism.use_cache", "False", "seed", "0"]
        # per run: 12 steps x 2 passes forward and backward; a val render of 1 chunk x 2 passes at steps 6 and 12
        want = {"a": dict(none, render_fwd=2 * 12 + 2 * 2, render_bwd=2 * 12),
                "b": dict(none, heads_fwd=2 * 12, heads_bwd=2 * 12, static=2 * 2),
                "c": dict(none, render_fwd=2 * 2 + 2, render_bwd=2 * 2)}
        runs = {"a": ["exp_name", "fused"], "b": ["exp_name", "unfused", "tpu.fused_train", "false"],
                "c": ["exp_name", "fused", "max_steps", "14"]}
        trainers = {}
        for key, extra in runs.items():
            trainers[key] = tr = _run_train(base + extra, f"18 {key}: {' '.join(extra)}", zero, read, want[key])
            check(tr.state.step == (14 if key == "c" else 12), f"train ({key}) ended at step {tr.state.step}")
        check(trainers["c"].ckpt.all_steps()[-1] == 14, "the resumed run did not checkpoint step 14")
        # (b)'s last checkpoint renders through render_video
        ckpt = trainers["b"].ckpt.path(trainers["b"].ckpt.latest_step())
        zero()
        written = render_video.main(["--ckpt", ckpt, "--out", os.path.join(tmp, "video"), "--frames", "1",
                                     "--wh", "64", "48", "--focal", "50", "--device", "cuda"])
        check(read_png_size(written["frames"][0]) == (64, 48), "render_video of the trained checkpoint")
        print(f"[18] render_video of (b)'s step-{trainers['b'].state.step} checkpoint: {written['frames'][0]}"
              f" ({read()['static']} static render launches)", flush=True)

        # a phase-1 step of (b)'s configuration, and the loop's rays/s in (a)'s
        tb = trainers["b"]
        tb.state = tb.state._replace(step=4)  # progress 0.33: phase 1
        state = tb.state

        def one_step():
            nonlocal state
            state, _ = tb.step_fn(state._replace(step=4), tb.scene, tb.store, 1)

        torch.cuda.reset_peak_memory_stats(dev)
        unfused_ms = cuda_ms(one_step, 3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[18] phase-1 step, tpu.fused_train false (kernel 5 + plain compositing): {unfused_ms:.2f} ms,"
              f" {TRAIN_RAYS / unfused_ms * 1e3:.0f} rays/s, peak {peak:.2f} GiB; phase 9's fused phase-1 step"
              f" {fused_step_ms[1]:.2f} ms ({card})", flush=True)
        hp = dict(trainers["a"].hp, exp_name="loop", max_steps=MAX_STEPS)
        hp.update({"val.log_interval": 10**9, "train.ckpt_interval": 10**9, "train.log_pose_interval": 0})
        tl = Trainer(hp, device=dev)
        tl.fit(log_every=4, max_steps=12)
        with open(os.path.join(tl.save_dir, "metrics.jsonl")) as f:
            rps = [json.loads(line)["rays_per_sec"] for line in f if "rays_per_sec" in line]
        print(f"[18] the loop's rays/s in phase 0 (windows of 4 steps, host clock): {[round(r) for r in rps]};"
              f" phase 9's phase-0 step {fused_step_ms[0]:.2f} ms = {TRAIN_RAYS / fused_step_ms[0] * 1e3:.0f} rays/s"
              f" ({card})", flush=True)
    # the runs' launches, each checked equal to these by _run_train
    launches = dict(want["b"], render_fwd=want["a"]["render_fwd"], render_bwd=want["a"]["render_bwd"])
    return launches, unfused_ms


def trunk_bwd_bound(field, nerf_cfg, n: int):
    """bound() of one trunk-backward call on n rows in bf16: it reads x0, the
    cotangent and the weights, writes dx0 and every dW and db, and does the
    recompute, the walk's data path and the dW products (3 x the trunk's
    multiply-adds)."""
    n_w = sum(lay.weight.numel() + lay.bias.numel() for lay in field.trunk_layers())
    in0, W = nerf_cfg.in_channels_xyz, nerf_cfg.W
    return bound(6.0 * trunk_macs(nerf_cfg) * n, 4 * n * (2 * in0 + W) + 2 * n_w + 4 * n_w, "bfloat16")


def phase_trunk_bwd(field, nerf_cfg, dev, card: str):
    """Phase 19: the trunk kernel's backward (kernel 6's, the trunk-only mode
    of csrc/heads_bwd.cu) against its plain version, held as kernel 5's
    backward is (phase 16: it recomputes the chain, so ReLU masks can flip):
    weight gradients by max |d| over max |g|, dx0 by RMS, closer to the plain
    version of its precision than to the other's, and no further from the
    float64 plain backward than HEADS_F64_RATIO times the plain version's own
    distance; at 524,288 rows bf16 (a feature-less fine pass), 65,536 rows
    f32 and a ragged N. Then timed in turns with the plain version at
    524,288 rows, bf16. Returns (worst dx0 max |d|, kernel ms, plain ms)."""
    from upnerf_torch.models.nerf import positional_encoding
    from upnerf_torch.ops import heads, mlp

    trunk = field.trunk_weights()
    skips = nerf_cfg.skips
    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    flat = lambda b: torch.cat([t.double().flatten() for wb in b[1] for t in wb])  # noqa: E731
    worst = 0.0
    n_full = TRAIN_RAYS * 256
    for n, prec in ((n_full, "bfloat16"), (65536, "float32"), (1037, "bfloat16"), (1037, "float32")):
        g = torch.Generator(device=dev).manual_seed(19 + n)
        x0 = positional_encoding(torch.randn((n, 3), generator=g, device=dev), nerf_cfg.xyz_L).contiguous()
        cot = torch.randn((n, nerf_cfg.W), generator=g, device=dev)
        other = "float32" if prec == "bfloat16" else "bfloat16"
        with torch.no_grad():
            kb = mlp.fused_trunk_bwd(x0, trunk, skips, prec, cot)
            pb = mlp.fused_trunk_bwd_plain(x0, trunk, skips, prec, cot)
            po = mlp.fused_trunk_bwd_plain(x0, trunk, skips, other, cot)[0]
            p64 = mlp.fused_trunk_bwd_plain(x0.double(), [(w.double(), b.double()) for w, b in trunk], skips,
                                            "float32", cot)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kb[0]).all()) and bool(torch.isfinite(flat(kb)).all()),
              f"trunk backward not finite (N={n} {prec})")
        berr = {}
        for i, ((kw_, kb_), (pw_, pb_)) in enumerate(zip(kb[1], pb[1])):
            berr[f"trunk{i}.w"], berr[f"trunk{i}.b"] = rel_err(kw_, pw_), rel_err(kb_, pb_)
        row_rms = rms(kb[0] - pb[0]) / rms(pb[0])
        row_ratio = rms(kb[0] - pb[0]) / rms(kb[0] - po)
        w64 = {"dx0": rms(kb[0] - p64[0]) / rms(pb[0] - p64[0]),
               "dW": rms(flat(kb) - flat(p64)) / rms(flat(pb) - flat(p64))}
        worst = max(worst, (kb[0] - pb[0]).abs().max().item())
        bw = max(berr, key=berr.get)
        print(f"[19] trunk backward N={n} {prec}: {len(berr)} weight gradients, worst {bw} {berr[bw]:.3e} (tol"
              f" {HEADS_BWD_TOL:.0e}); dx0 RMS {row_rms:.3e} (tol {HEADS_ROW_RMS_TOL:.0e}), RMS distance to {prec}"
              f" plain / to {other} plain {row_ratio:.3e} (limit {TRUNK_RMS_RATIO}), max |d| / max |g|"
              f" {rel_err(kb[0], pb[0]):.3e}; RMS distance to float64 plain, kernel / plain "
              + " ".join(f"{k} {v:.3f}" for k, v in w64.items()) + f" (limit {HEADS_F64_RATIO})", flush=True)
        check(berr[bw] <= HEADS_BWD_TOL, f"trunk backward disagrees with its plain version: {berr}")
        check(row_rms <= HEADS_ROW_RMS_TOL, f"trunk backward's dx0: {row_rms}")
        check(row_ratio <= TRUNK_RMS_RATIO, f"trunk backward does not round as its plain version: {row_ratio}")
        check(max(w64.values()) <= HEADS_F64_RATIO, f"trunk backward is further from float64 than its plain: {w64}")
        del kb, pb, po, p64
        torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(190)
    x0 = positional_encoding(torch.randn((n_full, 3), generator=g, device=dev), nerf_cfg.xyz_L).contiguous()
    cot = torch.randn((n_full, nerf_cfg.W), generator=g, device=dev)
    with torch.no_grad():
        kern = lambda: mlp.fused_trunk_bwd(x0, trunk, skips, "bfloat16", cot)  # noqa: E731
        plain = lambda: mlp.fused_trunk_bwd_plain(x0, trunk, skips, "bfloat16", cot)  # noqa: E731
        p1, k1, k2, p2 = cuda_ms(plain, 2), cuda_ms(kern, 3), cuda_ms(kern, 3), cuda_ms(plain, 2)
        kms, pms = (k1 + k2) / 2, (p1 + p2) / 2
        flop = 6.0 * trunk_macs(nerf_cfg) * n_full
        print(f"[19] trunk backward N={n_full} bfloat16: kernel {kms:.2f} ms ({k1:.2f}, {k2:.2f};"
              f" {flop / kms / 1e9:.0f} TFLOP/s), plain {pms:.2f} ms ({p1:.2f}, {p2:.2f}) ({card})", flush=True)
        bwd_pieces(heads.BwdCall(x0, None, trunk, None, skips, "bfloat16", [cot]), kern, "19",
                   f"trunk backward N={n_full} bfloat16", dev, card)
    return worst, kms, pms


def phase_featureless(dev, card: str, fused_step_ms):
    """Phase 20: the feature-less field (nerf.feat_dim 0) through the CLIs at
    brandenburg_gate's width: cli.train for 12 steps on phase 18's scene (2
    trunk forward + 2 trunk backward launches a step, 2 trunk forward
    launches a val render, no launch of kernels 1, 2, 4, 5), cli.tto +
    cli.eval on its checkpoint, cli.render_video on its run directory; then
    a phase-1 step's ms against phase 9's fused step. Returns the trunk
    launches of the train run."""
    from upnerf_torch.cli import eval as eval_cli
    from upnerf_torch.cli import render_video
    from upnerf_torch.cli import tto as tto_cli

    zero, read = _launch_counters()
    none = {k: 0 for k in read()}
    with tempfile.TemporaryDirectory() as tmp:
        root, name = os.path.join(tmp, "scene"), "scene"
        write_train_scene(root, name)
        argv = ["--config", "configs/brandenburg_gate.yaml", "--device", "cuda", "root_dir", root, "scene_name", name,
                "feat_dir", os.path.join(root, "DINO"), "depth_dir", os.path.join(root, "DPT"),
                "out_dir", os.path.join(tmp, "out"), "max_steps", "12", "val.log_interval", "6",
                "train.ckpt_interval", "6", "train.log_pose_interval", "6", "val.img_idx", "[0]",
                "phototourism.use_cache", "False", "seed", "0", "exp_name", "featureless", "nerf.feat_dim", "0"]
        # 12 steps x 2 passes; a val render of 1 chunk x 2 passes at steps 6 and 12 (no grad: forward only)
        want = dict(none, trunk_fwd=2 * 12 + 2 * 2, trunk_bwd=2 * 12)
        tr = _run_train(argv, "20", zero, read, want)
        field = tr.state.params.nerf_fine
        check(not hasattr(field, "feat_share_layer") and hasattr(field, "rgb_candidate_layer"),
              "the feature-less field has a feature head")
        ckpt = tr.ckpt.path(tr.ckpt.latest_step())

        result_dir = os.path.join(tmp, "result")
        argv = ["--ckpt", ckpt, "--result_dir", result_dir, "--group_size", "2", "--batch_size", "1024",
                "--pose_epochs", "1", "--appearance_epochs", "1", "--device", "cuda"]
        zero()
        t0 = time.perf_counter()
        metrics_path = tto_cli.main(argv)
        torch.cuda.synchronize()
        got = read()
        w, h = TTO_PNG_WH[0] // 2, TTO_PNG_WH[1] // 2
        steps_a = -(-w * h // 1024)  # the steps of the pose epoch; the appearance epoch takes max(1, steps_a // 2)
        # the loss reads the fine pass only, and an appearance step moves no input of the trunk: one trunk
        # backward a pose step; two forwards a step and an eval chunk
        want_tto = dict(none, trunk_fwd=2 * (steps_a + max(1, steps_a // 2)) + 2 * 2, trunk_bwd=steps_a)
        print(f"[20] tto on the feature-less checkpoint in {time.perf_counter() - t0:.1f} s: launches {got}"
              f" (expected {want_tto})", flush=True)
        check(got == want_tto, f"feature-less TTO launches {got}, expected {want_tto}")
        with open(metrics_path) as f:
            m = json.load(f)
        check(len(m) == 2 and all(np.isfinite(v["psnr"]) and np.isfinite(v["ssim"]) for v in m.values()),
              f"feature-less TTO metrics {m}")
        ev = eval_cli.main(["--ckpt", ckpt, "--result_dir", result_dir, "--device", "cuda"])
        check(all(np.isfinite(v) for v in ev.values()), f"eval printed non-finite numbers: {ev}")
        print(f"[20] eval: {ev}", flush=True)
        zero()
        written = render_video.main(["--result_dir", tr.save_dir, "--ckpt", "last", "--frames", "1", "--device",
                                     "cuda"])
        check(read_png_size(written["frames"][0]) == (w, h), "render_video of the feature-less run")
        print(f"[20] render_video --result_dir: {written['frames'][0]} at the scene's {w}x{h}, launches {read()}",
              flush=True)

        state = tr.state

        def one_step():
            nonlocal state
            state, _ = tr.step_fn(state._replace(step=4), tr.scene, tr.store, 1)

        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = cuda_ms(one_step, 3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[20] phase-1 step, nerf.feat_dim 0 (trunk kernel forward and backward, PyTorch heads and"
              f" compositing): {step_ms:.2f} ms, {TRAIN_RAYS / step_ms * 1e3:.0f} rays/s, peak {peak:.2f} GiB;"
              f" phase 9's fused phase-1 step {fused_step_ms[1]:.2f} ms ({card})", flush=True)
    return want


def phase_synth_pose(dev, card: str):
    """Phase 21: configs/validation/synth_pose.yaml (nerf.feat_dim 32) on its
    scene, written by the ported generator at the config's size, 12 steps
    (phases 0, 1, 2): (a) the default flags, through the F = 32 instances of
    kernels 1 and 2; (b) tpu.fused_train false, through those of kernels 5
    and 4. Checks each run's launches and finite losses."""
    from upnerf_torch.data.synthetic import generate_scene

    zero, read = _launch_counters()
    none = {k: 0 for k in read()}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "scene_pose")
        t0 = time.perf_counter()
        generate_scene(root, n_train=16, n_test=2, H=64, W=80, feat_hw=16, feat_dim=32, focal=80.0, arc=0.5)
        print(f"[21] synth_pose scene (16 + 2 views of 80x64, 16x16x32 DINO maps) written in"
              f" {time.perf_counter() - t0:.2f} s", flush=True)
        base = ["--config", "configs/validation/synth_pose.yaml", "--device", "cuda", "root_dir", root,
                "feat_dir", os.path.join(root, "DINO"), "depth_dir", os.path.join(root, "DPT"),
                "out_dir", os.path.join(tmp, "out"), "max_steps", "12", "candidate_schedule", "[0.1, 0.5]",
                "val.log_interval", "6", "train.ckpt_interval", "6", "train.log_pose_interval", "6",
                "val.img_idx", "[0]", "seed", "0"]
        chunks = -(-(64 // 2) * (80 // 2) // 4096)  # a val render's chunks: at downscale 2 (the Trainer's floor)
        runs = {"a": (["exp_name", "fused"], dict(none, render_fwd=2 * 12 + 2 * 2 * chunks, render_bwd=2 * 12)),
                "b": (["exp_name", "unfused", "tpu.fused_train", "false"],
                      dict(none, heads_fwd=2 * 12, heads_bwd=2 * 12, static=2 * 2 * chunks))}
        for key, (extra, want) in runs.items():
            tr = _run_train(base + extra, f"21 {key}", zero, read, want)
            F = tr.state.params.nerf_fine.feat_share_layer.out_features
            check(F == 32 and tr.state.step == 12, f"synth_pose ({key}): F = {F}, step {tr.state.step}")
    return runs["a"][1], runs["b"][1]


def plain_bwd_chunked(args, st, c_emb, res, cots, dtype=torch.float32, rays: int = 1024):
    """render_train_rays_bwd_plain over chunks of rays (bounded memory), in
    dtype: the PE rows, plain_x0_bwd_chunked, the PE backward."""
    from upnerf_torch.ops import render_train as rt

    o, d, z, pe_w, cond, trunk, heads = args[:7]
    x0, xyz = rt._pe(o.to(dtype), d.to(dtype), z.to(dtype), pe_w.to(dtype), st.xyz_L)
    d_x0, d_cond, d_cemb, dtrunk, dh = plain_x0_bwd_chunked((x0, z, cond, trunk, heads, st), c_emb, res, cots, dtype,
                                                            rays)
    return (*rt._pe_bwd(d_x0, xyz, z.to(dtype), pe_w.to(dtype), st.xyz_L), d_cond, d_cemb, dtrunk, dh)


def phase_recompute_kernels(fields, dev, card: str):
    """Phase 22: the recompute mode (save_chain=False) at 4096 rays x S = 256,
    bf16 and f32, phases 0, 1, 2, at F = 384 and 32 (fields: (field, nerf_cfg)
    pairs). Per case: kernel 1's forward without a chain against its plain
    version (outputs at TOL; sig_s, sig_c, rgb at TOL and feat / c_feat at
    CHAIN_TOL of their max); kernel 2's recompute train mode against the plain
    recompute backward (per-ray data cotangents by RMS with the float64
    witness, as phase 16; weight gradients at REC_DW_TOL and by the witness)
    and against the saved-chain kernel on the same inputs (each on its own
    forward's residuals); the frozen recompute mode's data cotangents against the train
    mode's, bit for bit. The route rebuilds each slab's chain with the forward
    kernel itself, so against the saved-chain kernel every output holds at
    BWD_TOL by the max; against the plain recompute, which sums in another
    order, ReLU masks flip (REC_DW_TOL). Then, at F = 384 bf16, in turns: the
    recompute train backward against the saved-chain one (phase 1), the
    recompute frozen backward against the saved-chain frozen one (phase 2),
    the forward with residuals in both modes (phase 1), and the plain
    versions; and each recompute backward's pieces over the chunk's slabs in
    turns (the whole call, the rebuilds, the walks, the dW kernel). Returns
    ({name: (kernel ms, plain ms, saved-chain ms)}, worst forward max |d|, worst backward max
    |d| against plain, worst frozen max |d| against plain)."""
    from upnerf_torch.ops import render_train as rt

    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    worst_f = worst_b = worst_z = 0.0
    for field, nerf_cfg in fields:
        F = nerf_cfg.feat_dim
        inputs = chunk_inputs(field, 256, seed=220 + F, dev=dev, R=CHUNK)
        for prec in ("bfloat16", "float32"):
            for phase in (0, 1, 2):
                saved = train_static(nerf_cfg, prec, phase)
                st = saved._replace(save_chain=False)
                args, c_emb = mode_args(field, inputs, st)
                with torch.no_grad():
                    got, got_res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
                    want, want_res = rt.render_train_rays_plain(*args, c_emb=c_emb, save_res=True)
                    _, saved_res = rt.render_train_rays_fwd(*args[:7], saved, c_emb=c_emb, save_res=True)
                    g = torch.Generator(device=dev).manual_seed(22 + phase)
                    cots = {k: torch.randn(want[k].shape, generator=g, device=dev) for k in st.out_keys}
                    kb = rt.render_train_rays_bwd(*args[:7], st, c_emb, got_res, cots)
                    kz = rt.render_train_rays_bwd(*args[:7], st._replace(param_grads=False), c_emb, got_res, cots)
                    ks = rt.render_train_rays_bwd(*args[:7], saved, c_emb, saved_res, cots)
                    pb = plain_bwd_chunked(args, st, c_emb, got_res, cots)
                    p64 = plain_bwd_chunked(args, st, c_emb, got_res, cots, torch.float64)
                torch.cuda.synchronize()
                check(tuple(got_res) == st.res_keys, f"residuals {tuple(got_res)}, expected {st.res_keys}")
                ef = {}
                for k in st.out_keys:
                    check(bool(torch.isfinite(got[k]).all()), f"[22] forward {k} not finite")
                    diff = (got[k] - want[k]).abs()
                    ef[k] = (diff / want[k].abs().clamp(min=1e-6)).max().item() if "depth" in k else diff.max().item()
                er = {k: rel_err(got_res[k], want_res[k]) for k in st.res_keys}
                worst_f = max([worst_f] + [v for k, v in ef.items() if "depth" not in k])
                names = ["rays_o", "rays_d", "ray_cond", "c_emb"]
                rows = [(n, i) for i, n in enumerate(names) if pb[i] is not None]
                row_rms = {n: rms(kb[i] - pb[i]) / rms(pb[i]) for n, i in rows}
                w64 = {n: rms(kb[i] - p64[i]) / rms(pb[i] - p64[i]) for n, i in rows}
                flat = lambda b: torch.cat([t.double().flatten() for wb in b[4] for t in wb]  # noqa: E731
                                           + [b[5][k].double().flatten() for k in st.head_keys])
                w64["dW"] = rms(flat(kb) - flat(p64)) / rms(flat(pb) - flat(p64))
                berr, serr = {}, {}
                for i, ((kw_, kb_), (pw_, pb_), (sw_, sb_)) in enumerate(zip(kb[4], pb[4], ks[4])):
                    berr[f"trunk{i}.w"], berr[f"trunk{i}.b"] = rel_err(kw_, pw_), rel_err(kb_, pb_)
                    serr[f"trunk{i}.w"], serr[f"trunk{i}.b"] = rel_err(kw_, sw_), rel_err(kb_, sb_)
                for k in st.head_keys:
                    berr[k] = rel_err(kb[5][k], pb[5][k].reshape(kb[5][k].shape))
                    serr[k] = rel_err(kb[5][k], ks[5][k])
                for n, i in rows:
                    serr[n] = rel_err(kb[i], ks[i])
                same = {n: torch.equal(kz[i], kb[i]) for n, i in rows}
                worst_b = max([worst_b] + [(kb[i] - pb[i]).abs().max().item() for _, i in rows])
                worst_z = max([worst_z] + [(kz[i] - pb[i]).abs().max().item() for _, i in rows])
                bw, sw = max(berr, key=berr.get), max(serr, key=serr.get)
                print(f"[22] F={F} {prec} phase {phase}: forward worst {max(ef.values()):.3e} (tol {TOL[prec]:.0e}),"
                      " residuals " + " ".join(f"{k} {v:.2e}" for k, v in er.items())
                      + f" (feat/cfeat tol {CHAIN_TOL[prec]:.0e}); backward vs plain: dW worst {bw} {berr[bw]:.3e} (tol"
                      f" {BWD_TOL[prec]:.0e}), per-ray RMS " + " ".join(f"{k} {v:.2e}" for k, v in row_rms.items())
                      + f" (tol {HEADS_ROW_RMS_TOL:.0e}), float64 witness kernel / plain "
                      + " ".join(f"{k} {v:.3f}" for k, v in w64.items()) + f" (limit {HEADS_F64_RATIO}); vs saved"
                      f" chain, max |d| / max |g|: worst {sw} {serr[sw]:.3e} (tol {BWD_TOL[prec]:.0e}), "
                      + " ".join(f"{n} {serr[n]:.2e}" for n, _ in rows) + f"; frozen == train bit for bit {same}",
                      flush=True)
                check(max(ef.values()) <= TOL[prec], f"[22] the no-chain forward disagrees: {ef}")
                check(all(v <= (CHAIN_TOL if k in ("feat", "cfeat") else TOL)[prec] for k, v in er.items()),
                      f"[22] the no-chain forward's residuals disagree: {er}")
                check(berr[bw] <= REC_DW_TOL[prec], f"[22] recompute weight gradients vs plain: {berr}")
                check(serr[sw] <= BWD_TOL[prec], f"[22] the recompute mode against the saved-chain mode: {serr}")
                check(max(row_rms.values()) <= HEADS_ROW_RMS_TOL, f"[22] recompute data cotangents vs plain: {row_rms}")
                check(max(w64.values()) <= HEADS_F64_RATIO, f"[22] further from float64 than the plain version: {w64}")
                check(all(same.values()), f"[22] the frozen recompute mode differs from the train mode: {same}")
                del got, got_res, want, want_res, saved_res, kb, kz, ks, pb, p64
                torch.cuda.empty_cache()

    # timings per 4096-ray chunk, bf16, in turns: F = 384 (the kernels line's), and the backward at F = 32
    times, pieces = {}, {}
    cases = [(fields[0], "bwd", 1, False), (fields[0], "frozen", 2, True), (fields[0], "fwd", 1, False)]
    cases += [(fields[1], "bwd, F=32", 1, False), (fields[1], "frozen, F=32", 2, True)]
    for (field, nerf_cfg), name, phase, frozen in cases:
        inputs = chunk_inputs(field, 256, seed=9, dev=dev, R=CHUNK)
        saved = train_static(nerf_cfg, "bfloat16", phase)._replace(param_grads=not frozen)
        st = saved._replace(save_chain=False)
        args, c_emb = mode_args(field, inputs, st)
        with torch.no_grad():
            out, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
            _, res_s = rt.render_train_rays_fwd(*args[:7], saved, c_emb=c_emb, save_res=True)
            g = torch.Generator(device=dev).manual_seed(3)
            cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out.items()}
            if name == "fwd":
                rec = lambda: rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)  # noqa: E731
                old = lambda: rt.render_train_rays_fwd(*args[:7], saved, c_emb=c_emb, save_res=True)  # noqa: E731
                plain = lambda: rt.render_train_rays_plain(*args, c_emb=c_emb, save_res=True)  # noqa: E731
            else:
                rec = lambda: rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots)  # noqa: E731
                old = lambda: rt.render_train_rays_bwd(*args[:7], saved, c_emb, res_s, cots)  # noqa: E731
                plain = lambda: rt.render_train_rays_bwd_plain(*args[:7], st, c_emb, res, cots)  # noqa: E731
            s1, r1, r2, s2 = cuda_ms(old, 2), cuda_ms(rec, 2), cuda_ms(rec, 2), cuda_ms(old, 2)
            p1 = cuda_ms(plain, 1)
            if name != "fwd":  # the route's pieces over the chunk's slabs, in turns with the whole call (the walks
                # and dW launches alone read the chain the slab buffer holds, the last slab's: the same work)
                call = rt.render_train_rays_bwd_launch(*args[:7], st, c_emb, res, cots)
                slabs = [(r0, min(CHUNK, r0 + call.slab)) for r0 in range(0, CHUNK, call.slab)]
                fns = {"call": call.run, "rebuild": lambda: [call.rebuild(*sl) for sl in slabs],
                       "walk": lambda: [call.walk(*sl) for sl in slabs]}
                if call.stores:
                    fns["dw"] = lambda: [call.dw(*sl) for sl in slabs]
                t = {k: [cuda_ms(fn, 2)] for k, fn in fns.items()}
                for k, fn in reversed(list(fns.items())):
                    t[k].append(cuda_ms(fn, 2))
                pieces[name] = {k: sum(v) / 2 for k, v in t.items()}
                pieces[name]["slabs"] = (len(slabs), call.slab)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                call.run()  # the host's time to issue a call's launches, against the card's time for them
                pieces[name]["host"] = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                del call
        times[name] = ((r1 + r2) / 2, p1, (s1 + s2) / 2)
        print(f"[22] F={nerf_cfg.feat_dim} {name}, per {CHUNK}-ray chunk, S=256, bfloat16: recompute mode"
              f" {times[name][0]:.2f} ms ({r1:.2f}, {r2:.2f}), saved chain {times[name][2]:.2f} ms ({s1:.2f},"
              f" {s2:.2f}), plain recompute {p1:.2f} ms ({card})", flush=True)
        if name in pieces:
            pc = pieces[name]
            print(f"[22] F={nerf_cfg.feat_dim} {name}, the route's pieces over {pc['slabs'][0]} slabs of"
                  f" {pc['slabs'][1]} rays, in turns: whole call {pc['call']:.2f} ms, rebuild (wg_kernel)"
                  f" {pc['rebuild']:.2f} ms, walk {pc['walk']:.2f} ms"
                  + (f", dW kernel {pc['dw']:.2f} ms" if "dw" in pc else "")
                  + f"; the host issues a call's launches in {pc['host']:.2f} ms ({card})", flush=True)
        del out, res, res_s, inputs
        torch.cuda.empty_cache()
    return times, worst_f, worst_b, worst_z


STREAM_RAYS = 130_000_000  # phase 23's host ray store: a quarter of a downscale-1 store (docs/DESIGN.md:413-426)
STREAM_STEPS = 20


def write_ray_store(root: str, n: int, n_images: int, wh, seed: int = 0):
    """A ray store of n rays as .npy files in the cache's dtypes (px, py uint16,
    img_idx int32, rgb uint8 x 3, inv_depth float16; upnerf_torch/data/cache.py),
    written in slices, then opened as memmaps as load_cache opens them."""
    rng = np.random.RandomState(seed)
    specs = {"px": ((n,), np.uint16), "py": ((n,), np.uint16), "img_idx": ((n,), np.int32),
             "rgb": ((n, 3), np.uint8), "inv_depth": ((n,), np.float16)}
    arrs = {k: np.lib.format.open_memmap(os.path.join(root, f"{k}.npy"), "w+", dt, shape) for k, (shape, dt) in
            specs.items()}
    step = 10_000_000
    for i in range(0, n, step):
        m = min(step, n - i)
        arrs["px"][i:i + m] = rng.randint(0, wh[0], m)
        arrs["py"][i:i + m] = rng.randint(0, wh[1], m)
        arrs["img_idx"][i:i + m] = np.sort(rng.randint(0, n_images, m))
        arrs["rgb"][i:i + m] = rng.randint(0, 256, (m, 3))
        arrs["inv_depth"][i:i + m] = rng.uniform(0.2, 5.0, m)
    for a in arrs.values():
        a.flush()
    del arrs
    return {k: np.load(os.path.join(root, f"{k}.npy"), mmap_mode="r") for k in specs}


def phase_memory_saving(dev, card: str, step_ms, step_peaks, tto_ms):
    """Phase 23: the memory-saving configuration (tpu.save_chain false,
    tpu.store_on_device false) end to end. (1) The flagship step of phase 8/9
    with save_chain=False: ms and peak memory per phase beside phase 9's, 2
    forward + 2 backward launches a step, all in the recompute mode. (2) The
    prefetcher on a host memmap store of STREAM_RAYS rays: gather ms per
    2048-ray batch, the step's wait for its batch (p50 / p95), and rays/s of
    STREAM_STEPS phase-1 steps fed by it against as many from the
    device-resident store. (3) cli.train on phase 18's scene with both keys,
    12 steps with val renders and checkpoints: 2 + 2 recompute launches a
    step; and the loop's rays/s (windows of 4 steps) against (1)'s phase-0
    step. (4) cli.tto and cli.eval on its checkpoint: 2 forwards and 1 frozen
    recompute backward a step, finite metrics; a TTO step's ms against phase
    13's. Returns the launches of (3) and (4) and the step times of (1)."""
    from upnerf_torch.cli import eval as eval_cli
    from upnerf_torch.cli import tto as tto_cli
    from upnerf_torch.data import prefetch
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.train import make_train_step
    from upnerf_torch.train.loop import Trainer

    zero, read = _launch_counters()
    none = {k: 0 for k in read()}
    # (1) the flagship step
    cfg, scene, store, n_images = flagship_world(dev)
    cfg = cfg._replace(render=cfg.render._replace(save_chain=False))
    state, opt, pose_opt = fresh_state(cfg, n_images, dev)
    step, batch_step = make_train_step(cfg, opt, pose_opt)
    zero()
    n_steps = 3
    state, times, peaks = time_steps(step, state, scene, store, dev, "23", n_steps)
    steps = len(STEP_PHASES) * (n_steps + 1)
    want = dict(none, rec_fwd=2 * steps, rec_bwd=2 * steps)
    check(read() == want, f"[23] flagship step launches {read()}, expected {want}")
    for phase in STEP_PHASES:
        print(f"[23] train step phase {phase}, save_chain false: {times[phase]:.2f} ms, peak memory"
              f" {peaks[phase] / 2**30:.2f} GiB (budget {REC_STEP_PEAK_GIB} GiB); phase 9's saved chain"
              f" {step_ms[phase]:.2f} ms, {step_peaks[phase] / 2**30:.2f} GiB ({card})", flush=True)
    print(f"[23] {steps} steps: launches {read()} (2 forward + 2 recompute backward a step), chain rebuilds"
          f" {rt.rebuild_launches} (one a slab of each backward)", flush=True)
    check(rt.rebuild_launches >= 2 * steps, "[23] the recompute backward did not rebuild its chain")
    check(max(peaks.values()) <= REC_STEP_PEAK_GIB * 2**30,
          f"[23] the memory-saving step peaks above {REC_STEP_PEAK_GIB} GiB: {peaks}")

    # (2) the prefetcher on a host memmap store, against the device-resident store, phase 1
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        host = write_ray_store(tmp, STREAM_RAYS, n_images, (256, 256))
        nbytes = sum(a.nbytes for a in host.values())
        print(f"[23] host ray store: {STREAM_RAYS} rays, {nbytes / 2**30:.2f} GiB of memmapped .npy written in"
              f" {time.perf_counter() - t0:.1f} s", flush=True)
        rng = np.random.RandomState(1)
        gms = []
        for _ in range(STREAM_STEPS):
            idx = np.sort(rng.randint(0, STREAM_RAYS, TRAIN_RAYS))
            t0 = time.perf_counter()
            prefetch.gather(host, idx)
            gms.append((time.perf_counter() - t0) * 1e3)
        state = state._replace(step=int(PHASE_PROGRESS[1] * MAX_STEPS))
        state, _ = step(state, scene, store, 1)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STREAM_STEPS):
            state, _ = step(state, scene, store, 1)
        torch.cuda.synchronize()
        dev_rps = STREAM_STEPS * TRAIN_RAYS / (time.perf_counter() - t0)
        pf = prefetch.BatchPrefetcher(host, TRAIN_RAYS, dev, seed=0)
        try:
            state, _ = batch_step(state, scene, next(pf), 1)  # warm-up
            torch.cuda.synchronize()
            waits = []
            t0 = time.perf_counter()
            for _ in range(STREAM_STEPS):
                tw = time.perf_counter()
                batch = next(pf)
                waits.append((time.perf_counter() - tw) * 1e3)
                state, _ = batch_step(state, scene, batch, 1)
            torch.cuda.synchronize()
            stream_rps = STREAM_STEPS * TRAIN_RAYS / (time.perf_counter() - t0)
        finally:
            pf.close()
    p50, p95 = np.percentile(waits, 50), np.percentile(waits, 95)
    print(f"[23] prefetcher: gather {np.median(gms):.2f} ms per {TRAIN_RAYS}-ray batch (median of {STREAM_STEPS};"
          f" min {min(gms):.2f}, max {max(gms):.2f}; host clock); the step's wait for its batch p50 {p50:.3f} ms,"
          f" p95 {p95:.3f} ms against a {times[1]:.2f} ms phase-1 step; {STREAM_STEPS} phase-1 steps: streaming"
          f" {stream_rps:.0f} rays/s, device-resident store {dev_rps:.0f} rays/s ({card})", flush=True)
    check(stream_rps > 0.5 * dev_rps, "[23] the streaming store halves the step rate")
    del store, scene, state
    torch.cuda.empty_cache()

    # (3) cli.train, and (4) cli.tto + cli.eval on its checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        root, name = os.path.join(tmp, "scene"), "scene"
        write_train_scene(root, name)
        argv = ["--config", "configs/brandenburg_gate.yaml", "--device", "cuda", "root_dir", root, "scene_name", name,
                "feat_dir", os.path.join(root, "DINO"), "depth_dir", os.path.join(root, "DPT"),
                "out_dir", os.path.join(tmp, "out"), "max_steps", "12", "val.log_interval", "6",
                "train.ckpt_interval", "6", "train.log_pose_interval", "6", "val.img_idx", "[0]",
                "phototourism.use_cache", "False", "seed", "0", "exp_name", "memsave",
                "tpu.save_chain", "false", "tpu.store_on_device", "false"]
        # 12 steps x 2 passes with residuals and backward; a val render of 1 chunk x 2 passes at steps 6 and 12
        want_train = dict(none, rec_fwd=2 * 12, rec_bwd=2 * 12, render_fwd=2 * 2)
        tr = _run_train(argv, "23", zero, read, want_train)
        check(tr.store is None and tr.prefetcher is None and not tr.cfg.render.save_chain,
              "[23] the run did not stream its store through the prefetcher in the recompute mode")
        ckpt = tr.ckpt.path(tr.ckpt.latest_step())
        hp = dict(tr.hp, exp_name="loop", max_steps=MAX_STEPS)
        hp.update({"val.log_interval": 10**9, "train.ckpt_interval": 10**9, "train.log_pose_interval": 0})
        tl = Trainer(hp, device=dev)
        tl.fit(log_every=4, max_steps=12)
        with open(os.path.join(tl.save_dir, "metrics.jsonl")) as f:
            rps = [json.loads(line)["rays_per_sec"] for line in f if "rays_per_sec" in line]
        print(f"[23] the loop's rays/s, streaming + recompute, phase 0 (windows of 4 steps, host clock):"
              f" {[round(r) for r in rps]}; the bare phase-0 step {times[0]:.2f} ms ="
              f" {TRAIN_RAYS / times[0] * 1e3:.0f} rays/s ({card})", flush=True)

        result_dir = os.path.join(tmp, "result")
        zero()
        t0 = time.perf_counter()
        metrics_path = tto_cli.main(["--ckpt", ckpt, "--result_dir", result_dir, "--group_size", "2", "--batch_size",
                                     "1024", "--pose_epochs", "1", "--appearance_epochs", "1", "--device", "cuda"])
        torch.cuda.synchronize()
        got = read()
        w, h = TTO_PNG_WH[0] // 2, TTO_PNG_WH[1] // 2
        steps_a = -(-w * h // 1024)  # the pose epoch's steps; the appearance epoch takes max(1, steps_a // 2)
        steps_b = max(1, steps_a // 2)
        # a step renders 2 passes, and the fine pass's backward runs; the coarse pass keeps residuals only where
        # its input requires grad (the pose steps'); an eval chunk (one an epoch) renders 2 passes without them
        want_tto = dict(none, rec_fwd=2 * steps_a + steps_b, rec_frozen=steps_a + steps_b, render_fwd=steps_b + 2 * 2)
        print(f"[23] tto on the save_chain-false checkpoint, {steps_a + steps_b} steps in"
              f" {time.perf_counter() - t0:.1f} s: launches {got} (expected {want_tto}: 2 forwards + 1 frozen"
              " recompute backward a step, 2 forwards an eval chunk)", flush=True)
        check(got == want_tto, f"[23] TTO launches {got}, expected {want_tto}")
        with open(metrics_path) as f:
            m = json.load(f)
        check(len(m) == 2 and all(np.isfinite(v["psnr"]) and np.isfinite(v["ssim"]) for v in m.values()),
              f"[23] TTO metrics {m}")
        ev = eval_cli.main(["--ckpt", ckpt, "--result_dir", result_dir, "--device", "cuda"])
        check(all(np.isfinite(v) for v in ev.values()), f"[23] eval printed non-finite numbers: {ev}")
        print(f"[23] eval: {ev}", flush=True)
        Ks = np.stack([tr.meta.Ks[i] for i in tr.meta.img_ids_train[:TTO_TEST]])
        poses = torch.from_numpy(ring_poses(TTO_TEST).astype(np.float32))
        rec_tto_ms, _, peak, _ = time_tto(ckpt, Ks, poses, dev)
        print(f"[23] TTO step ({TTO_TEST} x 1024 rays, phase A), save_chain false: {rec_tto_ms:.2f} ms, peak memory"
              f" {peak:.2f} GiB; phase 13's saved chain {tto_ms:.2f} ms ({card})", flush=True)
    return {"train": want_train, "tto": want_tto}, times, rec_tto_ms


X0_ODD_IN0 = 40  # phase 24's x0 width that is not 3 + 6L
# The probe's bf16 chains against their plain versions (phase 25). One layer
# (L = 1): the same roundings of the same f32 sums of exact bf16 products, taken
# in another order. In pure an output differs only where its f32 sum lies within
# the sums' rounding (~1e-7 relative) of a bf16 rounding boundary, and then by
# one bf16 ulp, or, where the sum cancels to near zero, by the sums' own
# rounding (TOL["float32"] of the max value): PROBE_FLIP_SHARE bounds the share
# of such outputs (1.5e-4 measured on the card). epi's f32 outputs differ by
# the sums' rounding (TOL["float32"] of the max). 16 layers: a flipped value moves the next layer's sums by ~w 2^-8 of
# itself, far above their rounding, and so flips more of them, down the chain:
# the chains' RMS distance reached 2.6e-3 of the RMS in pure (measured on the
# card; 1e-3 at L = 6), against the ~9.4e-3 that both are from the f32 chain, in
# which no operand is rounded. PROBE_RMS_TOL bounds the distance; a kernel that
# skipped a rounding would be about as far from the plain chain as from the f32
# chain, and PROBE_RMS_RATIO bounds that share. The int8 chain is exact.
PROBE_FLIP_SHARE = 1e-3
PROBE_RMS_TOL = 1e-2
PROBE_RMS_RATIO = 0.5
PROBE_SHAPE = (2048, 256, 16, 64)  # M, W, L, copies: scripts/bench_mxu_probe.py's defaults
# Phase 24's weight gradients against the plain backward, max |d| over max |g|
# per leaf, in both save_chain modes. The recompute mode flips ReLU masks as
# phase 22 does (REC_DW_TOL). With the saved chain nothing flips, but phase 24
# sums over 1M samples of random-signed cotangents: a (1,) bias gradient such
# as sigma_b is one sum that cancels to a small share of its terms, and the
# kernel accumulated it as 32,768 tile sums in another order than the plain
# version's; in f32 its rounding reached 4.2e-4 of the sum (F = 384, phase 0,
# measured on the card, when the f32 walk still added it with atomics), over
# BWD_TOL.
X0_DW_TOL = REC_DW_TOL


def x0_mode_args(field, inputs, st, in0: int = 0, seed: int = 0):
    """Kernel 1b's arguments (x0, z, ray_cond, trunk, heads, st) and c_emb for
    mode st: the PE rows of the chunk's rays, or (in0 > 0) seeded rows of
    width in0 with the trunk's x0 rows cut to it (layer 0 and the skips)."""
    from upnerf_torch.ops import render_train as rt

    args, c_emb = mode_args(field, inputs, st)
    o, d, z, pe_w, cond, trunk, heads, _ = args
    x0 = rt._pe(o, d, z, pe_w, st.xyz_L)[0].contiguous()
    if in0:
        g = torch.Generator(device=x0.device).manual_seed(seed)
        x0 = torch.randn((x0.shape[0], in0), generator=g, device=x0.device) * 0.5
        full = 3 + 6 * st.xyz_L
        trunk = [(w[:in0].contiguous() if i == 0 else torch.cat([w[:in0], w[full:]]) if i in st.skips else w, b)
                 for i, (w, b) in enumerate(trunk)]
    return (x0, z, cond, trunk, heads, st._replace(xyz_L=0)), c_emb


def plain_x0_bwd_chunked(args, c_emb, res, cots, dtype=torch.float32, rays: int = 1024):
    """render_train_bwd_plain over chunks of rays (bounded memory), in dtype:
    d_x0 and the per-ray outputs concatenated, weight gradients summed."""
    from upnerf_torch.ops import render_train as rt

    x0, z, cond, trunk, heads, st = args
    cv = lambda t: None if t is None else t.to(dtype)  # noqa: E731
    R, S = z.shape
    parts = []
    for r0 in range(0, R, rays):
        r, m = slice(r0, r0 + rays), slice(r0 * S, (r0 + rays) * S)
        rres = {k: cv(v[r] if k in ("sig_s", "sig_c") else v[m]) for k, v in res.items()}
        parts.append(rt.render_train_bwd_plain(
            cv(x0[m]), cv(z[r]), cv(None if cond is None else cond[r]), [(cv(w), cv(b)) for w, b in trunk],
            {k: cv(v) for k, v in heads.items()}, st._replace(precision="float32") if dtype == torch.float64 else st,
            cv(None if c_emb is None else c_emb[r]), rres, {k: cv(v[r]) for k, v in cots.items()}))
    out = [None if parts[0][i] is None else torch.cat([p[i] for p in parts]) for i in range(3)]
    if not st.param_grads:
        return (*out, None, None)
    dtrunk = [(sum(p[3][i][0] for p in parts), sum(p[3][i][1] for p in parts)) for i in range(len(trunk))]
    return (*out, dtrunk, {k: sum(p[4][k] for p in parts) for k in parts[0][4]})


def phase_x0_kernels(fields, dev, card: str):
    """Phase 24: kernel 1b, the fused render from PE rows (ops/render_train.py:
    render_train_fwd / render_train_bwd, the X0_IN mode of both kernels), at
    4096 rays x 256 samples, F = 384 and 32, bf16 and f32, phases 0, 1, 2, the
    saved chain and the recompute mode, on the PE rows of seeded rays (in0 =
    63), and at F = 384 phase 1 on rows of width X0_ODD_IN0. Per case: the
    forward with residuals against its plain version (outputs at TOL,
    residuals at TOL / CHAIN_TOL) and, on the PE rows, against the rays mode's
    kernel; the backward's train and frozen modes against the plain backward:
    the data cotangents d_x0, d_ray_cond, d_c_emb at BWD_TOL by the max on
    the saved chain, by RMS in the recompute mode (ReLU masks flip against
    the plain recompute, as in phase 22); the weight gradients at X0_DW_TOL;
    in the recompute mode all of them also by the float64 witness (printed for
    the saved chain); the frozen mode's data cotangents equal to the train
    mode's bit for bit. Then, at F = 384 bf16 phase 1 with
    the saved chain, in turns: each kernel against the rays mode's and the plain version, per
    4096 x 256 chunk and at the benchmark's 2048 x 384; and
    `upnerf_torch.scripts.bench_render_train_kernel` at its defaults with 3
    steps, launches counted. Returns ({"fwd", "bwd"}: (ms, plain ms, rays ms),
    worst forward max |d|, worst backward max |d| on the saved chain, the
    script's launches and results)."""
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.scripts import bench_render_train_kernel as bench

    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    worst_f = worst_b = 0.0
    cases = [(fi, prec, phase, chain, 0) for fi in range(len(fields)) for prec in ("bfloat16", "float32")
             for phase in (0, 1, 2) for chain in (True, False)]
    cases += [(0, prec, 1, chain, X0_ODD_IN0) for prec in ("bfloat16", "float32") for chain in (True, False)]
    inputs = {}
    for fi, prec, phase, save_chain, in0 in cases:
        field, nerf_cfg = fields[fi]
        F = nerf_cfg.feat_dim
        if fi not in inputs:
            inputs = {fi: chunk_inputs(field, 256, seed=240 + F, dev=dev, R=CHUNK)}
        rays_st = train_static(nerf_cfg, prec, phase)._replace(save_chain=save_chain)
        args, c_emb = x0_mode_args(field, inputs[fi], rays_st, in0, seed=24)
        st = args[-1]
        with torch.no_grad():
            got, got_res = rt.render_train_fwd(*args, c_emb=c_emb, save_res=True)
            want, want_res = rt.render_train_plain(*args, c_emb=c_emb, save_res=True)
            rays = None if in0 else rt.render_train_rays_fwd(*mode_args(field, inputs[fi], rays_st)[0],
                                                             c_emb=c_emb)
            g = torch.Generator(device=dev).manual_seed(24 + phase)
            cots = {k: torch.randn(want[k].shape, generator=g, device=dev) for k in st.out_keys}
            kb = rt.render_train_bwd(*args[:5], st, c_emb, got_res, cots)
            kz = rt.render_train_bwd(*args[:5], st._replace(param_grads=False), c_emb, got_res, cots)
            pb = plain_x0_bwd_chunked(args, c_emb, got_res, cots)
            p64 = plain_x0_bwd_chunked(args, c_emb, got_res, cots, torch.float64)
        torch.cuda.synchronize()
        check(tuple(got_res) == st.res_keys, f"[24] residuals {tuple(got_res)}, expected {st.res_keys}")
        ef, er = {}, {}
        for k in st.out_keys:
            check(bool(torch.isfinite(got[k]).all()), f"[24] forward {k} not finite")
            for name, ref in (("plain", want), ("rays", rays)):
                if ref is not None:
                    diff = (got[k] - ref[k]).abs()
                    ef[f"{k} vs {name}"] = ((diff / ref[k].abs().clamp(min=1e-6)).max().item() if "depth" in k
                                            else diff.max().item())
        for k in st.res_keys:
            er[k] = rel_err(got_res[k], want_res[k])
        worst_f = max([worst_f] + [v for k, v in ef.items() if "depth" not in k])
        names = ["x0", "ray_cond", "c_emb"]
        rows = [(n, i) for i, n in enumerate(names) if pb[i] is not None]
        same = {n: torch.equal(kz[i], kb[i]) for n, i in rows}
        check(kz[3] is None and kz[4] is None and kb[0].shape == args[0].shape, "[24] backward outputs")
        leaves = {}
        for i, ((kw_, kbb), (pw_, pbb), (qw_, qbb)) in enumerate(zip(kb[3], pb[3], p64[3])):
            leaves[f"trunk{i}.w"], leaves[f"trunk{i}.b"] = (kw_, pw_, qw_), (kbb, pbb, qbb)
        for k in st.head_keys:
            leaves[k] = (kb[4][k], pb[4][k].reshape(kb[4][k].shape), p64[4][k].reshape(kb[4][k].shape))
        berr = {k: rel_err(a_, p_) for k, (a_, p_, _) in leaves.items()}
        for k, v in berr.items():
            check(np.isfinite(v), f"[24] backward {k} not finite")
        bw = max(berr, key=berr.get)
        d64 = [rms(leaves[bw][i] - leaves[bw][2]) / max(rms(leaves[bw][2]), 1e-30) for i in (0, 1)]
        row_err = {n: rel_err(kb[i], pb[i]) for n, i in rows}
        row_rms = {n: rms(kb[i] - pb[i]) / rms(pb[i]) for n, i in rows}
        w64 = {n: rms(kb[i] - p64[i]) / max(rms(pb[i] - p64[i]), 1e-30) for n, i in rows}
        flat = lambda b: torch.cat([t.double().flatten() for wb in b[3] for t in wb]  # noqa: E731
                                   + [b[4][k].double().flatten() for k in st.head_keys])
        w64["dW"] = rms(flat(kb) - flat(p64)) / rms(flat(pb) - flat(p64))
        tag = f"[24] F={F} in0={in0 or 3 + 6 * nerf_cfg.xyz_L} {prec} phase {phase} {'chain' if save_chain else 'recompute'}"
        print(f"{tag}: forward worst {max(ef.values()):.3e} (tol {TOL[prec]:.0e}), residuals "
              + " ".join(f"{k} {v:.2e}" for k, v in er.items()) + "; backward max |d| / max |g| "
              + " ".join(f"{k} {v:.2e}" for k, v in row_err.items()) + ", per-row RMS "
              + " ".join(f"{k} {v:.2e}" for k, v in row_rms.items()) + ", float64 witness kernel / plain "
              + " ".join(f"{k} {v:.3f}" for k, v in w64.items()) + f" (limit {HEADS_F64_RATIO}), dW worst {bw}"
              f" {berr[bw]:.3e} (tol {X0_DW_TOL[prec]:.0e}; RMS to float64 kernel {d64[0]:.2e}, plain {d64[1]:.2e});"
              f" frozen == train {same}", flush=True)
        check(max(ef.values()) <= TOL[prec], f"{tag}: the forward disagrees: {ef}")
        check(all(v <= (CHAIN_TOL if k in ("chain", "feat", "cfeat") else TOL)[prec] for k, v in er.items()),
              f"{tag}: the residuals disagree: {er}")
        check(all(same.values()), f"{tag}: the frozen mode differs from the train mode: {same}")
        check(berr[bw] <= X0_DW_TOL[prec], f"{tag}: the weight gradients disagree: {berr}")
        if save_chain:  # one chain, read by both: no flips, the data cotangents by the max
            check(max(row_err.values()) <= BWD_TOL[prec], f"{tag}: the data cotangents disagree: {row_err}")
            worst_b = max([worst_b] + [(kb[i] - pb[i]).abs().max().item() for _, i in rows])
        else:
            check(max(row_rms.values()) <= HEADS_ROW_RMS_TOL, f"{tag}: the data cotangents disagree: {row_rms}")
            check(max(w64.values()) <= HEADS_F64_RATIO, f"{tag}: further from float64 than the plain version: {w64}")
        del got, got_res, want, want_res, rays, kb, kz, pb, p64
        torch.cuda.empty_cache()

    # timings at F = 384, bf16, phase 1, saved chain, in turns with the rays mode's kernels and the plain versions
    field, nerf_cfg = fields[0]
    times = {}
    for R, S in ((CHUNK, 256), (TRAIN_RAYS, 384)):
        rays_st = train_static(nerf_cfg, "bfloat16", 1)
        inp = chunk_inputs(field, S, seed=9, dev=dev, R=R)
        rargs, c_emb = mode_args(field, inp, rays_st)
        args, _ = x0_mode_args(field, inp, rays_st)
        st = args[-1]
        with torch.no_grad():
            out, res = rt.render_train_fwd(*args, c_emb=c_emb, save_res=True)
            _, rres = rt.render_train_rays_fwd(*rargs, c_emb=c_emb, save_res=True)
            g = torch.Generator(device=dev).manual_seed(3)
            cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out.items()}
            calls = {
                "fwd": (lambda: rt.render_train_fwd(*args, c_emb=c_emb, save_res=True),
                        lambda: rt.render_train_rays_fwd(*rargs, c_emb=c_emb, save_res=True),
                        lambda: rt.render_train_plain(*args, c_emb=c_emb, save_res=True)),
                "bwd": (lambda: rt.render_train_bwd(*args[:5], st, c_emb, res, cots),
                        lambda: rt.render_train_rays_bwd(*rargs[:7], rays_st, c_emb, rres, cots),
                        lambda: plain_x0_bwd_chunked(args, c_emb, res, cots)),
            }
            for name, (kern, rays_k, plain) in calls.items():
                r1, k1, k2, r2 = cuda_ms(rays_k, 2), cuda_ms(kern, 2), cuda_ms(kern, 2), cuda_ms(rays_k, 2)
                p1 = cuda_ms(plain, 1)
                times[(name, R, S)] = ((k1 + k2) / 2, p1, (r1 + r2) / 2)
                print(f"[24] x0 {name} F={nerf_cfg.feat_dim}, {R} x {S}, phase 1, bfloat16, saved chain: kernel"
                      f" {times[(name, R, S)][0]:.2f} ms ({k1:.2f}, {k2:.2f}), rays mode {times[(name, R, S)][2]:.2f} ms"
                      f" ({r1:.2f}, {r2:.2f}), plain {p1:.2f} ms ({card})", flush=True)
        del out, res, rres, cots, calls
        torch.cuda.empty_cache()

    # the benchmark script at its defaults (2048 rays x 384 samples, bf16, the recompute mode), 3 steps
    zero, read = _launch_counters()
    zero()
    result = bench.main(["--steps", "3"])
    torch.cuda.synchronize()
    got = read()
    want = dict({k: 0 for k in got}, x0_fwd=4, x0_bwd=4)
    print(f"[24] bench_render_train_kernel: launches {got} (expected {want}); {result}", flush=True)
    check(got == want, f"[24] the benchmark's launches {got}, expected {want}")
    # the kernels' recompute against autograd's: ReLU masks flip between the two orders, so d_x0 by RMS
    check(result["loss_rel"] <= 1e-3 and result["dx0_rms"] <= HEADS_ROW_RMS_TOL,
          f"[24] the benchmark's routes disagree: {result}")
    torch.cuda.empty_cache()
    return times, worst_f, worst_b, got, result


def probe_bound(M: int, W: int, L: int, copies: int, chain: str):
    """bound() of one probe call: 2 M W^2 L copies operations at the tensor
    cores' peak for the chain's type (the epilogues' f32 operations run on
    other units in parallel and take less time: they do not raise it); x read
    once, the packed weights (and the epi bias) read once, the output written
    once."""
    dtype = "int8" if chain == "int8" else "bfloat16"
    nbytes = 4 * M * W * 2 + L * W * W * (1 if chain == "int8" else 2) + (4 * W if chain == "epi" else 0)
    return bound(2.0 * M * W * W * L * copies, nbytes, dtype)


def phase_mxu_probe(dev, card: str):
    """Phase 25: the matrix-unit probe (ops/mxu_probe.py, csrc/mxu_probe.cu) at
    the JAX probe's shapes (M 2048, W 256, L 16, 64 copies): each chain's
    kernel against its plain version (int8 bit for bit; bf16 by RMS at
    PROBE_RMS_TOL, and under PROBE_RMS_RATIO of its RMS distance to the f32
    chain; one layer of each bf16 chain by PROBE_FLIP_SHARE / TOL), then
    `upnerf_torch.scripts.bench_mxu_probe` at its defaults (launches counted). Returns ({chain: max |d|}, the script's launches and
    results)."""
    from upnerf_torch.ops import mxu_probe as mp
    from upnerf_torch.scripts import bench_mxu_probe as bench

    M, W, L, G = PROBE_SHAPE
    x, ws, b, ws_i8 = (torch.from_numpy(a).to(dev) for a in mp.probe_inputs(M, W, L, seed=0))
    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    errs = {}
    with torch.no_grad():
        for chain in ("pure", "epi"):  # one layer: bit for bit but for rare one-ulp flips
            got, want = mp.mxu_probe(x, ws[:1], b, chain, G), mp.mxu_probe_plain(x, ws[:1], b, chain)
            torch.cuda.synchronize()
            d = (got - want).abs()
            if chain == "pure":
                ulp = torch.ldexp(torch.ones_like(want), torch.floor(torch.log2(want.abs().clamp(min=1e-30))).int() - 7)
                share = (d > 0).float().mean().item()
                big = d > ulp  # sums that cancel: their f32 rounding is more than an ulp of the value
                sums = TOL["float32"] * want.abs().max().item()
                far = d[big].max().item() if bool(big.any()) else 0.0
                print(f"[25] {chain}, one layer: {share:.2e} of the outputs differ (limit {PROBE_FLIP_SHARE:.0e}); beyond"
                      f" one bf16 ulp {int(big.sum())}, by at most {far:.2e} at |value| <="
                      f" {want.abs()[big].max().item() if bool(big.any()) else 0.0:.2e} (limit {sums:.2e}: the sums'"
                      f" rounding)", flush=True)
                check(share <= PROBE_FLIP_SHARE and far <= sums, f"[25] one pure layer disagrees: {share} {far}")
            else:
                e = d.max().item() / want.abs().max().item()
                print(f"[25] {chain}, one layer: max |d| / max |value| {e:.2e} (tol {TOL['float32']:.0e})", flush=True)
                check(e <= TOL["float32"], f"[25] one epi layer disagrees: {e}")
        for chain in mp.CHAINS:
            w = ws_i8 if chain == "int8" else ws
            got = mp.mxu_probe(x, w, b, chain, G)
            want = mp.mxu_probe_plain(x, w, b, chain)
            torch.cuda.synchronize()
            check(got.shape == (M, W) and bool(torch.isfinite(got).all()), f"[25] {chain}: output not finite")
            errs[chain] = (got - want).abs().max().item()
            if chain == "int8":
                print(f"[25] {chain}: kernel == plain bit for bit: {torch.equal(got, want)}; nonzero share"
                      f" {(want != 0).float().mean().item():.3f}", flush=True)
                check(torch.equal(got, want), f"[25] the int8 chain differs from its plain version ({errs[chain]})")
                continue
            h = x
            for wi in ws:
                h = h @ wi if chain == "pure" else torch.relu(h @ wi + b)
            d, d32 = rms(got - want) / rms(want), rms(got - h) / rms(h)
            print(f"[25] {chain}: RMS(kernel - plain) / RMS(plain) {d:.3e} (tol {PROBE_RMS_TOL:.0e}), to the f32"
                  f" chain {d32:.3e} (ratio limit {PROBE_RMS_RATIO}), max |d| {errs[chain]:.3e}, RMS {rms(want):.3e}",
                  flush=True)
            check(d <= PROBE_RMS_TOL and d <= PROBE_RMS_RATIO * d32, f"[25] the {chain} chain disagrees: {d} {d32}")
    zero, read = _launch_counters()
    zero()
    result = bench.main([])
    torch.cuda.synchronize()
    got = read()
    want = dict({k: 0 for k in got}, **{f"probe_{c}": 31 for c in mp.CHAINS})  # a warm-up and 30 steps
    print(f"[25] bench_mxu_probe: launches {got} (expected {want})", flush=True)
    check(got == want, f"[25] the probe's launches {got}, expected {want}")
    for chain in mp.CHAINS:
        bms, by = probe_bound(M, W, L, G, chain)
        print(f"[25] {chain}: {result[chain]['ms']:.3f} ms against a bound of {bms:.3f} ms ({by}); plain"
              f" {result[chain]['plain_ms']:.3f} ms; library products {result[chain]['library_ms']} ms ({card})",
              flush=True)
    with torch.no_grad():
        for chain in mp.CHAINS:
            probe_designs(mp, x, ws_i8 if chain == "int8" else ws, b, chain, card)
    return errs, got, result


def probe_l2_bytes(M: int, L: int, copies: int, chain: str, design: str) -> float:
    """The L2 bytes of one probe call's weight reads: the wgmma design streams
    every layer once per pair of 64-row tiles (the two consumers of a block
    share each strip), the mma.sync design once per tile."""
    tiles = copies * -(-M // 64)
    reads = -(-tiles // 2) if design == "wgmma" else tiles
    return reads * L * 256 * 256 * (1 if chain == "int8" else 2)


def probe_designs(mp, x, w, b, chain: str, card: str, reps: int = 20) -> None:
    """Phase 25's chain in both designs (mxu_probe.PROBE_DESIGNS), each from
    its own packed weights: the mma.sync design against the route's (int8
    bit for bit, bf16 by PROBE_RMS_TOL), then both timed in turns (a, b, b,
    a): ms, rate, share of the bound, the weight reads' L2 bytes and the rate
    they imply."""
    M, W, L, G = PROBE_SHAPE
    rms = lambda t: t.double().pow(2).mean().sqrt().item()  # noqa: E731
    packed = {des: mp.kernel_weights(w, chain, des) for des in mp.PROBE_DESIGNS}
    call = {des: (lambda des=des: mp.mxu_probe_launch(x, w, b, chain, G, packed[des], des)) for des in mp.PROBE_DESIGNS}
    got = {des: call[des]() for des in mp.PROBE_DESIGNS}
    torch.cuda.synchronize()
    base = got[mp.PROBE_DESIGNS[0]]
    for des in mp.PROBE_DESIGNS[1:]:
        if chain == "int8":
            check(torch.equal(got[des], base), f"[25] int8: the {des} design differs from the route's")
        else:
            d = rms(got[des] - base) / rms(base)
            check(d <= PROBE_RMS_TOL, f"[25] {chain}: the {des} design is {d} from the route's")
    del got
    runs = {des: [] for des in mp.PROBE_DESIGNS}
    for des in mp.PROBE_DESIGNS + mp.PROBE_DESIGNS[::-1]:
        runs[des].append(cuda_ms(call[des], reps))
    ms = {des: sum(v) / len(v) for des, v in runs.items()}
    ops = 2.0 * M * W * W * L * G
    unit = "TOPS" if chain == "int8" else "TFLOP/s"
    bms, by = probe_bound(M, W, L, G, chain)
    print(f"[25] {chain}, the designs in turns: " + "; ".join(
        f"{des} {ms[des]:.4f} ms ({' '.join(f'{v:.4f}' for v in runs[des])}; {ops / ms[des] / 1e9:.0f} {unit},"
        f" {bms / ms[des]:.2f} of the bound; L2 weight reads {probe_l2_bytes(M, L, G, chain, des) / 1e9:.3f} GB,"
        f" {probe_l2_bytes(M, L, G, chain, des) / ms[des] / 1e9:.2f} TB/s)" for des in mp.PROBE_DESIGNS)
        + f"; bound {bms:.3f} ms ({by}) ({card})", flush=True)


def flat_tensors(x) -> list:
    """The tensors of a nested result (tuples, lists, dicts; None skipped), in order."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in flat_tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat_tensors(v)]
    return []


def run_twice(fn):
    """(elements that differ, elements, worst max |d| over max |value| of an
    output) between two calls of fn on the same inputs."""
    a, b = flat_tensors(fn()), flat_tensors(fn())
    torch.cuda.synchronize()
    n_diff = sum(int((x != y).sum().item()) for x, y in zip(a, b))
    worst = max([(x.float() - y.float()).abs().max().item() / max(x.float().abs().max().item(), 1e-30)
                 for x, y in zip(a, b)] + [0.0])
    return n_diff, sum(x.numel() for x in a), worst


def phase_run_to_run(field, nerf_cfg, dev):
    """Phase 26: run-to-run bits. Each mode twice on the same inputs (the render
    kernels at 2048 rays x 256 samples, phase 1 unless said; kernels 5 and 6
    at 524,288 rows): how many outputs differ and by how much. Same bits are
    required of every mode in both precisions: the render forward (its
    column sums run in a fixed order) and kernels 5 and 6's forward, every
    backward (no weight gradient is added with atomics: each walk stores its
    operands and the dW kernel sums them in a fixed order, a slab at a time)
    and the frozen mode; and the probe's three chains at phase 25's shapes.
    Returns {mode: (differ, elements, worst)}."""
    from upnerf_torch.models.nerf import positional_encoding
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp
    from upnerf_torch.ops import mxu_probe as mp
    from upnerf_torch.ops import render_train as rt

    out = {}
    inputs = chunk_inputs(field, 256, seed=26, dev=dev, R=TRAIN_RAYS)
    g = torch.Generator(device=dev).manual_seed(26)
    with torch.no_grad():
        for prec in ("bfloat16", "float32"):
            for chain in (True, False):
                st = train_static(nerf_cfg, prec, 1)._replace(save_chain=chain)
                args, c_emb = mode_args(field, inputs, st)
                name = f"forward {prec} " + ("saved chain" if chain else "recompute")
                out[name] = run_twice(lambda: rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True))
                o_, res = rt.render_train_rays_fwd(*args, c_emb=c_emb, save_res=True)
                cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in o_.items()}
                kind = "train" if chain else "recompute train"
                out[f"backward {prec} {kind}"] = run_twice(
                    lambda: rt.render_train_rays_bwd(*args[:7], st, c_emb, res, cots))
                del res
            st2 = train_static(nerf_cfg, prec, 2)._replace(param_grads=False)
            args, _ = mode_args(field, inputs, st2)
            o_, res = rt.render_train_rays_fwd(*args, save_res=True)
            cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in o_.items()}
            out[f"backward {prec} frozen (phase 2)"] = run_twice(lambda: rt.render_train_rays_bwd(*args[:7], st2, None,
                                                                                                  res, cots))
            del res
            n = TRAIN_RAYS * 256
            x0 = positional_encoding(torch.randn((n, 3), generator=g, device=dev), nerf_cfg.xyz_L).contiguous()
            c_emb = torch.randn((n, nerf_cfg.candidate_dim), generator=g, device=dev)
            trunk, heads = field.trunk_heads_weights(True)
            hcots = [torch.randn(t.shape, generator=g, device=dev)
                     for t in hk.fused_trunk_heads_fwd(x0, c_emb, trunk, heads, nerf_cfg.skips, prec)]
            out[f"kernel 5 forward {prec}"] = run_twice(
                lambda: hk.fused_trunk_heads_fwd(x0, c_emb, trunk, heads, nerf_cfg.skips, prec))
            out[f"kernel 6 forward {prec}"] = run_twice(
                lambda: mlp.fused_trunk_fwd(x0, field.trunk_weights(), nerf_cfg.skips, prec))
            out[f"kernel 5 backward {prec}"] = run_twice(
                lambda: hk.fused_trunk_heads_bwd(x0, c_emb, trunk, heads, nerf_cfg.skips, prec, hcots))
            tcot = torch.randn((n, nerf_cfg.W), generator=g, device=dev)
            out[f"kernel 6 backward {prec}"] = run_twice(
                lambda: mlp.fused_trunk_bwd(x0, field.trunk_weights(), nerf_cfg.skips, prec, tcot))
            torch.cuda.empty_cache()
        M, W, L, G = PROBE_SHAPE
        px, pws, pb, pws_i8 = (torch.from_numpy(a).to(dev) for a in mp.probe_inputs(M, W, L, seed=26))
        for chain in mp.CHAINS:
            w = pws_i8 if chain == "int8" else pws
            out[f"probe {chain}"] = run_twice(lambda: mp.mxu_probe(px, w, pb, chain, G))
    for name, (n_diff, n_el, worst) in out.items():
        print(f"[26] {name}: {n_diff} of {n_el} outputs differ between two calls, worst {worst:.3e} of an output's"
              f" max", flush=True)
    for name, (n_diff, n_el, _) in out.items():
        check(n_el > 0 and n_diff == 0, f"[26] {name}: two calls differ")
    return out


# Phase 27: the pose-warp mitigations and the optimizer kinds at brandenburg_gate's width. The scorer renders
# SCORE_KICKS + 2 candidates x SCORE_RAYS rays of one flagged image (of WARP_WH pixels, feature map at pixel
# resolution) in phase 0 at PE progress SCORE_PROGRESS, as pose.warp's defaults say.
SCORE_RAYS, SCORE_KICKS, SCORE_PROGRESS, WARP_WH, WARP_FOCAL = 1024, 8, 0.5, (64, 48), 50.0
WARPED_ROW = (0.06, -0.05, 0.04, 0.12, -0.08, 0.1)  # the flagged image's incumbent se3 refinement
# Phase 27's train runs: cli.train reads the metrics back, and checks the warp detector, every 100 steps and at the
# last, so 102 steps give the event at step 100 and a step after it to check; a val render at 51 and 102.
WARP_RUN = ["max_steps", "102", "val.log_interval", "51", "train.ckpt_interval", "51", "train.log_pose_interval", "51"]
WARP_STEPS, WARP_EVENT_STEP, WARP_VALS = 102, 100, 2
# The hair-trigger detector of tests/test_warp.py: every check flags the images above the median, one event.
HAIR_TRIGGER = ["pose.warp.ratio", "1.0001", "pose.warp.patience", "1", "pose.warp.decay", "0.0",
                "pose.warp.min_progress", "0.0", "pose.warp.max_progress", "1.0", "pose.warp.max_events", "1",
                "pose.warp.cooldown", "1"]


def score_tol(scores: torch.Tensor, feat_max: float) -> torch.Tensor:
    """Phase 27's bound on |kernel score - plain score| of each candidate. The
    forward kernel meets its plain version within TOL["float32"] of the largest
    output (phases 5, 9): |d f| <= e = TOL * max |f|. A score is s = mean((f -
    t)^2), so |d s| = |mean(2 (f - t) d f + d f^2)| <= 2 sqrt(s) e + e^2
    (Cauchy-Schwarz)."""
    e = TOL["float32"] * feat_max
    return 2.0 * scores.clamp_min(0).sqrt() * e + e * e


class _ScorerRoute:
    """Phase 27 (a)'s routes of the scorer on the card: with plain=True kernel
    1's forward is replaced by its plain version (tpu.fused_train on) and the
    fields' trunk + heads by theirs (off: the tpu.fused_trunk false route).
    Either way records max |feat| of the rendered candidates."""

    def __init__(self, model, plain: bool):
        from upnerf_torch.ops import render_train as rt
        from upnerf_torch.train import warp

        self.rt, self.warp, self.model, self.plain, self.feat_max = rt, warp, model, plain, 0.0
        self.fields = [model.nerf_coarse, model.nerf_fine]

    def __enter__(self):
        self.saved = (self.rt.render_train_rays_fwd, self.warp.render_rays, [f.cfg for f in self.fields])
        render = self.saved[1]

        def spied(*args, **kw):
            out = render(*args, **kw)
            self.feat_max = max(self.feat_max, float(out["feat_fine"].abs().max()))
            return out

        self.warp.render_rays = spied
        if self.plain:
            self.rt.render_train_rays_fwd = self.rt.render_train_rays_plain
            for f in self.fields:
                f.cfg = f.cfg._replace(fused_trunk=False)
        return self

    def __exit__(self, *exc):
        self.rt.render_train_rays_fwd, self.warp.render_rays, cfgs = self.saved
        for f, c in zip(self.fields, cfgs):
            f.cfg = c


def warp_scorer_world(dev, precision=None):
    """(StepConfig, model, scene, pixels, candidates) of phase 27 (a):
    brandenburg_gate's config (at `precision`, else its own), a seeded model of 4 images on a
    ring, random unit feature maps at pixel resolution except image 0's, which
    is the model's own render from its base pose (so the base pose is the
    scores' optimum), and image 0's candidates around the incumbent WARPED_ROW,
    drawn as run_multistart draws them."""
    from upnerf_torch.config import get_from_path
    from upnerf_torch.geometry import rays as ray_utils
    from upnerf_torch.render.render_rays import render_rays
    from upnerf_torch.train import StepConfig, init_params, make_scene_constants, warp

    hp = get_from_path("configs/brandenburg_gate.yaml")
    hp["tpu.matmul_precision"] = precision or hp["tpu.matmul_precision"]
    cfg = StepConfig.from_hparams(hp)
    n, (w, h) = 4, WARP_WH
    model = init_params(cfg.nerf, cfg.transient, n, generator=torch.Generator().manual_seed(27)).to(dev)
    model.requires_grad_(False)
    K = np.array([[WARP_FOCAL, 0, w / 2], [0, WARP_FOCAL, h / 2], [0, 0, 1]], np.float32)
    poses = ring_poses(n).astype(np.float32)
    rng = np.random.RandomState(27)
    maps = rng.randn(n, h, w, cfg.nerf.feat_dim).astype(np.float32)
    maps /= np.linalg.norm(maps, axis=-1, keepdims=True)
    scene = make_scene_constants(np.broadcast_to(K, (n, 3, 3)), poses, np.tile([[0.1, 5.0]], (n, 1)),
                                 np.tile([[w, h]], (n, 1)), maps, dev, feat_dtype=torch.float32)
    jj, ii = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev), indexing="ij")
    dirs = ray_utils.pixel_directions(ii.reshape(-1), jj.reshape(-1), scene.Ks[0])
    rays_o, rays_d = ray_utils.get_rays(dirs, scene.poses[0])
    rays = torch.cat([rays_o, rays_d, scene.near_far[0].expand(w * h, 2)], -1)
    with torch.no_grad():
        out = render_rays(model.render_params(), cfg.render._replace(perturb=0.0), rays,
                          torch.zeros(w * h, dtype=torch.long, device=dev), phase=0, sched_mult=0.0,
                          progress=SCORE_PROGRESS, det=True)
    scene.feat_maps[0] = out["feat_fine"].float().reshape(h, w, -1)
    px = np.floor(rng.rand(SCORE_RAYS) * w).clip(0, w - 1).astype(np.float32)
    py = np.floor(rng.rand(SCORE_RAYS) * h).clip(0, h - 1).astype(np.float32)
    cands = warp.propose_candidates(np.asarray(WARPED_ROW, np.float32), warp.WarpConfig(kicks=SCORE_KICKS), rng)
    return cfg, model, scene, px, py, cands


def phase_warp(dev, card: str):
    """Phase 27: the pose-warp mitigations and the optimizer kinds at
    brandenburg_gate's width.

    (a) The candidate scorer (train.warp.make_pose_scorer: 10 candidates x 1024
    rays in one render call, phase 0, no_grad) on warp_scorer_world's image 0,
    whose incumbent is warped: with tpu.fused_train on (kernel 1's forward) and
    off (kernel 5's forward), f32, each route's scores against its plain
    route's on the card within score_tol; the argmin
    the same wherever the best two differ by more than that; the base pose
    first. Then ms of a scorer call at the config's bf16, each route, and the
    call's peak memory.
    (b) cli.train with pose.warp.mitigate multistart and the hair-trigger
    detector on phase 18's scene, WARP_RUN's 102 steps, default flags and
    tpu.fused_train false: one event, at step 100, the budget spent, the
    adopted rows' Adam moments exactly zero right after it, finite losses
    after it, and the launches (2 + 2 a step, 2 a val render, and 2 of the
    scorer's kernel a flagged image).
    (c) The same with reset: the flagged se3 rows exactly zero at the event.
    (d) optimizer.type adamw with scheduler.type cosine, and optimizer_pose.type
    sgd with a constant schedule: finite losses, every logged LR its closed
    form (in double) within 4 float32 ulps of the base LR. Returns {kernel: launches} of (b) and (c)'s runs."""
    import math

    from upnerf_torch.cli import train as train_cli
    from upnerf_torch.train import warp
    from upnerf_torch.train.loop import Trainer

    zero, read = _launch_counters()
    none = {k: 0 for k in read()}

    # (a) the scorer: kernel routes against plain routes, f32, then timed at bf16
    cfg, model, scene, px, py, cands = warp_scorer_world(dev, "float32")
    for fused in (True, False):
        route = "kernel 1's forward" if fused else "kernel 5's forward"
        c = cfg._replace(render=cfg.render._replace(fused_train=fused))
        score = warp.make_pose_scorer(c, SCORE_RAYS, SCORE_PROGRESS)
        with _ScorerRoute(model, plain=False) as k_spy:
            got = score(model, scene, 0, px, py, cands)
        with _ScorerRoute(model, plain=True) as p_spy:
            want = score(model, scene, 0, px, py, cands)
        torch.cuda.synchronize()
        feat_max = max(k_spy.feat_max, p_spy.feat_max)
        tol = score_tol(want, feat_max)
        d = (got - want).abs()
        print(f"[27a] scorer, tpu.fused_train {fused} ({route}), f32, {len(cands)} candidates x {SCORE_RAYS} rays:"
              f" kernel {[f'{v:.6g}' for v in got.tolist()]}, plain {[f'{v:.6g}' for v in want.tolist()]};"
              f" max |d| {float(d.max()):.3e}, largest d / tol {float((d / tol).max()):.3f} (tol 2 sqrt(s) e + e^2,"
              f" e = {TOL['float32']:.0e} x max |feat| {feat_max:.3f})", flush=True)
        check(bool(torch.isfinite(got).all()) and bool((d <= tol).all()), f"[27a] scores differ beyond tol: {d}")
        top2 = torch.topk(want, 2, largest=False)
        if float(top2.values[1] - top2.values[0]) > float(tol[top2.indices[0]] + tol[top2.indices[1]]):
            check(int(got.argmin()) == int(want.argmin()), "[27a] the two routes pick different candidates")
        check(int(got.argmin()) == 1, f"[27a] the base pose (candidate 1) did not rank first: argmin {int(got.argmin())}")
    cfg16, model16, scene16, px, py, cands = warp_scorer_world(dev)
    for fused in (True, False):
        c = cfg16._replace(render=cfg16.render._replace(fused_train=fused))
        score = warp.make_pose_scorer(c, SCORE_RAYS, SCORE_PROGRESS)
        torch.cuda.reset_peak_memory_stats(dev)
        ms = cuda_ms(lambda: score(model16, scene16, 0, px, py, cands), 3)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        print(f"[27a] scorer call, {cfg16.render.precision}, tpu.fused_train {fused}: {ms:.2f} ms for {len(cands)} x"
              f" {SCORE_RAYS} rays x ({cfg16.render.N_samples} + {cfg16.render.N_samples + cfg16.render.N_importance})"
              f" samples, peak {peak:.2f} GiB ({card})", flush=True)
    del model, model16, scene, scene16
    torch.cuda.empty_cache()

    # (b)-(d): the train CLI
    seen = []
    original = Trainer._warp_check

    def spied(self, step, img_sum, img_cnt):
        n = len(self.warp_adoptions)
        original(self, step, img_sum, img_cnt)
        if len(self.warp_adoptions) > n:
            table = self.state.pose_params.se3_refine.weight
            st = self.state.pose_opt_state.optimizer.state[table]
            seen.append((self.warp_adoptions[-1], table.detach().clone(), st["exp_avg"].clone(),
                         st["exp_avg_sq"].clone()))

    def run(label, extra):
        seen.clear()
        zero()
        t0 = time.perf_counter()
        Trainer._warp_check = spied
        try:
            tr = train_cli.main(base + extra)
        finally:
            Trainer._warp_check = original
        torch.cuda.synchronize()
        got = read()
        with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [(r["step"], r["loss"]) for r in recs if "loss" in r]
        print(f"[27{label}] {tr.state.step} steps in {time.perf_counter() - t0:.1f} s, launches"
              f" { {k: v for k, v in got.items() if v} }; losses {losses}; events {tr._warp.events if tr._warp else 0},"
              f" adoptions {[(s, a.tolist()) for s, a in tr.warp_adoptions]}", flush=True)
        check(tr.state.step == WARP_STEPS and bool(losses) and all(math.isfinite(v) for _, v in losses),
              f"[27{label}] losses {losses}")
        return tr, got, recs

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        root, name = os.path.join(tmp, "scene"), "scene"
        write_train_scene(root, name)
        base = ["--config", "configs/brandenburg_gate.yaml", "--device", "cuda", "root_dir", root, "scene_name", name,
                "feat_dir", os.path.join(root, "DINO"), "depth_dir", os.path.join(root, "DPT"),
                "out_dir", os.path.join(tmp, "out"), "val.img_idx", "[0]", "phototourism.use_cache", "False",
                "seed", "0"] + WARP_RUN
        steps = {"render_fwd": 2 * WARP_STEPS + 2 * WARP_VALS, "render_bwd": 2 * WARP_STEPS}
        for label, mitigate, extra in (("b", "multistart", []), ("b", "multistart", ["tpu.fused_train", "false"]),
                                       ("c", "reset", [])):
            fused = not extra
            tr, got, recs = run(label, ["exp_name", f"{mitigate}_{fused}", "pose.warp.mitigate", mitigate]
                                + HAIR_TRIGGER + extra)
            check(tr._warp.events == 1 and not tr._warp.budget_left, f"[27{label}] events {tr._warp.events}")
            flagged = next(r for r in recs if "train/warp_flagged" in r)
            check(flagged["step"] == WARP_EVENT_STEP, f"[27{label}] the first flags came at step {flagged['step']}")
            n_flag = int(flagged["train/warp_flagged"])
            scorer = 2 * n_flag if mitigate == "multistart" else 0  # one call a flagged image: coarse + fine pass
            want = (dict(none, render_fwd=steps["render_fwd"] + scorer, render_bwd=steps["render_bwd"]) if fused else
                    dict(none, heads_fwd=2 * WARP_STEPS + scorer, heads_bwd=2 * WARP_STEPS, static=2 * WARP_VALS))
            check(got == want, f"[27{label}] launches {got}, expected {want}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            check(len(seen) == 1, f"[27{label}] {len(seen)} events adopted rows")
            (step, rows), table, mu, nu = seen[0]
            after = [r["loss"] for r in recs if "loss" in r and r["step"] > step]
            check(bool(after) and all(math.isfinite(v) for v in after), f"[27{label}] losses after the event {after}")
            check(not mu[rows].any() and not nu[rows].any(), f"[27{label}] adopted rows' Adam moments not zero")
            if mitigate == "reset":
                check(len(rows) == n_flag, f"[27c] {n_flag} images flagged, rows {rows.tolist()} reset")
                check(not table[rows].any(), f"[27c] the reset rows of the se3 table are not zero: {table[rows]}")
            print(f"[27{label}] {mitigate}, tpu.fused_train {fused}: {n_flag} images flagged at step {step}, rows"
                  f" {rows.tolist()} adopted at step {step}; their Adam moments zero right after"
                  + ("; their se3 rows zero" if mitigate == "reset" else "")
                  + f"; {scorer} scorer launches; losses after the event {[round(v, 5) for v in after]}", flush=True)

        # (d) the other optimizer kinds
        for label, extra, key, lr_key, kind in (
                ("d", ["optimizer.type", "adamw", "optimizer.scheduler.type", "cosine"], "lr", "optimizer.lr",
                 "cosine"),
                ("d", ["optimizer_pose.type", "sgd", "optimizer_pose.scheduler.type", "constant"], "lr_pose",
                 "optimizer_pose.lr", "constant")):
            tr, got, recs = run(label, ["exp_name", extra[1]] + extra)
            check(got == dict(none, **steps), f"[27d] launches {got}")
            lr0, T = float(tr.hp[lr_key]), WARP_STEPS
            for r in (r for r in recs if key in r):
                t = r["step"]
                closed = lr0 if kind == "constant" else lr0 * (
                    1e-8 / lr0 + (1 - 1e-8 / lr0) * 0.5 * (1 + math.cos(math.pi * min(t, T) / T)))
                # the port computes the factor (a number in [0, 1]) in float32, as optax does: a few float32 ulps of
                # 1, times lr0 (near the cosine's end 1 + cos cancels, so the error is not relative to the LR)
                check(abs(r[key] - closed) <= 4 * 2.0**-23 * lr0, f"[27d] {key} at step {t}: {r[key]} against {closed}")
            print(f"[27d] {' '.join(extra)}: logged {key} {[(r['step'], r[key]) for r in recs if key in r]} equal the"
                  f" closed form", flush=True)
    return launches


DP_RANKS = 2  # phase 28: two ranks on the one card, over gloo
DP_STEPS = 3
DP_RAY_KEYS = ("s_rgb_coarse", "s_rgb_fine", "s_depth_fine", "rgb_fine", "feat_fine")
DP_METRIC_TOL = 1e-5  # the loss terms and metrics of the two-rank step against one rank's: sums reordered
# The two-rank step's gradients against one rank's, of each gradient's max. The kernels sum their weight
# gradients in f32 (DW_TOL, as the sum is reordered); a layer under the bf16 matmul policy in PyTorch (the
# transient net, ops/linear.py) hands its weight a gradient rounded to bf16, on each rank from its half of the
# batch: two roundings of the halves and one of the whole, half a bf16 ulp (2^-9) each, bound 2^-7 of the max.
DP_BF16_GRAD_TOL = 2.0 ** -7
DP_TTO_GROUP, DP_TTO_WH = 4, (64, 48)  # phase 13's TTO group and image size


def _dp_world(dev):
    """Phase 28 (a)'s world on `dev`, from seeds, as each rank and the
    one-rank reference build it: phase 8's scene and config, a fresh state at
    phase 1, and a global teacher-forced batch of TRAIN_RAYS rays with its
    uniforms."""
    from upnerf_torch.train import step as tstep

    cfg, scene, store, n_images = flagship_world(dev)
    state, opt, pose_opt = fresh_state(cfg, n_images, dev)
    state = state._replace(step=int(PHASE_PROGRESS[1] * MAX_STEPS))
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randint(0, store.n_rays, (TRAIN_RAYS,), generator=g, device=dev)
    noise = {"coarse": torch.rand((TRAIN_RAYS, cfg.render.N_samples), generator=g, device=dev),
             "fine": torch.rand((TRAIN_RAYS, cfg.render.N_importance), generator=g, device=dev)}
    return cfg, scene, store, state, opt, pose_opt, tstep.gather_batch(store, idx), noise


def _dp_step(world, mesh):
    """One teacher-forced phase-1 batch step of `world` over `mesh` (None:
    one rank): (metrics, every gradient, the render's per-ray outputs of this
    rank's rows), as numpy."""
    from upnerf_torch.train import make_train_step
    from upnerf_torch.train import step as tstep

    cfg, scene, _, state, opt, pose_opt, batch, noise = world
    rays = {}
    forward = tstep.forward

    def record(*args, **kwargs):
        results, r, feats = forward(*args, **kwargs)
        rays.update({k: v.detach().float().cpu().numpy() for k, v in results.items() if k in DP_RAY_KEYS})
        return results, r, feats

    tstep.forward = record
    try:
        state, m = make_train_step(cfg, opt, pose_opt, mesh)[1](state, scene, batch, 1, noise=noise)
    finally:
        tstep.forward = forward
    named = list(state.params.named_parameters()) + list(state.pose_params.named_parameters())
    grads = {k: p.grad.detach().float().cpu().numpy() for k, p in named if p.grad is not None}
    return {k: v.float().cpu().numpy() for k, v in m.items()}, grads, rays


def _dp_tto(ckpt: str, dev, mesh, chunk: int = 0):
    """Phase 28 (d): one phase-A TTO step of a group of DP_TTO_GROUP images x
    1024 rays on the checkpoint's frozen model (the pixels and uniforms drawn
    from a seeded generator at the global shape) and one eval chunk (each
    image's 64 x 64 grid, 4096 rays), over `mesh`; the eval also at chunk
    `chunk` when given. Returns (loss, {trainable: gradient}, eval preds,
    step ms, eval ms), numpy."""
    from upnerf_torch.evaluate.tto import EVAL_CHUNK, TTOConfig, TTOGroup, TTORunner, make_tto_eval
    from upnerf_torch.models.nerf import NeRFConfig
    from upnerf_torch.render.render_rays import RenderConfig
    from upnerf_torch.utils.weights import load_reference_ckpt, render_params

    sd, hp, _ = load_reference_ckpt(ckpt)
    frozen, _ = render_params(sd, NeRFConfig.from_hparams(hp), dev)
    cfg = TTOConfig(nerf=NeRFConfig.from_hparams(hp), batch_size=1024,
                    render=RenderConfig.from_hparams(hp)._replace(perturb=1.0, param_grads=False))
    runner = TTORunner(frozen, cfg, hp["nerf.appearance_dim"], region_A=(64, 64), region_B=(64, 64), mesh=mesh)
    g = torch.Generator(device=dev).manual_seed(5)
    (w, h), n = DP_TTO_WH, DP_TTO_GROUP
    group = TTOGroup(
        Ks=torch.tensor([[[50.0, 0, w / 2], [0, 50.0, h / 2], [0, 0, 1]]] * n, device=dev),
        base_poses=torch.from_numpy(ring_poses(n).astype(np.float32)).to(dev),
        rgbs=torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8, device=dev, generator=g),
        wh=torch.tensor([[w, h]] * n, dtype=torch.int32, device=dev),
        near_far=torch.tensor([[0.1, 5.0]] * n, device=dev))
    init = {"fine_a": torch.randn((n, hp["nerf.appearance_dim"]), generator=g, device=dev),
            "se3": torch.zeros((n, 6), device=dev)}
    trainables = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    loss = runner.step_A(trainables, runner.opt_A(trainables), group, torch.Generator(device=dev).manual_seed(6))
    grads = {k: t.grad.cpu().numpy() for k, t in trainables.items()}
    preds = {EVAL_CHUNK: runner.eval_A(init, group, 64, 64)[0].cpu().numpy()}
    if chunk:
        preds[chunk] = make_tto_eval(frozen, cfg, x_frac=(0.0, 1.0), chunk=chunk)(init, group, 64, 64)[0].cpu().numpy()
    timed = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    opt = runner.opt_A(timed)
    step_ms = host_ms(lambda: runner.step_A(timed, opt, group, g), dev)
    eval_ms = host_ms(lambda: runner.eval_A(init, group, 64, 64), dev)
    return float(loss), grads, preds, step_ms, eval_ms


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_ms(fn, dev, reps: int = 3) -> float:
    """Mean wall ms of fn() over `reps` runs after a warm-up, the card
    synchronised around them (a gloo collective also waits on the host)."""
    fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def _dp_rank(tto_ckpt: str) -> dict:
    """Phase 28 (a) and (d) in one rank of the group (spawned by
    upnerf_torch.parallel.launch)."""
    import hashlib

    import torch.distributed as dist

    from upnerf_torch import parallel
    from upnerf_torch.ops import dw_gemm as dg
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.train import make_eval_render, make_train_step
    from upnerf_torch.train import step as tstep

    dev = parallel.distributed.local_device()
    mesh = parallel.make_mesh(0, dev)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": dist.get_backend(mesh.group),
           "teacher": _dp_step(_dp_world(dev), mesh)}

    # the main path: DP_STEPS phase-1 steps drawn by step_fn, each rank its rows, every count zeroed just before
    cfg, scene, store, state, opt, pose_opt, _, _ = _dp_world(dev)
    step, _ = make_train_step(cfg, opt, pose_opt, mesh)
    state, _ = step(state, scene, store, 1)  # warm-up
    zero, read = _launch_counters()
    zero()
    rt.walk_pre_launches = rt.walk_launches = rt.walk_finish_launches = 0
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        state, m = step(state, scene, store, 1)
        losses.append(m["loss"])
    torch.cuda.synchronize(dev)
    out["step_ms"] = (time.perf_counter() - t0) / DP_STEPS * 1e3
    out["launches"] = dict(read(), dw=dg.dw_launches, walk_pre=rt.walk_pre_launches, walk=rt.walk_launches,
                           walk_finish=rt.walk_finish_launches)
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    out["losses"] = [float(x) for x in losses]
    parallel.assert_replicated([state.params, state.pose_params], mesh, "parameters")
    h = hashlib.sha256()
    for p in list(state.params.parameters()) + list(state.pose_params.parameters()):
        h.update(p.detach().float().cpu().numpy().tobytes())
    out["sha"] = h.hexdigest()

    # the step's all-reduce alone: one flat buffer of every gradient and the metrics
    n = sum(p.numel() for o in (state.opt_state, state.pose_opt_state) for gr in o.optimizer.param_groups
            for p in gr["params"]) + sum(v.numel() for v in m.values())
    buf = torch.zeros(n, device=dev)
    out["allreduce_ms"] = host_ms(lambda: parallel.all_reduce_mean([buf], mesh), dev, reps=5)
    out["allreduce_mb"] = n * 4 / 1e6
    # a phase-1 val chunk rendered over the mesh, and its gather alone: each rank's half of the rows, every output
    # in f32 (gloo has no all-gather of CUDA tensors: through host memory)
    batch = tstep.gather_batch(store, torch.arange(CHUNK, device=dev))
    batch = {k: batch[k] for k in ("px", "py", "img_idx", "inv_depth")}
    val = make_eval_render(cfg, CHUNK, mesh)(state.params, state.pose_params, scene, batch, PHASE_PROGRESS[1], 1)
    out["val_cols"] = sum(v[0].numel() for v in val.values())
    out["val_finite"] = all(bool(torch.isfinite(v).all()) for v in val.values())
    rows = torch.zeros((CHUNK // mesh.size, out["val_cols"]), device=dev)
    out["gather_ms"] = host_ms(lambda: parallel.all_gather_rows(rows, mesh), dev, reps=5)
    del state, store, scene, buf, rows
    torch.cuda.empty_cache()
    out["tto"] = _dp_tto(tto_ckpt, dev, mesh)
    return out


def phase_data_parallel(dev, card: str):
    """Phase 28: the data-parallel branches (upnerf_torch.parallel) on the
    card. (a) Two ranks on the one card over gloo (NCCL refuses two ranks on
    one device), at brandenburg_gate's width on phase 8's scene, phase 1,
    bf16, batch 2048 (1024 a rank): one teacher-forced step against
    the same step on one rank (loss terms and metrics within DP_METRIC_TOL,
    every gradient within DW_TOL of its max, the bf16-policy layers' within
    DP_BF16_GRAD_TOL; the per-ray render outputs of each rank's rows against
    the one-rank rows: differing values counted), then DP_STEPS steps drawn
    by step_fn: launches, step ms, each rank's peak memory, the ranks'
    parameters bit for bit, the all-reduce's ms alone, a sharded val chunk
    and its gather's ms. (d) In the same ranks: one TTO step and one eval
    chunk through the ranks' TTORunner against one rank (loss, gradients; the
    eval bit for bit against one rank rendering the same rays a call, and the
    differences from 4096 rays a call counted). (b) `cli.train
    dist.num_processes 1`, a one-rank NCCL group, 4 steps. (c) Two
    `cli.train` processes with dist.* keys on phase 18's scene, 12 steps,
    both on the one card over gloo: rank-0 gating, and the checkpoint
    through `cli.tto`. Returns the kernel launches of (a)'s steps, every
    rank together."""
    import torch.distributed as dist

    from upnerf_torch import parallel
    from upnerf_torch.cli import tto as tto_cli
    from upnerf_torch.evaluate.tto import EVAL_CHUNK
    from upnerf_torch.train import make_train_step
    from upnerf_torch.utils.weights import init_reference_ckpt

    ranks, devices, backend = DP_RANKS, [dev] * DP_RANKS, "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        tto_ckpt = init_reference_ckpt(os.path.join(tmp, "bg.ckpt"), dict(BRANDENBURG_GATE), n_images=4, seed=1)
        # the one-rank references, before the ranks start
        ref = _dp_step(_dp_world(dev), parallel.DataMesh())
        cfg, scene, store, state, opt, pose_opt, _, _ = _dp_world(dev)
        step, _ = make_train_step(cfg, opt, pose_opt)
        one = {"s": state}

        def one_step():
            one["s"], _ = step(one["s"], scene, store, 1)

        torch.cuda.reset_peak_memory_stats(dev)
        one_ms = host_ms(one_step, dev, reps=DP_STEPS)
        one_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        ref_tto = _dp_tto(tto_ckpt, dev, parallel.DataMesh(), chunk=EVAL_CHUNK // ranks)
        del one, state, store, scene, step
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        outs = parallel.launch(_dp_rank, (tto_ckpt,), n_local=ranks, device=dev, devices=devices)
        print(f"[28 a] {ranks} ranks on {len(set(devices))} card(s) in {time.perf_counter() - t0:.1f} s (spawn,"
              " steps, TTO)", flush=True)
        check([o["rank"] for o in outs] == list(range(ranks)) and all(o["size"] == ranks for o in outs),
              "the ranks' group")
        check(all(o["backend"] == backend for o in outs), f"the ranks' collectives run {backend}, got"
              f" {outs[0]['backend']}")
        rm, rg, rrays = ref
        rows = TRAIN_RAYS // ranks
        for o in outs:
            tm, tg, trays = o["teacher"]
            errs = {}
            for k, v in rm.items():
                want = v * (1.0 / ranks if k.startswith("img_loss") else 1.0)  # pmean'd sums and counts
                errs[k] = float(np.abs(tm[k] - want).max() / max(np.abs(want).max(), 1e-30))
            worst = max(errs, key=errs.get)
            check(set(tm) == set(rm), "the sharded step's metrics")
            check(errs[worst] <= DP_METRIC_TOL, f"rank {o['rank']}: metric {worst} off by {errs[worst]:.3e}")
            gerrs = {k: float(np.abs(tg[k] - v).max() / max(np.abs(v).max(), 1e-30)) for k, v in rg.items()}
            check(set(tg) == set(rg), "the sharded step's gradients")
            bf16 = {k for k in gerrs if k.startswith("transient_net.")}
            gworst = max(set(gerrs) - bf16, key=gerrs.get)
            bworst = max(bf16, key=gerrs.get)
            check(gerrs[gworst] <= DW_TOL, f"rank {o['rank']}: gradient {gworst} off by {gerrs[gworst]:.3e}")
            check(gerrs[bworst] <= DP_BF16_GRAD_TOL, f"rank {o['rank']}: gradient {bworst} off by {gerrs[bworst]:.3e}")
            r0 = o["rank"] * rows
            diff = {k: int((trays[k] != rrays[k][r0:r0 + rows]).sum()) for k in trays}
            dmax = {k: float(np.abs(trays[k] - rrays[k][r0:r0 + rows]).max()) for k in trays}
            print(f"[28 a] rank {o['rank']}, teacher-forced step against one rank: worst metric {worst}"
                  f" {errs[worst]:.2e} (tol {DP_METRIC_TOL:.0e}), worst gradient {gworst} {gerrs[gworst]:.2e} of its"
                  f" max (tol {DW_TOL:.0e}), of the bf16-policy layers {bworst} {gerrs[bworst]:.2e} (tol"
                  f" {DP_BF16_GRAD_TOL:.2e}); per-ray outputs of its {rows} rows, values that differ from the"
                  f" one-rank rows {diff} (max |d| {dmax})", flush=True)
        check(len({o["sha"] for o in outs}) == 1, "the ranks' parameters differ after the steps")
        check(all(o["val_finite"] for o in outs), "the sharded val chunk is not finite")
        launches = {k: sum(o["launches"][k] for o in outs) for k in outs[0]["launches"]}
        want = 2 * DP_STEPS * ranks
        print(f"[28 a] {DP_STEPS} steps on each rank: launches {launches} (forward and backward {want} each, every"
              f" rank); losses {[o['losses'] for o in outs]}; parameters equal bit for bit", flush=True)
        check(launches["render_fwd"] == want and launches["render_bwd"] == want, "2 + 2 launches a step on each rank")
        check(launches["walk_pre"] == launches["walk"] == launches["walk_finish"] >= want and launches["dw"] >= want,
              "each rank's backward ran the Hopper walk's three kernels and the dW kernel a slab")
        for o in outs:
            print(f"[28 a] rank {o['rank']}: phase-1 step {o['step_ms']:.2f} ms ({rows} rays a rank,"
                  f" {TRAIN_RAYS / o['step_ms'] * 1e3:.0f} rays/s together), all-reduce of {o['allreduce_mb']:.2f} MB"
                  f" {o['allreduce_ms']:.2f} ms ({o['allreduce_ms'] / o['step_ms']:.0%} of the step), a val chunk's"
                  f" gather ({CHUNK} x {o['val_cols']} f32) {o['gather_ms']:.2f} ms, peak memory"
                  f" {o['peak_gib']:.2f} GiB; one rank alone: {one_ms:.2f} ms at {one_peak:.2f} GiB ({card})",
                  flush=True)

        # (d) TTO through the ranks' runner against one rank
        rloss, rgrads, rpreds, rstep_ms, reval_ms = ref_tto
        part = EVAL_CHUNK // ranks
        for o in outs:
            loss, grads, preds, step_ms, eval_ms = o["tto"]
            lerr = abs(loss - rloss) / abs(rloss)
            gerr = max(float(np.abs(grads[k] - v).max() / max(np.abs(v).max(), 1e-30)) for k, v in rgrads.items())
            full = preds[EVAL_CHUNK]
            same = int((full != rpreds[part]).sum())
            whole = int((full != rpreds[EVAL_CHUNK]).sum())
            print(f"[28 d] rank {o['rank']}: TTO step loss rel {lerr:.2e}, gradients {gerr:.2e} of their max; eval"
                  f" chunk values differing from one rank at {part} rays an image a call {same}, at {EVAL_CHUNK}"
                  f" {whole} of {full.size} (max |d| {float(np.abs(full - rpreds[EVAL_CHUNK]).max()):.2e}); TTO step"
                  f" {step_ms:.2f} ms, eval chunk {eval_ms:.2f} ms; one rank {rstep_ms:.2f} / {reval_ms:.2f} ms"
                  f" ({card})", flush=True)
            check(lerr <= DP_METRIC_TOL and gerr <= DW_TOL, f"rank {o['rank']}: the sharded TTO step disagrees")
            check(same == 0, "the sharded eval chunk differs from one rank rendering the same rays a call")

        zero, read = _launch_counters()
        none = {k: 0 for k in read()}
        root, name = os.path.join(tmp, "scene"), "scene"
        write_train_scene(root, name)
        base = ["--config", "configs/brandenburg_gate.yaml", "--device", dev.type, "root_dir", root, "scene_name",
                name, "feat_dir", os.path.join(root, "DINO"), "depth_dir", os.path.join(root, "DPT"),
                "out_dir", os.path.join(tmp, "out"), "max_steps", "12", "val.log_interval", "6",
                "train.ckpt_interval", "6", "train.log_pose_interval", "6", "val.img_idx", "[0]",
                "phototourism.use_cache", "False", "seed", "0"]

        def rank0_files(run_dir: str, label: str):
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            val = [r["step"] for r in recs if "val/psnr" in r]
            ckpts = sorted(os.listdir(os.path.join(run_dir, "ckpts")))
            print(f"[{label}] val records at {val}, ckpts {ckpts}", flush=True)
            check(val == [6, 12] and ckpts == ["12.ckpt", "6.ckpt", "ckpt_metrics.json"]
                  and os.path.isfile(os.path.join(run_dir, "config.yaml")), f"[{label}] rank 0's files")
            check(all(np.isfinite(r["loss"]) for r in recs if "loss" in r), f"[{label}] losses not finite")

        # (b) a one-rank group: a card of its own, so NCCL
        argv = base + ["exp_name", "nccl", "max_steps", "4", "val.log_interval", "4", "dist.coordinator",
                       f"127.0.0.1:{free_port()}", "dist.num_processes", "1", "dist.process_id", "0"]
        tr = _run_train(argv, "28 b", zero, read, dict(none, render_fwd=2 * 4 + 2, render_bwd=2 * 4))
        check(tr.mesh.size == 1 and tr.mesh.group is not None and not dist.is_initialized(),
              "cli.train dist.num_processes 1 did not run (and leave) a one-rank NCCL group")
        print("[28 b] one-rank group through cli.train: the data mesh on NCCL, 4 steps", flush=True)

        # (c) two cli.train processes, one rank each, both on the one card
        port = free_port()
        logs = [os.path.join(tmp, f"dist{p}.log") for p in range(DP_RANKS)]
        procs = []
        t0 = time.perf_counter()
        for p in range(DP_RANKS):
            with open(logs[p], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "upnerf_torch.cli.train", *base, "exp_name", "dist", "dist.coordinator",
                     f"127.0.0.1:{port}", "dist.num_processes", str(DP_RANKS), "dist.process_id", str(p),
                     "dist.init_timeout", "600"],
                    cwd=os.path.dirname(os.path.abspath(__file__)), stdout=f, stderr=subprocess.STDOUT))
        try:
            rcs = [proc.wait(timeout=900) for proc in procs]
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
        texts = [open(path).read() for path in logs]
        for p, (rc, text) in enumerate(zip(rcs, texts)):
            if rc != 0:
                print(text[-4000:], flush=True)
            check(rc == 0, f"[28 c] cli.train process {p} exited {rc}")
        run_dir = os.path.join(tmp, "out", name, "dist")
        print(f"[28 c] two cli.train processes (dist.num_processes 2) in {time.perf_counter() - t0:.1f} s; process 0:"
              f" {[ln for ln in texts[0].splitlines() if 'process group' in ln]}", flush=True)
        rank0_files(run_dir, "28 c")
        check(f"on {backend}" in texts[0] and "[upnerf_torch] process group" not in texts[1],
              "[28 c] the group's report")
        metrics_path = tto_cli.main(["--ckpt", os.path.join(run_dir, "ckpts", "12.ckpt"), "--result_dir",
                                     os.path.join(tmp, "tto"), "--group_size", "2", "--batch_size", "1024",
                                     "--pose_epochs", "1", "--appearance_epochs", "1", "--device", dev.type])
        with open(metrics_path) as f:
            tm = json.load(f)
        check(len(tm) == 2 and all(np.isfinite(v["psnr"]) for v in tm.values()), f"[28 c] cli.tto metrics {tm}")
        print(f"[28 c] cli.tto on its step-12 checkpoint: {tm}", flush=True)
    return launches


def _record_keys(path: str):
    """(top-level keys, keys of its runs) of a JSON protocol record; a run's
    "reused_from_artifact" marks a seed taken from an earlier record."""
    with open(path) as f:
        rec = json.load(f)
    return set(rec), set().union(*(set(r) for r in rec["runs"])) - {"reused_from_artifact"}


def _protocol_launches(zero_all, read_all):
    """(zero, read) over the launch counts phase 29 checks: kernel 1's forward,
    kernel 2's train and frozen backward, the Hopper walk's kernels and the dW
    kernel, and every other wrapper's (which must stay at 0)."""
    from upnerf_torch.ops import dw_gemm as dg
    from upnerf_torch.ops import render_train as rt

    def zero():
        zero_all()
        rt.walk_pre_launches = rt.walk_launches = rt.walk_finish_launches = 0

    def read():
        return dict(read_all(), dw=dg.dw_launches, walk_pre=rt.walk_pre_launches, walk=rt.walk_launches,
                    walk_finish=rt.walk_finish_launches)

    return zero, read


def phase_protocols(dev, card: str):
    """Phase 29: the quality-protocol drivers (upnerf_torch.scripts.pose_protocol,
    tto_protocol) on the card at cut lengths, into a temporary --out and
    --work: (a) the pose recipe (configs/validation/synth_pose.yaml, its
    16-view scene written by the ported generator), seed 42,
    PROTOCOL_POSE_STEPS steps; (b) the same call again, which reuses the
    finished seed and launches no kernel; (c) the TTO recipe
    (synth_tto.yaml, 32 + 4 views), seed 42, PROTOCOL_TTO_STEPS steps, then
    cli.tto with the pose / appearance epochs cut to PROTOCOL_TTO_EPOCHS and
    cli.eval; (d) (c) again, reused. Checks each record's keys against the
    JAX record's (benchmarks/) plus "device", the rel-R trace's rows and
    values, finite TTO PSNR / SSIM, and each run's launches: 2 forward + 2
    backward of kernels 1 / 2 a train step (2 forward a val render's chunk),
    the Hopper walk's three kernels and the dW kernel once a slab, the frozen
    backward once a TTO step. Returns the launches of (a) and (c) by kernel."""
    from upnerf_torch.scripts import pose_protocol, tto_protocol

    zero, read = _protocol_launches(*_launch_counters())
    none = {k: 0 for k in read()}
    t0 = time.perf_counter()
    total = dict(none)
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--seeds", "42", "--device", "cuda", "--out", os.path.join(tmp, "records"),
                  "--work", os.path.join(tmp, "work")]
        pose_argv = ["--recipe", "pose", "--steps", str(PROTOCOL_POSE_STEPS), "--tag", "_smoke"] + common
        chunks = -(-(64 // 2) * (80 // 2) // CHUNK)  # a val render's chunks: 80 x 64 at downscale 2

        def train_want(steps: int, got: dict) -> dict:
            want = dict(none, render_fwd=2 * steps + 2 * chunks, render_bwd=2 * steps)
            slabs = got["walk"]  # one walk a slab of rays; at least one a backward call
            return dict(want, walk_pre=slabs, walk=slabs, walk_finish=slabs, dw=slabs)

        # (a) the pose recipe
        zero()
        t1 = time.perf_counter()
        rec = pose_protocol.main(pose_argv)
        torch.cuda.synchronize()
        got = read()
        want = train_want(PROTOCOL_POSE_STEPS, got)
        (run,) = rec["runs"]
        log_int = max(500, PROTOCOL_POSE_STEPS // 30)
        rows = list(range(log_int, PROTOCOL_POSE_STEPS + 1, log_int))
        print(f"[29 a] pose_protocol --recipe pose, 1 seed x {PROTOCOL_POSE_STEPS} steps in"
              f" {time.perf_counter() - t1:.1f} s: final rel-R {run['final_rel_R_deg']} deg (init"
              f" {run['init_rel_R_deg']}), rel-t {run['final_rel_t']}, trace {run['trace']}; launches {got} (expected"
              f" {want}); device {rec['device']!r}", flush=True)
        keys, run_keys = _record_keys("benchmarks/pose_protocol_pose.json")
        check(set(rec) == keys | {"device"} and set(run) == run_keys, f"[29 a] record keys {sorted(rec)}"
              f" / {sorted(run)}, the JAX record's {sorted(keys)} / {sorted(run_keys)}")
        check(rec["device"] == card, f"[29 a] the record's device {rec['device']!r}")
        check([r[0] for r in run["trace"]] == rows and all(np.isfinite(v) for r in run["trace"] for v in r[1:]),
              f"[29 a] the trace {run['trace']}, expected rows at steps {rows}")
        check(got == want and got["walk"] >= 2 * PROTOCOL_POSE_STEPS, f"[29 a] launches {got}, expected {want}")
        total = {k: total[k] + v for k, v in got.items()}

        # (b) the finished seed again: reused, no kernel launched
        from upnerf_torch.config import default, merge_from_file

        hp = default()
        merge_from_file(hp, pose_protocol.RECIPES["pose"]["config"])
        run_dir = os.path.join(pose_protocol.work_path(hp["out_dir"], os.path.join(tmp, "work")), hp["scene_name"],
                               run["exp"])
        check(pose_protocol.plan_run(run_dir, PROTOCOL_POSE_STEPS) == "reuse", "[29 b] the run is not reusable")
        zero()
        again = pose_protocol.main(pose_argv)
        torch.cuda.synchronize()
        check(read() == none and again["runs"] == rec["runs"], f"[29 b] the reused seed launched {read()}")
        print("[29 b] the same call again: plan reuse, no kernel launched, the same row", flush=True)

        # (c) the TTO recipe: train, then cli.tto and cli.eval with the epochs cut
        kw = tto_protocol.TTO_KW
        tto_protocol.TTO_KW = dict(kw, pose_epochs=PROTOCOL_TTO_EPOCHS[0], appearance_epochs=PROTOCOL_TTO_EPOCHS[1])
        try:
            tto_argv = ["--steps", str(PROTOCOL_TTO_STEPS)] + common
            zero()
            t1 = time.perf_counter()
            rec = tto_protocol.main(tto_argv)
            torch.cuda.synchronize()
            got = read()
            (run,) = rec["runs"]
            # 80 x 64 test images, 1024 rays a step: 5 steps a phase-A epoch, 2 a phase-B epoch
            tto_steps = PROTOCOL_TTO_EPOCHS[0] * 5 + PROTOCOL_TTO_EPOCHS[1] * 2
            # the TTO steps' forwards and its eval renders' (2 a chunk) on top of the training's; the frozen
            # backward runs the Hopper walk's kernels on one slab a call and no dW kernel
            slabs = got["dw"]
            want = dict(none, render_fwd=got["render_fwd"], render_bwd=2 * PROTOCOL_TTO_STEPS,
                        render_frozen=tto_steps, dw=slabs, walk_pre=slabs + tto_steps, walk=slabs + tto_steps,
                        walk_finish=slabs + tto_steps)
            tto_fwd = got["render_fwd"] - (2 * PROTOCOL_TTO_STEPS + 2 * chunks)
            print(f"[29 c] tto_protocol, 1 seed x {PROTOCOL_TTO_STEPS} steps + TTO {PROTOCOL_TTO_EPOCHS} epochs"
                  f" ({tto_steps} steps) + eval in {time.perf_counter() - t1:.1f} s: val PSNR {run['final_val_psnr']},"
                  f" TTO PSNR {run['tto_psnr_per_image']}, SSIM {run['tto_ssim_mean']}, rel-R"
                  f" {run.get('final_rel_R_deg')}; launches {got} (the TTO's forwards {tto_fwd}); pass"
                  f" {rec['pass']}", flush=True)
            keys, run_keys = _record_keys("benchmarks/tto_quality_protocol.json")
            check(set(rec) == keys | {"device"} and set(run) == run_keys, f"[29 c] record keys {sorted(rec)}"
                  f" / {sorted(run)}, the JAX record's {sorted(keys)} / {sorted(run_keys)}")
            check(run["n_test_images"] == 4 and all(np.isfinite(run["tto_psnr_per_image"]))
                  and np.isfinite(run["tto_ssim_mean"]), f"[29 c] TTO rows {run}")
            check(got == want and slabs >= 2 * PROTOCOL_TTO_STEPS and tto_fwd >= 2 * (tto_steps + 1)
                  and tto_fwd % 2 == 0,
                  f"[29 c] launches {got}, expected {want} and 2 forwards a TTO step and eval chunk")
            total = {k: total[k] + v for k, v in got.items()}

            # (d) again: the run and its stamped TTO result reused
            zero()
            again = tto_protocol.main(tto_argv)
            torch.cuda.synchronize()
            check(read() == none and again["runs"] == rec["runs"], f"[29 d] the reused seed launched {read()}")
            print("[29 d] the same call again: train and TTO reused, cli.eval only, no kernel launched", flush=True)
        finally:
            tto_protocol.TTO_KW = kw
    print(f"[29] the protocol drivers: {time.perf_counter() - t0:.1f} s; launches {total} ({card})", flush=True)
    return total


def host_codec_times(tmp: str, card: str, reps: int = 3) -> dict:
    """Phase 30 (b): ms an image of `decode_jpeg` and `encode_jpeg` on a
    JPEG_HOST_WH quality-95 4:2:0 image (smooth content plus seeded noise,
    as a render), and of `read_png_rgb` on the same pixels (host clock, the
    mean of `reps` after one warm-up)."""
    from upnerf_torch.features import jpeg
    from upnerf_torch.features.images import read_png_rgb, write_png

    w, h = JPEG_HOST_WH
    rng = np.random.RandomState(30)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.stack([xx / w, yy / h, (xx + yy) / (w + h)], -1) * 220
    img = np.clip(smooth + rng.randint(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
    data = jpeg.encode_jpeg(img, 95)
    png = os.path.join(tmp, "host.png")
    write_png(png, img)

    def timed(fn):
        fn()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) / reps * 1e3, out

    dec_ms, dec = timed(lambda: jpeg.decode_jpeg(data))
    enc_ms, enc = timed(lambda: jpeg.encode_jpeg(img, 95))
    png_ms, px = timed(lambda: read_png_rgb(png))
    psnr = 10 * np.log10(255.0**2 / np.mean((dec.astype(np.float64) - img) ** 2))
    check(enc == data and dec.shape == img.shape and np.array_equal(px, img) and psnr > 30,
          f"[30 b] the codec's round trip: {len(enc)} vs {len(data)} bytes, PSNR {psnr:.2f}")
    print(f"[30 b] {w}x{h} quality 95 4:2:0 ({len(data)} bytes, round trip {psnr:.2f} dB): decode_jpeg"
          f" {dec_ms:.1f} ms, encode_jpeg {enc_ms:.1f} ms, read_png_rgb of the same pixels {png_ms:.1f} ms an image"
          f" (host clock, {reps} after a warm-up) ({card})", flush=True)
    return {"decode": dec_ms, "encode": enc_ms, "png": png_ms}


def check_jpeg_fixtures() -> int:
    """Phase 30 (c): every tests/torch_jpeg_fixtures/decode_*.jpg decodes to
    its stored pixels (PIL's), and encode_q95.npy encodes to PIL's bytes.
    Returns the number of files decoded."""
    from upnerf_torch.features import jpeg

    names = sorted(n[:-4] for n in os.listdir(JPEG_FIXTURES) if n.startswith("decode_") and n.endswith(".jpg"))
    for name in names:
        with open(os.path.join(JPEG_FIXTURES, name + ".jpg"), "rb") as f:
            got = jpeg.decode_jpeg(f.read())
        want = np.load(os.path.join(JPEG_FIXTURES, name + ".npy"))
        check(got.shape == want.shape and np.array_equal(got, want),
              f"[30 c] {name}: {int((got != want).sum()) if got.shape == want.shape else got.shape} values differ")
    with open(os.path.join(JPEG_FIXTURES, "encode_q95.jpg"), "rb") as f:
        want = f.read()
    got = jpeg.encode_jpeg(np.load(os.path.join(JPEG_FIXTURES, "encode_q95.npy")), 95)
    check(got == want, f"[30 c] encode_q95: {len(got)} bytes against PIL's {len(want)}")
    print(f"[30 c] {len(names)} fixtures decode to PIL's pixels ({', '.join(n[7:] for n in names)}); encode_q95"
          f" gives PIL's {len(want)} bytes", flush=True)
    return len(names)


def phase_jpeg_scenes(dev, card: str):
    """Phase 30: JPEG scenes on the card, with no PIL. (a) the ported
    generator writes a Phototourism-layout scene of JPEGs (JPEG_VIEWS views
    of JPEG_WH, quality 95); `cli.preprocess` runs on them with phase 11's
    seeded DINO ViT-S/8 and DPT-Large npz weights (9 flash-attention
    launches an image), then `cli.prepare_cache`, `cli.train` at
    brandenburg_gate's settings from the cache (JPEG_STEPS steps: 2 + 2
    launches of kernels 1 / 2 a step, the Hopper walk and the dW kernel a
    slab, 2 a val chunk), `cli.tto` (2 forwards and 1 frozen backward a
    step) and `cli.eval`; finite losses and metrics. (b) host_codec_times,
    and the scene's load through `load_training_data` from its JPEGs and
    from the cache. (c) check_jpeg_fixtures. Then "PIL" is not in
    sys.modules. Returns the launches of (a) by kernel, flash attention's
    under "flash"."""
    from upnerf_torch.cli import eval as eval_cli
    from upnerf_torch.cli import prepare_cache, preprocess
    from upnerf_torch.cli import train as train_cli
    from upnerf_torch.cli import tto as tto_cli
    from upnerf_torch.data import load_training_data
    from upnerf_torch.data.synthetic import generate_scene
    from upnerf_torch.features import dpt, vit
    from upnerf_torch.ops import attention

    zero, read = _protocol_launches(*_launch_counters())
    none = {k: 0 for k in read()}
    t_phase = time.perf_counter()
    (n_train, n_test), (W, H) = JPEG_VIEWS, JPEG_WH
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the scene, its features and depth, the cache, train -> TTO -> eval
        root, name = os.path.join(tmp, "scene"), "scene"
        t0 = time.perf_counter()
        meta = generate_scene(root, n_train=n_train, n_test=n_test, H=H, W=W, feat_hw=8, feat_dim=8,
                              focal=JPEG_FOCAL, seed=30, phototourism_layout=True, arc=0.5, interleave_test=True)
        images = sorted(os.listdir(os.path.join(root, "dense", "images")))
        check(len(images) == n_train + n_test and all(n.endswith(".jpg") for n in images)
              and all(v["name"].endswith(".jpg") for v in meta.values()), f"[30 a] the scene's images {images}")
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.savez(os.path.join(tmp, "dino_vits8.npz"),
                 **_flatten(vit.init_vit_params(np.random.default_rng(10), vit.ViTConfig())))
        np.savez(os.path.join(tmp, "dpt_large.npz"), **_flatten(dpt.init_dpt_params(np.random.default_rng(11))))
        print(f"[30 a] the generator wrote {len(images)} JPEGs of {W}x{H} (quality 95) + tsv + COLMAP in"
              f" {gen_s:.1f} s; seeded npz weights in {time.perf_counter() - t0:.1f} s", flush=True)
        attention.launches = 0
        t0 = time.perf_counter()
        preprocess.main(["--image_dir", os.path.join(root, "dense", "images"), "--save_dir", root, "--what", "dino",
                         "dpt", "--device", "cuda", "--dino_weights", os.path.join(tmp, "dino_vits8.npz"),
                         "--dpt_weights", os.path.join(tmp, "dpt_large.npz")])
        torch.cuda.synchronize()
        flash = attention.launches
        print(f"[30 a] preprocess --what dino dpt on the JPEGs: {time.perf_counter() - t0:.1f} s, flash kernel"
              f" launches {flash} (expected 9 x {len(images)})", flush=True)
        check(flash == 9 * len(images), f"[30 a] flash kernel launched {flash} times")
        for img in images:
            stem = img[:-4]
            feat = np.load(os.path.join(root, "DINO", "feature_maps", stem + ".npy"))
            depth = np.load(os.path.join(root, "DPT", stem + ".npy"))
            check(feat.shape == (DINO_GRID, DINO_GRID, DINO_DIM) and depth.shape == (H, W)
                  and np.isfinite(feat).all() and np.isfinite(depth).all(),
                  f"[30 a] {stem}: features {feat.shape}, depth {depth.shape}")
        config = ["--config", "configs/brandenburg_gate.yaml"]
        scene = ["root_dir", root, "scene_name", name, "feat_dir", os.path.join(root, "DINO"), "depth_dir",
                 os.path.join(root, "DPT")]
        t0 = time.perf_counter()
        cdir = prepare_cache.cli(config + scene)
        print(f"[30 a] prepare_cache: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(cdir, tmp)}", flush=True)
        argv = config + ["--device", "cuda"] + scene + [
            "out_dir", os.path.join(tmp, "out"), "max_steps", str(JPEG_STEPS), "val.log_interval", "6",
            "train.ckpt_interval", "6", "train.log_pose_interval", "6", "val.img_idx", "[0]", "seed", "0",
            "exp_name", "jpeg"]
        chunks = -(-(W // 2) * (H // 2) // CHUNK)  # a val render of train image 0 at downscale 2
        zero()
        t0 = time.perf_counter()
        tr = train_cli.main(argv)
        torch.cuda.synchronize()
        got = read()
        with open(os.path.join(tr.save_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        psnrs = [r["val/psnr"] for r in recs if "val/psnr" in r]
        slabs = got["walk"]  # one walk a slab of rays; at least one a backward call
        want = dict(none, render_fwd=2 * JPEG_STEPS + 2 * 2 * chunks, render_bwd=2 * JPEG_STEPS, walk_pre=slabs,
                    walk=slabs, walk_finish=slabs, dw=slabs)
        print(f"[30 a] cli.train from the cache, {tr.state.step} steps in {time.perf_counter() - t0:.1f} s: launches"
              f" {got} (expected {want}); losses {[round(x, 4) for x in losses]}, val psnr {psnrs}", flush=True)
        check(tr.state.step == JPEG_STEPS and got == want and slabs >= 2 * JPEG_STEPS,
              f"[30 a] train launches {got}, expected {want}")
        check(bool(losses) and all(np.isfinite(losses)) and bool(psnrs) and all(np.isfinite(psnrs)),
              f"[30 a] losses {losses}, val psnr {psnrs}")
        total = dict(got)
        ckpt = tr.ckpt.path(tr.ckpt.latest_step())
        result_dir = os.path.join(tmp, "result")
        zero()
        t0 = time.perf_counter()
        metrics_path = tto_cli.main(["--ckpt", ckpt, "--result_dir", result_dir, "--group_size", str(n_test),
                                     "--batch_size", "1024", "--pose_epochs", "1", "--appearance_epochs", "1",
                                     "--device", "cuda"])
        torch.cuda.synchronize()
        got = read()
        steps_a = -(-(W // 2) * (H // 2) // 1024)  # a pose epoch's steps; an appearance epoch's max(1, steps_a // 2)
        tto_steps = steps_a + max(1, steps_a // 2)
        print(f"[30 a] cli.tto ({n_test} test JPEGs at downscale 2, {tto_steps} steps): {time.perf_counter() - t0:.1f}"
              f" s, launches {got}", flush=True)
        check(got["render_frozen"] == tto_steps and got["render_bwd"] == 0 and got["dw"] == 0
              and got["render_fwd"] >= 2 * tto_steps and got["render_fwd"] % 2 == 0
              and all(v == 0 for k, v in got.items() if k not in ("render_fwd", "render_frozen", "walk_pre", "walk",
                                                                    "walk_finish")),
              f"[30 a] TTO launches {got}: 2 forwards and 1 frozen backward a step, 2 forwards an eval chunk")
        total = {k: total[k] + v for k, v in got.items()}
        with open(metrics_path) as f:
            m = json.load(f)
        check(len(m) == n_test and all(np.isfinite(v["psnr"]) and np.isfinite(v["ssim"]) for v in m.values()),
              f"[30 a] TTO metrics {m}")
        ev = eval_cli.main(["--ckpt", ckpt, "--result_dir", result_dir, "--device", "cuda"])
        check(all(np.isfinite(v) for v in ev.values()), f"[30 a] eval printed non-finite numbers: {ev}")
        print(f"[30 a] cli.eval: {ev}; the phase's launches {total}, flash {flash} ({card})", flush=True)

        # (b) the host codec, and the scene's load from its JPEGs and from the cache
        codec = host_codec_times(tmp, card)
        hp = dict(tr.hp)
        loads = {}
        for label, cached in (("JPEGs", False), ("cache", True)):
            t0 = time.perf_counter()
            scene_np, store_np, _ = load_training_data(dict(hp, **{"phototourism.use_cache": cached}))
            loads[label] = time.perf_counter() - t0
        n_rays = store_np["px"].shape[0]
        check(n_rays == n_train * (W // 2) * (H // 2), f"[30 b] {n_rays} rays loaded")
        print(f"[30 b] load_training_data of (a)'s scene ({n_train} train JPEGs of {W}x{H} at downscale 2, {n_rays}"
              f" rays, {DINO_DIM}-d maps): from the JPEGs {loads['JPEGs']:.2f} s, from the cache {loads['cache']:.2f}"
              f" s (host clock) ({card})", flush=True)

        # (c) the fixtures
        n_fixtures = check_jpeg_fixtures()
    check("PIL" not in sys.modules, "[30] PIL was imported")
    print(f"[30] JPEG scenes: {time.perf_counter() - t_phase:.1f} s; PIL not imported; {n_fixtures} fixtures;"
          f" decode {codec['decode']:.1f} ms, encode {codec['encode']:.1f} ms, scene load {loads['JPEGs']:.2f} s"
          f" ({card})", flush=True)
    return dict(total, flash=flash)


def kernel_times(dev, card: str, profile_dir=None) -> dict:
    """--kernel_times: the F = 384 kernels of phases 5, 9, 12, 14, 16, 17 and
    19, the recompute train (phase 1) and frozen (phase 2) backward of phase
    22, and the flash-attention kernel of phase 10 alone, bf16, at those
    phases' shapes; and the float32 backward of kernels 5 and 6 (524,288 rows)
    and kernel 2's float32 train modes, saved chain and recompute (2048 x 256,
    phase 1) (CUDA events, 5 launches after a warm-up; 20 for flash attention), with no
    checks: the numbers to compare two trees on one card. In a tree that has
    the forward's timing variants (render_train.FWD_DESIGNS), the forward of
    phases 5, 9 and 17 also in the variant's design (the mma.sync design the
    wgmma kernel replaced); in a tree with the backward's
    (render_train.BWD_DESIGNS), the backward of phases 9 and 12 also in the
    mma.sync walk the Hopper walk replaced; in a tree with the heads
    forward's (heads.HEADS_FWD_DESIGNS), the forward of phases 14 and 16 also
    in the mma.sync design wg_fwd_kernel replaced; the probe's three chains
    of phase 25, and in a tree with mxu_probe.PROBE_DESIGNS also in the
    mma.sync design wg_probe_kernel replaced. Uses only wrappers
    that trees with kernels 4 and 5 already had, so the script can be copied
    into an older tree's root and run there, the trees in turns. With
    profile_dir, then a torch.profiler table of 5 flash-attention calls there,
    and each of its kernels' device ms per call printed."""
    from upnerf_torch.models.nerf import NeRFConfig, NeRFField, positional_encoding
    from upnerf_torch.ops import attention
    from upnerf_torch.ops import heads as hk
    from upnerf_torch.ops import mlp
    from upnerf_torch.ops import mxu_probe as mp
    from upnerf_torch.ops import render as srk
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.render.render_rays import field_weights

    nerf_cfg = NeRFConfig.from_hparams(BRANDENBURG_GATE)
    field = NeRFField(nerf_cfg, generator=torch.Generator().manual_seed(0)).to(dev).requires_grad_(False)
    trunk, heads = field_weights(field)
    o, d, z, pe_w, cond, c_emb = chunk_inputs(field, 256, seed=9, dev=dev)
    st1, st2 = train_static(nerf_cfg, "bfloat16", 1), train_static(nerf_cfg, "bfloat16", 2)
    h1, h2 = {k: heads[k] for k in st1.head_keys}, {k: heads[k] for k in st2.head_keys}
    hs = {k: heads[k] for k in srk.HEAD_KEYS}
    x0 = rt._pe(o, d, z, pe_w, nerf_cfg.xyz_L)[0].contiguous()
    n = TRAIN_RAYS * 256
    g = torch.Generator(device=dev).manual_seed(16)
    xr = positional_encoding(torch.randn((n, 3), generator=g, device=dev), nerf_cfg.xyz_L).contiguous()
    cr = torch.randn((n, nerf_cfg.candidate_dim), generator=g, device=dev)
    tk, hd = field.trunk_heads_weights(True)
    hargs = (xr, cr, tk, hd, nerf_cfg.skips, "bfloat16")
    tp = [(lay.weight.t(), lay.bias) for lay in field.trunk_layers()]
    with torch.no_grad():
        out, res = rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, h1, st1, c_emb=c_emb, save_res=True)
        cots = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out.items()}
        out2, res2 = rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, h2, st2, save_res=True)
        cots2 = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out2.items()}
        frozen = st2._replace(param_grads=False)
        # the recompute mode (phase 22's timings): its own forward's residuals, the same cotangents
        st1r, st2r = st1._replace(save_chain=False), st2._replace(save_chain=False)
        _, res_r = rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, h1, st1r, c_emb=c_emb, save_res=True)
        _, res2_r = rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, h2, st2r, save_res=True)
        frozen_r = st2r._replace(param_grads=False)
        hcots = [torch.randn(t.shape, generator=g, device=dev) for t in hk.fused_trunk_heads_fwd(*hargs)]
        tcot = torch.randn((n, nerf_cfg.W), generator=g, device=dev)
        # kernel 2's float32 train modes at phase 26's 2048 x 256, phase 1
        o2, d2, z2, pe2, cond2, ce2 = chunk_inputs(field, 256, seed=26, dev=dev, R=TRAIN_RAYS)
        st1f = train_static(nerf_cfg, "float32", 1)
        st1fr = st1f._replace(save_chain=False)
        f_args = (o2, d2, z2, pe2, cond2, trunk, h1)
        out_f, res_f = rt.render_train_rays_fwd(*f_args, st1f, c_emb=ce2, save_res=True)
        _, res_fr = rt.render_train_rays_fwd(*f_args, st1fr, c_emb=ce2, save_res=True)
        cots_f = {k: torch.randn(v.shape, generator=g, device=dev) for k, v in out_f.items()}
        calls = {
            "render_train_fwd, serving mode (phase 5)": lambda: rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, h2,
                                                                                         st2),
            "render_train_fwd (phase 9)": lambda: rt.render_train_rays_fwd(o, d, z, pe_w, cond, trunk, h1, st1,
                                                                           c_emb=c_emb, save_res=True),
            "render_train_bwd (phase 9)": lambda: rt.render_train_rays_bwd(o, d, z, pe_w, cond, trunk, h1, st1, c_emb,
                                                                           res, cots),
            "render_train_bwd_frozen (phase 12)": lambda: rt.render_train_rays_bwd(o, d, z, pe_w, cond, trunk, h2, frozen,
                                                                                   None, res2, cots2),
            "render_train_bwd, recompute mode (phase 22)": lambda: rt.render_train_rays_bwd(
                o, d, z, pe_w, cond, trunk, h1, st1r, c_emb, res_r, cots),
            "render_train_bwd_frozen, recompute mode (phase 22)": lambda: rt.render_train_rays_bwd(
                o, d, z, pe_w, cond, trunk, h2, frozen_r, None, res2_r, cots2),
            "trunk_fwd (phase 14)": lambda: mlp.fused_trunk(xr[:PROBE_ROWS], tp, nerf_cfg.skips, "bfloat16"),
            "heads_fwd (phase 16)": lambda: hk.fused_trunk_heads_fwd(*hargs),
            "heads_bwd (phase 16)": lambda: hk.fused_trunk_heads_bwd(*hargs, hcots),
            "trunk_bwd (phase 19)": lambda: mlp.fused_trunk_bwd(xr, tk, nerf_cfg.skips, "bfloat16", tcot),
            "heads_bwd float32 (phase 16)": lambda: hk.fused_trunk_heads_bwd(*hargs[:5], "float32", hcots),
            "trunk_bwd float32 (phase 19)": lambda: mlp.fused_trunk_bwd(xr, tk, nerf_cfg.skips, "float32", tcot),
            "render_train_bwd float32, 2048 x 256 (phase 26)": lambda: rt.render_train_rays_bwd(
                *f_args, st1f, ce2, res_f, cots_f),
            "render_train_bwd float32, recompute mode, 2048 x 256 (phase 26)": lambda: rt.render_train_rays_bwd(
                *f_args, st1fr, ce2, res_fr, cots_f),
            "static_render (phase 17)": lambda: srk.fused_static_render_fwd(x0, z, cond, trunk, hs, nerf_cfg.skips,
                                                                             "bfloat16"),
        }
        if hasattr(rt, "FWD_DESIGNS"):  # a tree with the forward's timing variants: time them too
            sargs = (o, d, z, pe_w, cond, trunk, h2, st2)
            fargs = (o, d, z, pe_w, cond, trunk, h1, st1)
            for des in rt.FWD_DESIGNS[1:]:
                calls[f"render_train_fwd, serving mode (phase 5), {des} design"] = (
                    lambda des=des: fwd_call(des, sargs))
                calls[f"render_train_fwd (phase 9), {des} design"] = (
                    lambda des=des: fwd_call(des, fargs, c_emb, True))
                calls[f"static_render (phase 17), {des} design"] = (
                    lambda des=des: fwd_call(des, (o, d, z, pe_w, cond, trunk, hs, st2), x0=x0))
        if hasattr(hk, "HEADS_FWD_DESIGNS"):  # a tree with the heads forward's timing variant: the replaced design
            for des in hk.HEADS_FWD_DESIGNS[1:]:
                calls[f"trunk_fwd (phase 14), {des} design"] = (lambda des=des: hk.fused_trunk_heads_fwd_launch(
                    xr[:PROBE_ROWS], None, tp, None, nerf_cfg.skips, "bfloat16", des))
                calls[f"heads_fwd (phase 16), {des} design"] = (
                    lambda des=des: hk.fused_trunk_heads_fwd_launch(*hargs, des))
        if hasattr(rt, "BWD_DESIGNS"):  # a tree with the backward's timing variant: the replaced walk too
            bargs = (o, d, z, pe_w, cond, trunk)
            for des in rt.BWD_DESIGNS[1:]:
                calls[f"render_train_bwd (phase 9), {des} design"] = (
                    lambda des=des: rt.render_train_rays_bwd_launch(*bargs, h1, st1, c_emb, res, cots, des).run())
                calls[f"render_train_bwd_frozen (phase 12), {des} design"] = (
                    lambda des=des: rt.render_train_rays_bwd_launch(*bargs, h2, frozen, None, res2, cots2, des).run())
        # the probe's chains at phase 25's shapes: the route with the weights packed as it reads them, and in a
        # tree with the probe's timing variant (mxu_probe.PROBE_DESIGNS) the mma.sync design wg_probe_kernel replaced
        M, W, L, G = PROBE_SHAPE
        px, pws, pb, pws_i8 = (torch.from_numpy(a).to(dev) for a in mp.probe_inputs(M, W, L, seed=0))
        for chain in mp.CHAINS:
            w = pws_i8 if chain == "int8" else pws
            if hasattr(mp, "PROBE_DESIGNS"):
                pk = mp.kernel_weights(w, chain)
                for des in mp.PROBE_DESIGNS[1:]:
                    pd = mp.kernel_weights(w, chain, des)
                    calls[f"mxu_probe {chain} (phase 25), {des} design"] = (
                        lambda w=w, chain=chain, des=des, pd=pd: mp.mxu_probe_launch(px, w, pb, chain, G, pd, des))
            else:
                pk = mp.pack_weights(w if chain == "int8" else w.to(torch.bfloat16))
            calls[f"mxu_probe {chain} (phase 25)"] = (
                lambda w=w, chain=chain, pk=pk: mp.mxu_probe(px, w, pb, chain, G, packed=pk))
        times = {name: cuda_ms(fn, 5) for name, fn in calls.items()}
        qa, ka, va = (torch.randn(DINO_HEADS, DINO_TOKENS, 64, generator=g, device=dev) for _ in range(3))
        times["flash_attn_fwd (phase 10)"] = cuda_ms(lambda: attention.flash_attention(qa, ka, va, scale=0.125), 20)
    print(json.dumps({"kernel_times_ms": times, "card": card}), flush=True)
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        with torch.no_grad(), torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                attention.flash_attention(qa, ka, va, scale=0.125)
            torch.cuda.synchronize()
        with open(os.path.join(profile_dir, "flash_attn_fwd.txt"), "w") as f:
            f.write(f"{card}\n{prof.key_averages().table(sort_by='cuda_time_total', row_limit=10)}\n")
        per_call = {e.key: e.device_time_total / 5 / 1e3 for e in prof.key_averages() if e.device_time_total > 0}
        print(json.dumps({"flash_attn_fwd_kernels_ms_per_call": per_call, "card": card}), flush=True)
    return times


def main() -> int:
    parser = argparse.ArgumentParser(description="Smoke test of upnerf_torch on one NVIDIA GPU.")
    parser.add_argument("--profile", default=None,
                        help="write torch.profiler tables of one phase-1 step, one TTO step and one fast frame here"
                             " (with --kernel_times: of 5 flash-attention calls)")
    parser.add_argument("--kernel_times", action="store_true",
                        help="only time the F = 384 kernels (no checks) and print them as one JSON line; to compare"
                             " two trees on one card, copy this script into each tree's root and run them in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a CUDA card", file=sys.stderr)
        return 2
    import upnerf_torch  # noqa: F401  (fails here when run outside the repository)
    if args.kernel_times:
        kernel_times(torch.device("cuda:0"), card_line(), args.profile)
        return 0
    from upnerf_torch.cli import render_video
    from upnerf_torch.evaluate.render import make_pose_renderer, render_image
    from upnerf_torch.geometry import rays as ray_utils
    from upnerf_torch.geometry import se3
    from upnerf_torch.models.nerf import NeRFConfig, NeRFField
    from upnerf_torch.ops import _build
    from upnerf_torch.ops import render_train as rt
    from upnerf_torch.render.render_rays import RenderConfig, field_weights, render_rays
    from upnerf_torch.utils.weights import init_reference_ckpt, load_reference_ckpt, render_params

    dev = torch.device("cuda:0")
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    print(card, flush=True)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    infos = _build.build()
    print(f"[2] nvcc, {len(infos)} sources in parallel: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in infos.items():
        print(f"    {name} -> {info.path.name}", flush=True)
        for line in info.log.splitlines():
            if "Function properties for" in line:  # the kernel the next lines describe, by its mangled name's tail
                print("      " + line.strip().split("cu_")[-1][:80], flush=True)
            if "registers" in line or "spill" in line or "(C75" in line:
                print("      " + line.strip()[:160], flush=True)
    # the heads forward's and the probe's wgmma instances: ptxas keeps their products asynchronous
    check("C7512" not in infos["heads_fwd"].log, "ptxas serialized the heads forward's wgmma (C7512)")
    check("C7512" not in infos["mxu_probe"].log, "ptxas serialized the probe's wgmma (C7512)")

    # 3. serving kernel against plain version, one chunk at full width
    nerf_cfg = NeRFConfig.from_hparams(BRANDENBURG_GATE)
    field = NeRFField(nerf_cfg, generator=torch.Generator().manual_seed(0)).to(dev).requires_grad_(False)
    # the same model at the validation configs' feature width (configs/validation/synth_*.yaml)
    nerf32 = nerf_cfg._replace(feat_dim=32)
    field32 = NeRFField(nerf32, generator=torch.Generator().manual_seed(32)).to(dev).requires_grad_(False)
    errs, inputs = {}, {}
    for S in (64, 100, 128, 256):
        inputs[S] = chunk_inputs(field, S, seed=S, dev=dev)[:5]
        for prec in ("float32", "bfloat16"):
            st = rt.RTStatic(D=nerf_cfg.D, skips=nerf_cfg.skips, xyz_L=nerf_cfg.xyz_L, precision=prec)
            trunk, heads = field_weights(field)
            with torch.no_grad():
                got = rt.render_train_rays_fwd(*inputs[S], trunk, heads, st)
                want = rt.render_train_rays_plain(*inputs[S], trunk, heads, st)
                again = rt.render_train_rays_fwd(*inputs[S], trunk, heads, st)
            torch.cuda.synchronize()
            check(all(torch.equal(got[k], again[k]) for k in got), f"two calls of the kernel differ (S={S} {prec})")
            for k, v in got.items():
                check(bool(torch.isfinite(v).all()), f"kernel output {k} not finite (S={S}, {prec})")
            e = {
                "rgb_map": (got["rgb_map"] - want["rgb_map"]).abs().max().item(),
                "s_weights": (got["s_weights"] - want["s_weights"]).abs().max().item(),
                "s_depth_rel": ((got["s_depth"] - want["s_depth"]).abs() / want["s_depth"].abs()).max().item(),
            }
            errs[(S, prec)] = e
            print(f"[3] S={S} {prec}: max|d rgb_map| {e['rgb_map']:.3e}  max|d s_weights| {e['s_weights']:.3e}"
                  f"  max rel d s_depth {e['s_depth_rel']:.3e}  (tol {TOL[prec]:.0e})", flush=True)
            check(max(e.values()) <= TOL[prec], f"kernel disagrees with plain version at S={S} {prec}: {e}")

    # 4. the serving path through the CLI
    hp = dict(BRANDENBURG_GATE)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = init_reference_ckpt(os.path.join(tmp, "bg.ckpt"), hp, n_images=4, seed=0)
        out_dir = os.path.join(tmp, "video")
        argv = ["--ckpt", ckpt, "--out", out_dir, "--frames", "2", "--wh", str(FRAME_WH[0]), str(FRAME_WH[1]),
                "--focal", str(FOCAL), "--anchor", "1", "--device", "cuda"]
        n_chunks = FRAME_WH[0] * FRAME_WH[1] // CHUNK
        expected = 2 * n_chunks * 2
        rt.launches = 0
        t0 = time.perf_counter()
        written = render_video.main(argv)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        serve_launches = rt.launches
        print(f"[4] render_video: 2 frames {FRAME_WH[0]}x{FRAME_WH[1]} in {cli_s:.2f} s, kernel launches"
              f" {serve_launches} (expected 2 frames x {n_chunks} chunks x 2 passes = {expected})", flush=True)
        check(serve_launches == expected, f"kernel launched {serve_launches} times, expected {expected}")
        depth0 = None
        for png, npy in zip(written["frames"], written["depths"]):
            check(read_png_size(png) == FRAME_WH, f"{png} has the wrong size")
            depth = np.load(npy)
            check(depth.shape == FRAME_WH[::-1] and bool(np.isfinite(depth).all()), f"{npy}: bad depth")
            check(0.0 <= float(depth.min()) and float(depth.max()) <= 5.0 + 1e-3, f"{npy}: depth outside [0, far]")
            depth0 = depth if depth0 is None else depth0
        print(f"    frames ok: depth of frame 0 in [{depth0.min():.3f}, {depth0.max():.3f}]", flush=True)

        # rays of frame 0 on the card against the same rays on the CPU
        sd, hparams, _ = load_reference_ckpt(ckpt)
        rcfg = RenderConfig.from_hparams(hparams)._replace(perturb=0.0)
        cpu_params, se3_cpu = render_params(sd, nerf_cfg, "cpu")
        gpu_params, _ = render_params(sd, nerf_cfg, dev)
        anchor = se3.compose([se3.se3_to_SE3(se3_cpu[1]), torch.eye(3, 4)])
        pose0 = se3.get_novel_view_poses(anchor, N=2)[0]
        K = torch.tensor([[FOCAL, 0, FRAME_WH[0] / 2], [0, FOCAL, FRAME_WH[1] / 2], [0, 0, 1]])
        pix = torch.arange(0, FRAME_WH[0] * FRAME_WH[1], 256)  # 64 pixels spread over the frame
        dirs = ray_utils.pixel_directions(pix % FRAME_WH[0], pix // FRAME_WH[0], K)
        rays_o, rays_d = ray_utils.get_rays(dirs, pose0)
        rays = torch.cat([rays_o, rays_d, torch.tensor([[0.1, 5.0]]).expand(len(pix), 2)], -1)
        idx = torch.full((len(pix),), 1, dtype=torch.long)
        with torch.no_grad():
            on_cpu = render_rays(cpu_params, rcfg, rays, idx, det=True)
            on_gpu = render_rays(gpu_params, rcfg, rays.to(dev), idx.to(dev), det=True)
        d_rgb = (on_gpu["s_rgb_fine"].cpu() - on_cpu["s_rgb_fine"]).abs().max().item()
        d_dep = ((on_gpu["s_depth_fine"].cpu() - on_cpu["s_depth_fine"]).abs() / on_cpu["s_depth_fine"]).max().item()
        d_cli = float(np.abs(depth0.reshape(-1)[pix.numpy()] - on_gpu["s_depth_fine"].cpu().numpy()).max())
        print(f"    64 rays of frame 0, card vs CPU: max|d rgb| {d_rgb:.3e}  max rel d depth {d_dep:.3e}"
              f"  (tol {E2E_TOL:.0e}); CLI depth vs this render {d_cli:.3e}", flush=True)
        check(max(d_rgb, d_dep) <= E2E_TOL, "the card's render disagrees with the CPU render")
        check(d_cli <= E2E_TOL * 5.0, "the CLI's depth disagrees with a direct render")

    # 5. timings, plain and kernel in turns (plain, kernel, kernel, plain)
    times = {}
    for S in (128, 256):
        for prec in ("float32", "bfloat16"):
            st = rt.RTStatic(D=nerf_cfg.D, skips=nerf_cfg.skips, xyz_L=nerf_cfg.xyz_L, precision=prec)
            trunk, heads = field_weights(field)
            with torch.no_grad():
                plain = lambda: rt.render_train_rays_plain(*inputs[S], trunk, heads, st)  # noqa: E731
                kern = lambda: rt.render_train_rays_fwd(*inputs[S], trunk, heads, st)  # noqa: E731
                p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kern), cuda_ms(kern), cuda_ms(plain)
            times[(S, prec)] = ((k1 + k2) / 2, (p1 + p2) / 2)
            print(f"[5] S={S} {prec}: kernel {times[(S, prec)][0]:.2f} ms  plain {times[(S, prec)][1]:.2f} ms"
                  f" per {CHUNK}-ray chunk ({card})", flush=True)
    renderer = make_pose_renderer(rcfg, chunk=CHUNK)
    pose_np, K_np = pose0.numpy(), K.numpy()
    render_image(renderer, gpu_params, K_np, pose_np, FRAME_WH, [0.1, 5.0], 1, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        render_image(renderer, gpu_params, K_np, pose_np, FRAME_WH, [0.1, 5.0], 1, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) / reps * 1e3
    print(f"[5] frame {FRAME_WH[0]}x{FRAME_WH[1]} end to end (render_image, bfloat16): {frame_ms:.1f} ms"
          f" ({FRAME_WH[0] * FRAME_WH[1] / frame_ms * 1e3:.0f} rays/s) ({card})", flush=True)
    fwd_designs = phase_fwd_designs([(field, nerf_cfg), (field32, nerf32)], dev, card)
    print(f"    phases 1-5: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 6 + 7. training modes of the forward kernel, and the backward kernel, at F = 384 and 32
    fwd_err, _, bwd_abs = phase_train_kernels(field, nerf_cfg, dev, samples=(64, 100, 128, 256))
    fwd_err32, _, bwd_abs32 = phase_train_kernels(field32, nerf32, dev, samples=(256,))
    fwd_err, bwd_abs = max(fwd_err, fwd_err32), max(bwd_abs, bwd_abs32)
    print(f"    phases 6-7: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 8 + 9. the flagship train step
    launches, step_ms, step_peaks = phase_train_step(dev, card, args.profile)
    kt, dw_err, dw_lay = phase_bwd_timing(field, nerf_cfg, dev, card)
    dw_err = max(dw_err, phase_bwd_timing(field32, nerf32, dev, card)[1])
    print(f"    phases 8-9: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 10 + 11. the flash-attention kernel and the offline extractors
    attn_err, attn_ms, attn_plain_ms, attn_lib_ms = phase_flash_kernel(dev, card)
    attn_launches = phase_extractors(dev, card)
    print(f"    phases 10-11: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 12-15. the frozen backward, TTO -> eval, the trunk kernel, fast serving renders
    frozen_err, frozen_ms, train_mode_ms, frozen_plain_ms = phase_frozen_bwd(field, nerf_cfg, dev, card)
    frozen_launches, tto_ms, _ = phase_tto_eval(dev, card, args.profile)
    trunk_err, trunk_ms, trunk_plain_ms = phase_trunk_kernel(field, nerf_cfg, dev, card)
    trunk_launches, _ = phase_fast_render(dev, card, frame_ms, pose_np, args.profile)
    print(f"    phases 12-15: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 16-18. kernel 5 (trunk + heads), kernel 4 (the static render from PE rows), the train CLI; 16, 17 at F = 32 too
    heads_fwd_err, heads_bwd_err, heads_t = phase_heads_kernel(field, nerf_cfg, dev, card)
    e32 = phase_heads_kernel(field32, nerf32, dev, card, pieces=False,
                             cases=[(TRAIN_RAYS * 256, "bfloat16", True), (65536, "float32", True),
                                    (1037, "float32", False)])
    heads_fwd_err, heads_bwd_err = max(heads_fwd_err, e32[0]), max(heads_bwd_err, e32[1])
    static_err, static_ms, static_plain_ms = phase_static_render(field, nerf_cfg, dev, card)
    static_err = max(static_err, phase_static_render(field32, nerf32, dev, card)[0])
    train_launches, _ = phase_train_cli(dev, card, step_ms)
    print(f"    phases 16-18: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 19-21. kernel 6's backward, the feature-less field through the CLIs, synth_pose at F = 32
    trunk_bwd_err, trunk_bwd_ms, trunk_bwd_plain_ms = phase_trunk_bwd(field, nerf_cfg, dev, card)
    featureless_launches = phase_featureless(dev, card, step_ms)
    phase_synth_pose(dev, card)
    print(f"    phases 19-21: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 22-23. the recompute mode (save_chain=False), and the memory-saving configuration end to end
    rec_t, rec_fwd_err, rec_bwd_err, rec_frozen_err = phase_recompute_kernels([(field, nerf_cfg), (field32, nerf32)],
                                                                              dev, card)
    mem_launches, _, _ = phase_memory_saving(dev, card, step_ms, step_peaks, tto_ms)
    print(f"    phases 22-23: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 24-25. kernel 1b (the fused render from PE rows, training modes and d_x0) and the matrix-unit probe
    x0_t, x0_fwd_err, x0_bwd_err, x0_launches, _ = phase_x0_kernels([(field, nerf_cfg), (field32, nerf32)], dev, card)
    probe_err, probe_launches, probe = phase_mxu_probe(dev, card)
    phase_run_to_run(field, nerf_cfg, dev)
    print(f"    phases 24-26: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 27. the pose-warp mitigations (the scorer on kernels 1 and 5) and the optimizer kinds, through cli.train
    warp_launches = phase_warp(dev, card)
    print(f"    phase 27: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 28. data parallel: two ranks on the card against one, a one-rank NCCL group, two cli.train processes
    dp_launches = phase_data_parallel(dev, card)
    print(f"    phase 28: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 29. the quality-protocol drivers (pose recovery, TTO success) at cut lengths
    pr_launches = phase_protocols(dev, card)
    print(f"    phase 29: {time.perf_counter() - t_start:.0f} s", flush=True)

    # 30. JPEG scenes: preprocess -> prepare_cache -> train -> TTO -> eval on the generator's JPEGs, the host
    # codec's times, the fixtures PIL wrote
    jpeg_launches = phase_jpeg_scenes(dev, card)
    print(f"    phase 30: {time.perf_counter() - t_start:.0f} s", flush=True)

    # the least time the card could take for each timed call, from its shapes
    flash_terms = flash_bound_terms(DINO_HEADS, DINO_TOKENS)
    st1 = train_static(nerf_cfg, "bfloat16", 1)
    st2 = train_static(nerf_cfg, "bfloat16", 2)._replace(param_grads=False)
    bounds = {
        "render_train_fwd": render_bound(field, st1, CHUNK, 256, "fwd"),
        "render_train_fwd, serving mode (phase 5)": render_bound(field, st2, CHUNK, 256, "serve"),
        "render_train_bwd": render_bound(field, st1, CHUNK, 256, "bwd"),
        "dw_gemm": bound(*dw_work(dw_lay, CHUNK, 256), "bfloat16"),
        "render_train_bwd_frozen": render_bound(field, st2, CHUNK, 256, "bwd"),
        "flash_attn_fwd": (max(flash_terms.values()),
                           "bytes" if max(flash_terms, key=flash_terms.get) == "bytes" else "operations"),
        "trunk_fwd": trunk_fwd_bound(field, nerf_cfg, PROBE_ROWS),
    }
    heads_rows = TRAIN_RAYS * 256
    bounds["heads_fwd"] = heads_bound(field, nerf_cfg, heads_rows, True, "fwd")
    bounds["heads_bwd"] = heads_bound(field, nerf_cfg, heads_rows, True, "bwd")
    bounds["static_render"] = render_bound(field, st2, CHUNK, 256, "static")
    bounds["trunk_bwd"] = trunk_bwd_bound(field, nerf_cfg, TRAIN_RAYS * 256)
    bounds["rec_fwd"] = render_bound(field, st1._replace(save_chain=False), CHUNK, 256, "fwd")
    bounds["rec_bwd"] = render_bound(field, st1._replace(save_chain=False), CHUNK, 256, "recompute")
    bounds["rec_frozen"] = render_bound(field, st2._replace(save_chain=False), CHUNK, 256, "recompute")
    in0 = nerf_cfg.in_channels_xyz
    bounds["x0_fwd"] = render_bound(field, st1, CHUNK, 256, "fwd", x0_in0=in0)
    bounds["x0_bwd"] = render_bound(field, st1, CHUNK, 256, "bwd", x0_in0=in0)
    for chain in ("pure", "epi", "int8"):
        bounds[f"probe_{chain}"] = probe_bound(*PROBE_SHAPE, chain)
    st1_32 = train_static(nerf32, "bfloat16", 1)
    st2_32 = train_static(nerf32, "bfloat16", 2)._replace(param_grads=False)
    bounds.update({  # the F = 32 instances at the same shapes (printed only)
        "render_train_fwd, F=32": render_bound(field32, st1_32, CHUNK, 256, "fwd"),
        "render_train_bwd, F=32": render_bound(field32, st1_32, CHUNK, 256, "bwd"),
        "heads_fwd, F=32": heads_bound(field32, nerf32, heads_rows, True, "fwd"),
        "heads_bwd, F=32": heads_bound(field32, nerf32, heads_rows, True, "bwd"),
        "static_render, F=32": render_bound(field32, st2_32, CHUNK, 256, "static"),
        # kernel 1b at the benchmark's 2048 x 384, the saved chain (printed only)
        "x0_fwd, 2048 x 384": render_bound(field, st1, TRAIN_RAYS, 384, "fwd", x0_in0=in0),
        "x0_bwd, 2048 x 384": render_bound(field, st1, TRAIN_RAYS, 384, "bwd", x0_in0=in0),
    })
    for name, (ms, by) in bounds.items():
        print(f"    bound of {name}: {ms:.3f} ms ({by})", flush=True)

    print(json.dumps({"kernels": [
        {
            "name": "render_train_fwd (wg_kernel: wgmma, weights staged by TMA)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_fwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:555",
            "launches": launches["render_train_fwd"] + warp_launches["render_fwd"] + dp_launches["render_fwd"]
            + pr_launches["render_fwd"] + jpeg_launches["render_fwd"],
            "max_abs_err": max(fwd_err, max(max(e["rgb_map"], e["s_weights"]) for e in errs.values())),
            "ms": kt["fwd"][0],
            "plain_ms": kt["fwd"][1],
            "bound_ms": bounds["render_train_fwd"][0],
            "bound_by": bounds["render_train_fwd"][1],
            "library_ms": None,
        },
    ] + [
        {
            "name": f"render_train_bwd {label}",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_bwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:671",
            "launches": launches[key] + dp_launches[key] + pr_launches[key] + jpeg_launches[key],
            "max_abs_err": kt["walk_kernels"][piece][2],
            "ms": kt["walk_kernels"][piece][0],
            "plain_ms": kt["walk_kernels"][piece][1],
            "bound_ms": kt["walk_bounds"][piece][0],
            "bound_by": kt["walk_bounds"][piece][1],
            "library_ms": None,
        }
        for piece, key, label in (("pre", "walk_pre", "pre-pass (pre_kernel: compositing, mask bits)"),
                                  ("walk", "walk", "walk (walk_kernel: wgmma over the weight stream)"),
                                  ("finish", "walk_finish", "finishing pass (finish_kernel: per-ray sums)"))
    ] + [
        {
            "name": "render_train_bwd (per slab: pre-pass, walk, finishing pass, dw_gemm)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_bwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:671",
            "launches": launches["render_train_bwd"] + dp_launches["render_bwd"] + pr_launches["render_bwd"]
            + jpeg_launches["render_bwd"],
            "max_abs_err": bwd_abs,
            "ms": kt["bwd"][0],
            "plain_ms": kt["bwd"][1],
            "bound_ms": bounds["render_train_bwd"][0],
            "bound_by": bounds["render_train_bwd"][1],
            "library_ms": None,
        },
        {
            "name": "dw_gemm",
            "route": "cuda",
            "source": "upnerf_torch/csrc/dw_gemm.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:822",
            "launches": launches["dw_gemm"] + dp_launches["dw"] + pr_launches["dw"] + jpeg_launches["dw"],
            "max_abs_err": dw_err,
            "ms": kt["dw"][0],
            "plain_ms": kt["dw"][1],
            "bound_ms": bounds["dw_gemm"][0],
            "bound_by": bounds["dw_gemm"][1],
            "library_ms": kt["dw"][2],
        },
        {
            "name": "render_train_bwd_frozen",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_bwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:671",
            "launches": frozen_launches + pr_launches["render_frozen"] + jpeg_launches["render_frozen"],
            "max_abs_err": frozen_err,
            "ms": frozen_ms,
            "plain_ms": frozen_plain_ms,
            "bound_ms": bounds["render_train_bwd_frozen"][0],
            "bound_by": bounds["render_train_bwd_frozen"][1],
            "library_ms": None,
        },
        {
            "name": "flash_attn_fwd",
            "route": "cuda",
            "source": "upnerf_torch/csrc/flash_attn_fwd.cu",
            "replaces": "upnerf/ops/pallas_attention.py:41",
            "launches": attn_launches + jpeg_launches["flash"],
            "max_abs_err": attn_err,
            "ms": attn_ms,
            "plain_ms": attn_plain_ms,
            "bound_ms": bounds["flash_attn_fwd"][0],
            "bound_by": bounds["flash_attn_fwd"][1],
            "library_ms": attn_lib_ms,
        },
        {
            "name": "heads_fwd, trunk-only mode (wg_fwd_kernel: wgmma over the weight stream)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/heads_fwd.cu",
            "replaces": "upnerf/ops/pallas_mlp.py:58",
            "launches": trunk_launches,
            "max_abs_err": trunk_err,
            "ms": trunk_ms,
            "plain_ms": trunk_plain_ms,
            "bound_ms": bounds["trunk_fwd"][0],
            "bound_by": bounds["trunk_fwd"][1],
            "library_ms": None,
        },
        {
            "name": "heads_fwd (wg_fwd_kernel: wgmma over the weight stream, TMA stores)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/heads_fwd.cu",
            "replaces": "upnerf/ops/pallas_heads.py:93",
            "launches": train_launches["heads_fwd"] + warp_launches["heads_fwd"],
            "max_abs_err": heads_fwd_err,
            "ms": heads_t["fwd"][0],
            "plain_ms": heads_t["fwd"][1],
            "bound_ms": bounds["heads_fwd"][0],
            "bound_by": bounds["heads_fwd"][1],
            "library_ms": None,
        },
        {
            "name": "heads_bwd",
            "route": "cuda",
            "source": "upnerf_torch/csrc/heads_bwd.cu",
            "replaces": "upnerf/ops/pallas_heads.py:120",
            "launches": train_launches["heads_bwd"],
            "max_abs_err": heads_bwd_err,
            "ms": heads_t["bwd"][0],
            "plain_ms": heads_t["bwd"][1],
            "bound_ms": bounds["heads_bwd"][0],
            "bound_by": bounds["heads_bwd"][1],
            "library_ms": None,
        },
        {
            "name": "heads_bwd, trunk-only mode",
            "route": "cuda",
            "source": "upnerf_torch/csrc/heads_bwd.cu",
            "replaces": "upnerf/ops/pallas_mlp.py:88",
            "launches": featureless_launches["trunk_bwd"],
            "max_abs_err": trunk_bwd_err,
            "ms": trunk_bwd_ms,
            "plain_ms": trunk_bwd_plain_ms,
            "bound_ms": bounds["trunk_bwd"][0],
            "bound_by": bounds["trunk_bwd"][1],
            "library_ms": None,
        },
        {
            "name": "render_train_fwd, x0 mode (static render; wg_kernel)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_fwd.cu",
            "replaces": "upnerf/ops/pallas_render.py:118",
            "launches": train_launches["static"],
            "max_abs_err": static_err,
            "ms": static_ms,
            "plain_ms": static_plain_ms,
            "bound_ms": bounds["static_render"][0],
            "bound_by": bounds["static_render"][1],
            "library_ms": None,
        },
        {
            "name": "render_train_fwd, recompute mode (residuals without a chain; wg_kernel)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_fwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:555",
            "launches": mem_launches["train"]["rec_fwd"],
            "max_abs_err": rec_fwd_err,
            "ms": rec_t["fwd"][0],
            "plain_ms": rec_t["fwd"][1],
            "bound_ms": bounds["rec_fwd"][0],
            "bound_by": bounds["rec_fwd"][1],
            "library_ms": None,
        },
        {
            "name": "render_train_bwd, recompute mode (per slab: wg_kernel rebuild + walk + dw_gemm)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_bwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:671",
            "launches": mem_launches["train"]["rec_bwd"],
            "max_abs_err": rec_bwd_err,
            "ms": rec_t["bwd"][0],
            "plain_ms": rec_t["bwd"][1],
            "bound_ms": bounds["rec_bwd"][0],
            "bound_by": bounds["rec_bwd"][1],
            "library_ms": None,
        },
        {
            "name": "render_train_bwd_frozen, recompute mode (per slab: wg_kernel rebuild + walk)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_bwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:671",
            "launches": mem_launches["tto"]["rec_frozen"],
            "max_abs_err": rec_frozen_err,
            "ms": rec_t["frozen"][0],
            "plain_ms": rec_t["frozen"][1],
            "bound_ms": bounds["rec_frozen"][0],
            "bound_by": bounds["rec_frozen"][1],
            "library_ms": None,
        },
        {
            "name": "render_train_x0_fwd (wg_kernel)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_fwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:555",
            "launches": x0_launches["x0_fwd"],
            "max_abs_err": x0_fwd_err,
            "ms": x0_t[("fwd", CHUNK, 256)][0],
            "plain_ms": x0_t[("fwd", CHUNK, 256)][1],
            "bound_ms": bounds["x0_fwd"][0],
            "bound_by": bounds["x0_fwd"][1],
            "library_ms": None,
        },
        {
            "name": "render_train_x0_bwd",
            "route": "cuda",
            "source": "upnerf_torch/csrc/render_train_bwd.cu",
            "replaces": "upnerf/ops/pallas_render_train.py:671",
            "launches": x0_launches["x0_bwd"],
            "max_abs_err": x0_bwd_err,
            "ms": x0_t[("bwd", CHUNK, 256)][0],
            "plain_ms": x0_t[("bwd", CHUNK, 256)][1],
            "bound_ms": bounds["x0_bwd"][0],
            "bound_by": bounds["x0_bwd"][1],
            "library_ms": None,
        },
    ] + [
        {
            "name": f"mxu_probe_{label} (wg_probe_kernel)",
            "route": "cuda",
            "source": "upnerf_torch/csrc/mxu_probe.cu",
            "replaces": f"scripts/bench_mxu_probe.py:{line}",
            "launches": probe_launches[f"probe_{chain}"],
            "max_abs_err": probe_err[chain],
            "ms": probe[chain]["ms"],
            "plain_ms": probe[chain]["plain_ms"],
            "bound_ms": bounds[f"probe_{chain}"][0],
            "bound_by": bounds[f"probe_{chain}"][1],
            "library_ms": None,
        }
        for chain, label, line in (("pure", "bf16", 48), ("epi", "epi", 58), ("int8", "int8", 98))
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
