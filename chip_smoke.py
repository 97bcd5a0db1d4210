#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing falls
back to the CPU):
  1. environment: versions, the card's name and power limit; TF32 off for
     the float32 references (phases 14, 17 and 19 set PyTorch's defaults
     again before the port's float32 set-up, which must turn both off);
  2. build: compile every kernel source in this checkout, one nvcc each, all
     started together; ptxas registers and spills of each instantiation;
     the HGMMA (wgmma) instructions in the SASS of every library;
  3. kernels: the no-max forward (K1/K2) against its plain PyTorch
     version at the sweep's shapes, X-ray's (phase 9: K2 at B24 H8 L16384
     D40, K1 at L4096 D80 and L1024 D160), PnP's injected q/k layout (phase
     11: one source row broadcast and materialised), masked key tails and
     the underflow edge; CUDA-event times of the kernel, the plain version and one PyTorch
     library call (a yardstick only), the kernel's and the library call's
     device times (torch.profiler), the least time the card could take,
     and beside it the exp2 work alone on the special-function units;
  4. slice: SD-v1.5 widths (UNet, VAE, CLIP ViT-L text) with random weights
     from a seed, bf16; make_submission + compute_submission over 2 labels x
     8 synthetic 512x512 images; every artifact checked; kernel launches
     counted over that run; one UNet pass in bf16 with the kernel held
     against the same pass in float32 through the plain attention; that
     pass's device busy time and the no-max kernel's share of it
     (torch.profiler); imgs/hr of that run and of one warm group of 8
     images at N=100;
  5. training kernels: K4 (flash forward with logsumexp), K5 (dq, and
     delta, held to attention_delta) and K6 (dk/dv) against their plain
     versions at the trainer's shapes (B4 H8
     L4096 D40, B4 H8 L1024 D80) and masked tails at D=40 and D=160, K4 at
     its own 128-key tiles (ONLINE_BLOCK_K), with times (each also by
     device time from a torch.profiler trace), scaled_dot_product_attention's
     forward (K4) and backward (K5+K6) as yardsticks, by events and device
     time, the port's whole backward (delta, the pre-scale, K5, K6) by
     device time beside sdpa's, and the bound;
  6. train: the places trainer at SD-v1.5 widths with random weights, bf16
     mixed precision, EMA, batch 4 of synthetic 512x512 images through the
     injected loader: BaseTrainer.training_init(); one forward+backward in
     bf16 with the kernels held against the same in float32 through the
     plain attention (level-0 to_q/to_k/to_v gradients at the seed's
     weights); 3 steps through its train_step (10 launches each of K4, K5,
     K6 a step); two steps traced with torch.profiler (the device's busy
     time a step, its idle share and the busy time by kernel category); two
     steps under full gradient checkpointing (20 of K4 each); loss finite,
     parameters and EMA moved; the export through end_training() read
     back; warm step ms, images/s and peak memory; then the trainer's
     --log_previews path, sample() + save_logs(): one category's grid of 2
     samples at 50 DDIM steps on the EMA weights (500 launches of K1);
  7. inference-mode kernels: K3 (online-softmax forward, no lse) at B8 H8
     L4096 D40, B8 H8 L1024 D80, B2 H8 L4096 D160 and a masked tail at
     D160, and on the underflow edge, where it stays the softmax; K7 (fused GroupNorm ->
     proj_in: the statistics kernel, then the normalise + projection
     kernel) at the four SpatialTransformer entry shapes of a 512px UNet
     pass at batch 8 in NCHW and channels-last input (the layout after a
     transformer), odd pixel counts in both layouts, the SiLU variant and
     data whose mean is large against its spread, its statistics held to
     group_stats_plain; each against its plain version, with times, the
     bound and the library yardsticks (scaled_dot_product_attention's
     forward for K3; F.group_norm plus a 1x1 F.conv2d, two calls, for K7)
     by events and device time; K3 at its own 128-key tiles; for K7 the
     device time of each of its two kernels (torch.profiler);
  8. mining: 2 labels x 24 synthetic 512x512 PNGs (cut from 64 in PR 12
     for the script's time) swept at N=4 through the
     sweep's own decoding, then Cluster.clustering("dift-161") with the CLI
     defaults twice: under the default modes (K1) and, on a freshly built
     bundle, under DIFFMINING_FUSED_NORM=1, DIFFMINING_FLASH_ONESHOT=0 and
     DIFFMINING_FLASH_NOMAX=0 (16 launches of K7 and 10 of K3 per UNet
     pass); one modes-on UNet pass against float32, with its device busy
     time and K7's part of it, the DIFT feature maps of the two modes
     against each other; every top patch in exactly one
     cluster, clusters sorted by median D, member crops written;
  9. xray (one SD-v1.5 bundle, random weights, bf16, for phases 9-11):
     XRayTypicality.main over 2 diseases x 4 synthetic 1024x1024 grayscale
     PNGs with synthetic metadata and bbox tables, N=6 (cut from 100 for
     time), chunk 3, groups of 4 (UNet batch 24): 5 launches of K2 (L=16384)
     and 10 of K1 (L=4096 D80, L=1024 D160) per UNet pass; pixel maps of the
     image's shape, finite, report.json and auc.json one finite value per
     image; one 1024px UNet pass (one cond/null pair) against float32
     through a query-chunked plain attention; imgs/hr at N=100 on one warm
     group of 4;
 10. sampling: sample_ddim at 512px (2 prompts, 50 steps, CFG 7.5; 500
     launches of K1), the VAE decode, one latent's decode against float32;
 11. pnp: Generator over 2 synthetic 512px sources (one in France, one in
     Japan): one inversion of the stack over 100 steps (cut from the
     reference's 999 for the script's time), the reconstruction,
     2 target prompts a source at 50 steps through the file protocol;
     launches of K1 and those on injected q/k counted; injection on against
     off; seconds per source image; K1 held on the injected q/k the path
     gave it. Its files stay for phase 13;
 12. train_lora_8bit (after phase 11): phase 6's trainer with
     --use_8bit_adam on the dense UNet (a cold and a warm step: int8
     moments, step ms, peak allocated beside phase 6's, the optimizer
     state's bytes), then with --lora --lora_rank 4 --use_8bit_adam: the
     level-0 attn1 factor gradients (b drawn nonzero) of the bf16+kernels
     pass against float32 through the plain attention; 2 steps, then 2
     under full gradient checkpointing, each launching 10 of K4 (20 under
     checkpointing), K5 and K6; only the factors and their EMA move, the
     base UNet bit for bit unchanged; the export equal to merge_lora of the
     EMA factors;
 13. parallel (a geo SD-v1.5 bundle, random weights, bf16, for phases
     13-14): phase 11's files as a parallel dataset (each source under its
     country), ParallelTypicality at N=4 (cut from 100 for time) over every
     ground-truth and translated file, then df_PD and
     ParallelCluster.clustering("dift-161"): rows from every source group,
     finite country-major embeddings, clusters ranked by median D, K1
     launches against the UNet and DIFT passes, the wall time;
 14. clip: first flash_fwd_f32 (the float32 forward of the CLIP towers) in
     both modes against its plain versions in float32, TF32 off: online
     (K3) at B8 H16 L1025 D64, no-max (K1/K2) at B2 H16 L4097 D64, and a
     masked key tail in each, with times, sdpa's float32 forward and the
     bound; then CLIPRankCluster at ViT-L/14-336 widths with the ViT-L/14
     text tower (random weights) on 2 countries x 16 synthetic 512px images,
     batch 8, the command's constants: at crop 336 (no attention reaches a
     kernel) tower images/s, the clustering wall, the device scoring path
     against the host path; at crop 448 (L 1025) clipmining end to end
     through the online mode, 24 launches a tower forward, tower images/s,
     tokens against the plain attention; at crop 896 (L 4097) one tower
     forward through the no-max mode, its largest logit; then cluster's
     clip+dift-161 mode over phase 8's top patches with a ViT-B/32-width
     tower (K1 only for DIFT);
 15. doersch: the Doersch baseline on 2 countries x 32 synthetic 512px geo
     images (cut from a dataset), how_many 256 (cut from 25,000), 64
     detectors (one chunk), 3 folds, the 25,000-row x 2112 negative pool and
     400 Adam steps: HOG ms/image, dense-search ms, SVM ms a fold, the
     total; the last fold's worst relative duality gap and objectives
     (printed); the relative duality gap at the production shape of
     tests/test_doersch.py (25,000 x 2112 rows, 1,250 planted positives)
     on its random 128px images (<= 0.02) and on this run's (printed); one
     dense search and one batched SVM against the same call on the CPU;
 16. verify_checkpoint on phase 12's SD-v1.5-width export: exit 0, PASS on
     convert, structure and forward;
 17. f32 sweep (run after phase 4): the sweep with --dtype fp32, an SD-v1.5
     bundle in float32 (random weights from the seed) over 2 labels x 4
     synthetic 512x512 images at N=4: 10 launches of the float32 no-max mode
     a UNet pass and none of a bf16 kernel; one UNet pass against the same
     pass through the plain attention (relative L2 <= 1e-4), its time and
     device busy share; one pass under DIFFMINING_FUSED_NORM=1 (16 launches
     of the float32 K7) against the module path;
 18. f32 UNet kernels (run after phase 5): flash_fwd_f32's no-max and
     online modes at B4 H8 L4096 D40, L1024 D80, L1024 D160, B1 H8 L16384
     D40 and masked tails (L1000 D40, L1100 D160); its lse mode (K4),
     flash_bwd_dq_f32 (K5, with delta) and flash_bwd_dkv_f32 (K6) at B4 H8
     L4096 D40, L1024 D80, B2 H8 L1100 D160 and Lq 1100 against Lk 300;
     gn_act_proj_f32 (K7) at the four SpatialTransformer entries of a 512px
     pass at batch 8 in both layouts: each against its plain version in
     float32 (TF32 off) within 2^-14 |plain| + 2^-14 rms, with times, device
     times, the bound and the library's float32 call (sdpa's forward or
     backward; F.group_norm + 1x1 F.conv2d);
 19. train f32 (run after phase 6): finetune --mixed_precision no, the
     places trainer at SD-v1.5 widths in float32, batch 2 at 512px: the
     level-0 to_q/to_k/to_v gradients with the float32 kernels against the
     plain attention (relative L2 <= 1e-4); 3 steps, 10 launches each of the
     float32 lse mode, K5 and K6 a step and none of a bf16 kernel; warm step
     ms and peak memory;
 17, 19 also: the float32 UNet pass at batch 8 (event and device busy
     time) and the float32 train step with cuDNN's TF32 on (PyTorch's
     default, where the float32 CLIs left it before the port turned it off)
     and off, in turns, one call unmeasured after each switch; how far TF32
     moves the sweep's artifacts;
 20. sweep dp (run after phase 16, on phase 12's SD-v1.5-width export):
     the typicality CLI in bf16 over 2 labels x 4 synthetic 512x512 PNGs at
     N=4 as a process, plain and as an NCCL group of one: artifacts
     bit-equal (or at most one fp16 ulp, the difference printed), K1
     launches; xray --mesh_dp 1 under torchrun, an NCCL group of one, over
     2 synthetic 1024px images: maps gathered over NCCL and written by rank
     0, K2 and K1 launches; two ranks of a gloo group on the card (dp 2,
     --dtype fp32, the library) against the plain CLI: every artifact
     written by one rank, within one fp16 ulp of one process at a rank's
     batch and within rtol 2e-3, atol 1e-4 of one at batch 4, the TF32
     flags after each process's set-up, the float32 no-max launches on each
     rank;
 21. mining dp (run after phase 20, on its images and bf16 tree and phase
     12's export, before the export is removed): five processes on the card
     together: the cluster command in bf16 (DIFT-161, E=8), plain and as
     `cluster --mesh_dp 1` under torchrun, an NCCL group of one whose DIFT
     goes through the all-reduce: embeddings and ranked clusters bit-equal,
     K1 launches; two ranks of a gloo group (dp 2, float32, the library,
     four draws a rank) against one process at float32: each embedding
     within rtol 1e-3, atol 2e-4, every pickle written once by rank 0, the
     TF32 flags, the float32 no-max launches on each rank; in the same
     processes ParallelCluster's DIFT over the mesh and dense_search at K =
     5 (padded to 6) over the two ranks against one process; DIFT images/s
     of each process (cold, five processes sharing the card);
 22. train dp (run after phase 21, on phase 12's export, before the export
     is removed): `finetune --mesh_dp 1` under torchrun, an NCCL group of
     one (the gradients through the bucketed all-reduce), and the plain
     finetune process, bf16, EMA, batch 4 at 512px, 6 steps, a checkpoint
     and an export each: losses, final parameters and EMA bit-equal, 10
     launches each of K4, K5 and K6 a step, warm step ms and the gradient
     all-reduce's ms; two ranks of a
     gloo group, float32, a global batch of 2, one step without a mesh,
     over dp 2 and over dp 1 x fsdp 2 (the optimizer state and the EMA
     sharded): dp 2 within 2·lr (99% within 1e-3·lr) of one process, fsdp 2
     bit-equal to it or within the spread of two one-process runs; each
     rank's state bytes and peak GiB.
 23. cmajor (run after phase 20, on its images and plain bf16 tree and
     phase 12's export): the channel-major transformer world
     (DIFFMINING_TF_CMAJOR=1). (a) The channel-major K1 and K3 (bf16) and
     flash_fwd_f32's channel-major no-max and online modes at the world's
     shapes (the 512px and 1024px passes, masked tails L1000 and L1100, the
     latter a misaligned bf16 length that goes through a padded copy), in
     both layouts ([B, H*D, L] and the JAX package's [H*D, B, L]): against
     the plain versions under the kernels' existing bounds and against the
     sequence-major kernels on contiguous copies; event and device ms, the
     plain version's ms, sdpa's and the bound on [B, H*D, L]. (b) One 512px
     UNet pass at batch 16 in bf16 in the channel-major world (10 launches
     of the channel-major K1, none of another kernel, no copy) against the
     normal world and the float32 normal world through the plain attention
     (relative L2 < 0.05); in float32 at batch 8 (10 of the float32
     channel-major no-max mode; under DIFFMINING_FLASH_ONESHOT=0 10 of its
     online mode) against the plain attention (< 1e-4); each pass's time and
     device busy time beside the normal world's. (c) One forward and
     backward at batch 2, bf16 autocast, channel-major: 10 each of K4, K5
     and K6, the level-0 attn1 projection gradients within 0.04 of the
     float32 normal world's. (d) The typicality CLI in bf16 under
     DIFFMINING_TF_CMAJOR=1 and under DIFFMINING_SWEEP_DEDUP=0 against phase
     20's plain run: every artifact written once, within 0.05 relative L2,
     the launches. (e) One 1024px pass at batch 2, channel-major: 5 K3 cm and
     10 K1 cm launches, against the normal world. (f) One pass in each world
     under DIFFMINING_ATTN_BACKEND=pallas in a process of its own: 32
     launches (every attention, cross-attention included) against auto.
 24. surface (run after phase 22, on phase 12's export): the port's last
     surface, each part a process of its own, side by side. (a)
     examples/run_tiny_pipeline_torch.py on the card: all nine stages of
     the tiny product line. (b) scripts_gpu/typicality.sh cars on 2 decades
     x 24 synthetic cars images at 256x384, 256x448 and 256x512 (K3 at L
     1536-2048 on a default path, no mode flag): the sweep at N 100, the
     clustering, the figures and the HTML; artifacts bit-equal to the
     typicality command run directly, 5 K3 launches a UNet pass. (c) The
     script with MESH_DP=1 (the sweep under torchrun, an NCCL group of one),
     bit-equal to (b). (d) scripts_gpu/convert_models.py: verify_checkpoint
     PASS. (e) K3 at the sweep's shapes against its plain version, with
     times, the bound and sdpa's.
Then one JSON line each for the slice, the float32 sweep, the training run,
the float32 training run, the mining runs,
X-ray, sampling, PnP, train_lora_8bit, parallel, clip, doersch,
verify_checkpoint, the sweep over dp, mining over dp, the trainer over dp,
the channel-major world and the surface, one of per-kernel numbers, and as
the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
PEAK_BF16_TFLOPS = 989.0  # H100 SXM dense bf16 tensor rate
PEAK_FP32_TFLOPS = 67.0  # H100 SXM float32 outside the tensor cores
PEAK_HBM_TBS = 3.35  # H100 SXM memory rate
# The special-function units issue 16 exp2 a clock per SM on Hopper; the SM
# count and the card's maximum SM clock are read in phase_environment.
EXP2_PER_CLOCK_PER_SM = 16
SM_COUNT = 0
SM_MAX_MHZ = 0.0
TRACE_CALLS = 20  # calls device_split reads from a trace
# calls it traces but does not read, before and after those: a trace late in
# a run can lose its first 7-8 kernel records, whatever its settle (at 5, one
# whole run on an H100 retraced 219 times, 139 of them in phase 18; at 10, 35)
TRACE_PAD = 10
TRACE_ATTEMPTS = 5  # traces it takes before it gives up
# Once every attempt of one measurement lost records, the profiler kept
# losing them for the rest of the process (two H100 runs: every later trace,
# 51 and 53 measurements; 164 retraces took 166 s of two phases): later
# measurements fall back at once, without a trace.
TRACES_LOST = False
TRACE_SETTLE_S = 0.2  # host wait between starting a trace and its first call; doubled at each retry
# kernel vs plain, elementwise: |got - want| <= RTOL |want| + ATOL_RMS rms(want).
# Both round the same fp32 result to bf16, so they differ by at most one bf16
# ulp of the element (<= 2^-7 relative) where summation order or ex2.approx
# flips a rounding; the atol, one ulp at the output's own scale, is margin
# near zero. A kernel that drops one 64-key tile is off by over 200x this.
# K3 and K4 are held to the same bound against their plain versions at the
# kernel's own key tiles (ONLINE_BLOCK_K, 128 keys; so p is rounded relative
# to the same running max). K5 and K6 round p and ds to bf16 inside their
# sums, at the same places as their plain versions; where ex2.approx or the
# summation order flips one of those roundings the fp32 sums differ before
# the final rounding, so they get two ulps of the element (a measured worst
# of 1.03 ulps at B4 H8 L1024 D80). A kernel that skips one key tile (or 64
# q rows) is over 50x either bound (tests/test_torch_port_flash_bwd.py).
KERNEL_RTOL = 2.0**-7
BWD_RTOL = 2.0**-6
KERNEL_ATOL_RMS = 2.0**-7
# flash_fwd_f32 against its plain version in float32 (TF32 off): both
# compute the same float32 logits, exp2 and sums in other orders (64-term
# dot products, per-tile against per-row maxima, exp2f against torch's
# exp2), so they differ by float32 roundings, a few 2^-24 of the output's
# scale; the bound is 2^-14 of the element plus 2^-14 of the output's rms.
# A kernel that drops one 64-key tile of 1025 is off by about 1/16.
F32_RTOL = 2.0**-14
F32_ATOL_RMS = 2.0**-14
UNET_REL_L2 = 5e-2
# the float32 UNet pass (--dtype fp32) with its self-attention through the
# float32 kernels against the same pass through the plain attention, both
# float32 with TF32 off; and the DIFFMINING_FUSED_NORM=1 pass (float32 K7)
# against the module path: float32 roundings in other orders carried
# through the UNet's random weights (the CLIP towers read 1.4e-6 through 24
# layers); the bound is 1e-4 relative L2. A dropped 64-key tile of 4096
# moves a pass by about 1e-2.
UNET_F32_REL_L2 = 1e-4
# float32 training (--mixed_precision no): the level-0 to_q/to_k/to_v
# gradients with the float32 kernels against the same through the plain
# attention, one forward and backward at the seed's weights: float32
# roundings through the backward of the whole UNet; the bound is 1e-4
# relative L2.
F32_GRAD_REL_L2 = 1e-4
# the float32 lse mode against flash_fwd_lse_plain at float32: within
# 2^-14 max(1, |lse|)
F32_LSE_RTOL = 2.0**-14
# the gated self-attentions of a 512px SD-v1.5 UNet pass, (L, head dim):
# five transformers at level 0 and five at level 1
UNET_512_GATED = ((4096, 40),) * 5 + ((1024, 80),) * 5
# bf16 mixed precision through the UNet's forward and backward against a
# float32 pass: relative L2 error of the level-0 attention projections'
# gradients at the seed's weights, before any step. Measured 0.0215-0.0245
# there on an H100 (0.014-0.031 after five to seven steps; PERF.md); the
# limit leaves 1.6x room. Gradients that never reach the projections read
# 1.0. A dropped
# 64-key tile out of 4096 moves them by about 1/64, the size of the bf16
# rounding itself, so this check cannot see it: phase 5's kernel-vs-plain
# bounds do.
GRAD_REL_L2 = 4e-2
LSE_ATOL = 1e-3
# K5 forms delta = sum_d dO o itself: the same D <= 160 exact fp32 products
# as attention_delta's, summed in another order, so the two differ by at most
# 2 (D - 1) 2^-24 of sum_d |dO o| (1.9e-5 at D=160); the bound is 2^-15 of it.
DELTA_RTOL = 2.0**-15
# K7 against its plain version: both round h to bf16 at the same point (the
# kernel's prologue avoids FMA contraction, as the plain version's separate
# torch ops do) and the product's fp32 sum to bf16 before adding the bias in
# bf16. Where the sum lands on the other side of a rounding boundary the
# product flips by one ulp of ITSELF, |want - bias|, which can be several
# ulps of a result that the bias cancels. The bound is one ulp of the
# product plus one of the result (plus the rms margin): the elementwise
# 2^-6 |want| bound read 1.02x where the bias cancelled (silu N1024 C640,
# an H100). A kernel that skips one 32-channel chunk of the input is far
# outside it (tests/test_torch_port_fused_norm.py).
# K7's statistics against group_stats_plain, which repeats the statistics
# kernel's order: |mean - plain| <= 2^-21 max|x| and |rsig / plain - 1| <=
# 2^-17, the bounds the CPU tests hold the plain version to against JAX (the
# kernel reads 0 and 0 on an H100: the same sums in the same order).
GN_MEAN_TOL = 2.0**-21
GN_RSIG_RTOL = 2.0**-17
# the DIFT feature map of one image under the K3/K7 modes against the same
# map under the default modes (K1, module-path GroupNorm), both bf16 with
# the same weights and draws: they differ by bf16 rounding at other places
# (p rounded relative to the running max or not; GroupNorm and the 1x1
# projection rounded once by K7 or through cuDNN), amplified through the
# UNet. Measured 0.0046 at 512px on an H100 (0.0047 at tiny widths on the
# CPU); the limit leaves about 3x room. Each kernel is held much tighter
# against its plain version in phase 7.
DIFT_MODES_REL_L2 = 1.5e-2
# the ViT-L/14 tower's projected tokens with its self-attention through the
# float32 flash forward against the same forward through the plain
# attention (both float32, TF32 off): roundings of float32 sums carried
# through 24 layers of random weights; the bound is 1e-4 relative L2.
CLIP_F32_REL_L2 = 1e-4
# the Doersch SVM's optimality certificate at the production shape: the bound
# tests/test_doersch.py holds the JAX solver to at 25,000 x 2112 with 1,250
# positives (a pipeline fold's solve has about 5, where the certificate reads
# 1.0 in both packages: phase_doersch)
DOERSCH_GAP = 0.02
# the batched SVM on the card against the same call on the CPU: float32 sums
# in other orders through 400 Adam steps; each output (W, b, the pool
# scores) within 1e-4 of its largest magnitude (the first card run read
# 1.1e-5 absolute on weights of order 0.1, over an elementwise atol of 1e-5)
SVM_CARD_RTOL = 1e-4
# phase 11's inversion depth, cut from the reference's 999 for the script's
# time (the inversion and the reconstruction each run a UNet pass a step,
# about 49 ms on an H100, where the host sets the pace)
PNP_INVERSION_STEPS = 100


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def exp2_ms(logits):
    """The time of one exp2 per logit on the special-function units alone:
    logits / (16 x SMs x the maximum SM clock). Printed beside the bound but
    not part of it: a kernel may emulate part of exp2 on the FMA pipes."""
    return logits / (EXP2_PER_CLOCK_PER_SM * SM_COUNT * SM_MAX_MHZ * 1e6) * 1e3


def attention_bound(b, h, lq, lk, d):
    """Least time for one call: each input read and the output written once
    over the memory rate, against QK^T + PV on the bf16 tensor cores and the
    float32 per-logit work (exp2 and the denominator add) outside them; and
    beside it the exp2 work alone on the special-function units (exp2_ms)."""
    nbytes = 2 * (2 * b * h * lq * d + 2 * b * h * lk * d)
    logits = b * h * lq * lk
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_tensor = 4.0 * logits * d / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    t_fp32 = 2.0 * logits / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_tensor, t_fp32)
    return bound, ("bytes" if bound == t_bytes else "operations"), exp2_ms(logits)


def device_split(fn, name_part, launches=1, other=None):
    """Device time of ``fn`` from a torch.profiler trace: (all its kernels a
    call, one launch of the kernel whose name holds ``name_part``) in ms;
    ``launches`` is how many times a call launches that kernel. With
    ``other``, a third value: a call's time in the kernels whose name holds
    ``other``.
    Beside the CUDA-event time it shows how much of a call the device is
    busy, and how much of that is the named kernel. The trace runs
    TRACE_PAD calls before and after the TRACE_CALLS it reads, with a spin
    kernel (torch.cuda._sleep) on each side of those, and reads the kernels
    between the two spins in the device's own order. A trace can lose the
    records of the first kernels it sees (two calls' in a trace taken after
    the train phase, every call's in the first trace of a process, and at
    times the first spin and all the calls read after the train phase; the
    first ~250 ms of device work in every trace of long calls after phases
    1-8 ran, whatever the number of records), so each trace waits after it
    starts before the first call, TRACE_SETTLE_S and twice as long at each
    retry; and its device clock can sit over 1 ms off its host clock, so a
    host-side range cannot mark the calls. A trace that does not hold both
    spins, one launch of the named kernel a call read per launch a call and
    a kernel count that is a multiple of TRACE_CALLS is logged and taken
    again. Where TRACE_ATTEMPTS traces lose records (they did late in a
    run, after phase 6, with the same loss at every settle), and for every
    later call once they have (TRACES_LOST), a call's device
    time comes from CUDA events around TRACE_CALLS calls queued behind a
    spin kernel (``queued_device_ms``); that cannot split a call by kernel,
    so the named and ``other`` parts are then None ("not measured"), except
    for a call of one launch of one kernel, whose part is the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    global TRACES_LOST
    fn()
    torch.cuda.synchronize()
    for attempt in range(0 if TRACES_LOST else TRACE_ATTEMPTS):
        settle = TRACE_SETTLE_S * 2**attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(settle)
            for _ in range(TRACE_PAD):
                fn()
            torch.cuda._sleep(1000)
            for _ in range(TRACE_CALLS):
                fn()
            torch.cuda._sleep(1000)
            for _ in range(TRACE_PAD):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
        read = kernels[spins[0] + 1:spins[1]] if len(spins) == 2 else []
        named = [e.device_time_total for e in read if name_part in e.name]
        if read and len(read) % TRACE_CALLS == 0 and (not name_part or len(named) == launches * TRACE_CALLS):
            times = sum(e.device_time_total for e in read) / TRACE_CALLS / 1e3, sum(named) / len(named) / 1e3
            if attempt:
                log(f"  (the trace with a {settle:.1f} s settle holds them)")
            if other is None:
                return times
            return (*times, sum(e.device_time_total for e in read if other in e.name) / TRACE_CALLS / 1e3)
        log(f"  (a trace with a {settle:.1f} s settle holds {len(spins)} of 2 spins (at records {spins} of "
            f"{len(kernels)}) and {len(named)} launches of {name_part or 'any kernel'} between them for {TRACE_CALLS} calls of {launches}; "
            "tracing again)")
    busy = queued_device_ms(fn)
    named = busy if launches == 1 and other is None and name_part else None
    split = "" if named is not None else "; its split by kernel not measured"
    lost = "earlier traces of this process" if TRACES_LOST else f"{TRACE_ATTEMPTS} traces"
    TRACES_LOST = True
    log(f"  ({lost} lost records: a call's device time by CUDA events around {TRACE_CALLS} calls "
        f"queued behind a spin kernel instead, {busy:.4f} ms{split})")
    return (busy, named) if other is None else (busy, named, None)


def device_busy(fn, calls=5, parts=()):
    """A call's device time from a torch.profiler trace of ``calls`` calls
    between two spin kernels: (the sum of its kernels' times, the time in
    which at least one of them runs: the union of their intervals, a
    kernel that starts before the last one ends counted once; the five
    kernels with the largest sums, names and ms a call; for each string of
    ``parts``, the ms a call of the kernels whose name holds it). Where
    TRACE_ATTEMPTS traces (none once TRACES_LOST) lose a spin or hold a
    kernel count that is no multiple of ``calls``, (None, None, [], {})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    global TRACES_LOST
    fn()
    torch.cuda.synchronize()
    for attempt in range(0 if TRACES_LOST else TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            time.sleep(TRACE_SETTLE_S * 2**attempt)
            pad = torch.zeros(1, device="cuda")
            for _ in range(TRACE_PAD):  # records a trace may lose, before the first spin
                pad.add_(1)
            torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(kernels) if "spin_kernel" in e.name]
        read = kernels[spins[0] + 1:spins[1]] if len(spins) == 2 else []
        if not read or len(read) % calls:
            continue
        union, end, by_name = 0.0, -math.inf, {}
        for e in read:
            start, stop = e.time_range.start, e.time_range.end
            union += max(0.0, stop - max(start, end))
            end = max(end, stop)
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / calls / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        part_ms = {p: sum(ms for name, ms in by_name.items() if p in name) for p in parts}
        return sum(by_name.values()), union / calls / 1e3, top, part_ms
    TRACES_LOST = True
    return None, None, [], {}


def queued_device_ms(fn) -> float:
    """Device time of one call of ``fn``: CUDA events around TRACE_CALLS
    calls enqueued behind a spin kernel long enough that the host queues
    them all before the device reaches the first, so the device never waits
    for the host between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.2 * SM_MAX_MHZ * 1e6))  # ~0.2 s of spinning
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(TRACE_CALLS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / TRACE_CALLS


def fmt(x, spec=".4f") -> str:
    """A measured number, or "not measured"."""
    return "not measured" if x is None else format(x, spec)


def plain_chunked(plain, *ts):
    """A plain version over all of B*H, in slices whose float32 logits stay
    near 2 GiB (the whole batch at once would not fit). ``ts`` are [B, H, ...]
    tensors (q and k first); ``plain`` returns a tensor or a tuple."""
    import torch

    b, h = ts[0].shape[:2]
    per = max(1, (1 << 29) // (ts[0].shape[2] * ts[1].shape[2]))
    flat = [t.reshape(b * h, 1, *t.shape[2:]) for t in ts]
    outs = [plain(*(f[i:i + per] for f in flat)) for i in range(0, b * h, per)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts).reshape(b, h, *parts[0].shape[2:]) for parts in zip(*outs))
    return torch.cat(outs).reshape(b, h, *outs[0].shape[2:])


def training_bound(kind, b, h, l, d):
    """Least time of one online-softmax or training-kernel call: the bytes it
    must move (bf16 [B,H,L,D] operands and fp32 [B,H,L] rows, each read or
    written once; K5 reads o and writes delta too) over the memory rate, against its matmul work on the bf16
    tensor cores (4, 4, 6 and 8 L^2 D a head for K3, K4, K5 and K6) and its
    4 fp32 operations per logit outside them (K3/K4: max, subtract, exp2,
    sum; K5/K6: subtract, exp2, subtract, multiply); and beside it the exp2
    work alone on the special-function units (exp2_ms)."""
    n_bhld, n_rows, matmul = {"K3": (4, 0, 4), "K4": (4, 1, 4), "K5": (6, 2, 6), "K6": (6, 2, 8)}[kind]
    nbytes = n_bhld * 2 * b * h * l * d + n_rows * 4 * b * h * l
    logits = b * h * l * l
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_tensor = matmul * logits * d / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    t_fp32 = 4.0 * logits / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_tensor, t_fp32)
    return bound, ("bytes" if bound == t_bytes else "operations"), exp2_ms(logits)


def gn_proj_bound(b, n, c, cout):
    """Least time of one K7 call: x, w, the bias, gamma, beta and the
    per-channel statistics read once and the output written once over the
    memory rate, against the projection's 2 N C Cout per image on the bf16
    tensor cores and the prologue's 4 fp32 operations per x element."""
    nbytes = 2 * b * n * c + 2 * c * cout + 2 * cout + 4 * (2 * b * c + 2 * c) + 2 * b * n * cout
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_tensor = 2.0 * b * n * c * cout / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    t_fp32 = 4.0 * b * n * c / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_tensor, t_fp32)
    return bound, ("bytes" if bound == t_bytes else "operations")


def kernel_error(got, want, rtol=KERNEL_RTOL, rounded_before=None):
    """(max |got - want|, worst ratio of the error to its tolerance).
    ``rounded_before``: a value both sides rounded to bf16 before the last
    add (K7's product before the bias); its ulp joins the tolerance."""
    w = want.float()
    err = (got.float() - w).abs()
    mag = w.abs() if rounded_before is None else w.abs() + rounded_before.float().abs()
    tol = rtol * mag + KERNEL_ATOL_RMS * w.pow(2).mean().sqrt()
    return float(err.max()), float((err / tol).max())


def f32_error(got, want):
    """(max |got - want|, worst ratio to F32_RTOL |want| + F32_ATOL_RMS rms(want))."""
    err = (got - want).abs()
    tol = F32_RTOL * want.abs() + F32_ATOL_RMS * want.pow(2).mean().sqrt()
    return float(err.max()), float((err / tol).max())


def f32_attention_bound(b, h, lq, lk, d):
    """Least time of one float32 forward: q, k, v read and o written once
    (4 bytes an element) over the memory rate, against QK^T + PV, 4 Lq Lk D
    a head, on the float32 pipes outside the tensor cores."""
    t_bytes = 4 * (2 * b * h * lq * d + 2 * b * h * lk * d) / (PEAK_HBM_TBS * 1e12) * 1e3
    t_ops = 4.0 * b * h * lq * lk * d / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_ops)
    return bound, ("bytes" if bound == t_bytes else "operations")


def f32_training_bound(kind, b, h, lq, lk, d):
    """Least time of one float32 lse-mode forward (K4), K5 or K6 call: its
    float32 operands ([B,H,L,D] 4 bytes an element, [B,H,Lq] rows) read or
    written once over the memory rate, against its 4, 6 or 8 Lq Lk D fp32
    operations a head on the float32 pipes outside the tensor cores."""
    n_q, n_k, rows, ops = {"K4": (2, 2, 1, 4), "K5": (4, 2, 2, 6), "K6": (2, 4, 2, 8)}[kind]
    nbytes = 4 * (n_q * b * h * lq * d + n_k * b * h * lk * d + rows * b * h * lq)
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_ops = ops * b * h * lq * lk * d / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_ops)
    return bound, ("bytes" if bound == t_bytes else "operations")


def gn_proj_f32_bound(b, n, c, cout):
    """Least time of one float32 K7 call: x, w, bias, gamma, beta and the
    statistics read once and the output written once (4 bytes an element)
    over the memory rate, against the projection's 2 N C Cout per image and
    the normalise's 4 operations per x element on the float32 pipes."""
    nbytes = 4 * (b * n * c + c * cout + cout + 2 * c + 2 * b * c + b * n * cout)
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_ops = (2.0 * b * n * c * cout + 4.0 * b * n * c) / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_ops)
    return bound, ("bytes" if bound == t_bytes else "operations")


def assert_no_tf32():
    import torch

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off for float32 matmuls and convolutions (the float32 references)")


def pytorch_default_tf32():
    """PyTorch's own defaults (matmul TF32 off, cuDNN TF32 on): what a fresh
    process of the port's CLIs starts from, so a phase that sets them before
    it builds the port's float32 bundle, trainer or ranker reads in
    assert_no_tf32 what the port's own set-up did."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True


def phase_environment():
    import torch

    from diffmining_tpu_torch.utils.device import exact_float32

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    global SM_COUNT, SM_MAX_MHZ
    SM_COUNT = torch.cuda.get_device_properties(0).multi_processor_count
    SM_MAX_MHZ = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0])
    log(f"{SM_COUNT} SMs, maximum SM clock {SM_MAX_MHZ:.0f} MHz: exp2 at "
        f"{EXP2_PER_CLOCK_PER_SM * SM_COUNT * SM_MAX_MHZ * 1e6:.4g} a second on the special-function units")
    exact_float32()
    log("TF32 off for float32 matmuls and convolutions (the float32 references); phases 14, 17 and 19 restore "
        "PyTorch's defaults before the port's float32 set-up, which turns both off itself")
    return smi


def phase_build():
    from diffmining_tpu_torch.ops import flash_attention as fa

    shutil.rmtree(fa.BUILD_DIR, ignore_errors=True)  # build every source afresh, here and now
    t0 = time.perf_counter()
    fa.build()
    log(f"build: {', '.join(n + '.cu' for n in fa.SOURCES)} in {time.perf_counter() - t0:.1f} s "
        "(one nvcc each, in parallel; set-up)")
    for name in fa.SOURCES:
        lines = fa.build_log.get(name, "").splitlines()
        regs = [line.split("Used ")[1].split(" registers")[0] for line in lines if "Used " in line]
        spills = [line.strip() for line in lines if "spill" in line and "0 bytes spill stores" not in line]
        warnings = [line.strip() for line in lines if "warning" in line.lower() or "Performance Loss" in line]
        log(f"  ptxas {name}: registers per thread of the instantiations: {', '.join(regs)}; "
            f"spills: {spills or 'none'}" + (f"; warnings: {warnings}" if warnings else ""))
        fa._library(name)
    # every bf16 kernel issues wgmma: the SASS shows HGMMA; the float32
    # kernels are fp32 FMA only: no tensor-core instruction (no TF32, no bf16)
    cuobjdump = os.path.join(os.path.dirname(fa._nvcc()), "cuobjdump")
    for name in fa.SOURCES:
        sass = subprocess.run([cuobjdump, "-sass", str(fa._library_path(name))], capture_output=True, text=True,
                              check=True).stdout
        if name in fa.F32_SOURCES:
            mma = [line.strip() for line in sass.splitlines() if re.search(r"\b[A-Z]*G?MMA\.", line.split(";")[0])
                   and "HFMA2.MMA" not in line]  # HFMA2.MMA: a register move issued on the FMA pipe
            ffma = sum("FFMA" in line for line in sass.splitlines())
            if mma or not ffma:
                raise AssertionError(f"{name}: tensor-core instructions {mma[:2]} or no FFMA in its SASS")
            log(f"  cuobjdump -sass {name}: no tensor-core instruction, {ffma} FFMA")
            continue
        hgmma = [line.strip() for line in sass.splitlines() if "HGMMA" in line]
        if not hgmma:
            raise AssertionError(f"{name}: no HGMMA in the SASS of its library")
        log(f"  cuobjdump -sass {name}: {len(hgmma)} HGMMA, e.g. {hgmma[0]}")


def p_flip_ratio(got, want, q, k, v) -> float:
    """|kernel - plain| in units of the one-ulp bound widened by what one
    flipped bf16 rounding of a row's largest p can move an output by
    (tests/test_torch_port_cuda.py ``_over_p_flip_bound``, the card test's
    bound for the fused-QKV view): either side's fp32 logits may round a
    p = exp2(s) to the other bf16 neighbour, which moves o = sum p v / l by
    ulp(p) (v - o) / l; per row, one bf16 ulp of the row's largest p (p in
    float64 from the bf16 pre-scaled q, rounded to bf16) times max |v - o|
    over the keys, over l. Over B*H slices whose float64 logits stay near
    2 GiB."""
    import torch

    from diffmining_tpu_torch.ops.flash_attention import prescaled_q

    b, h, lq, d = q.shape
    lk = k.shape[2]
    per = max(1, (1 << 28) // (lq * lk))
    qs = prescaled_q(q).reshape(b * h, lq, d)
    kk, vv = k.reshape(b * h, lk, d), v.reshape(b * h, lk, d)
    w = want.float().reshape(b * h, lq, d)
    err = (got.float() - want.float()).reshape(b * h, lq, d).abs()
    rms = float(w.pow(2).mean().sqrt())
    worst = 0.0
    for i in range(0, b * h, per):
        sl = slice(i, i + per)
        p = torch.exp2(qs[sl].double() @ kk[sl].double().transpose(-1, -2)).to(torch.bfloat16).double()
        l_sum, pmax = p.sum(-1, keepdim=True), p.amax(-1, keepdim=True)
        del p
        ulp = torch.exp2(torch.floor(torch.log2(pmax)) - 7)
        vd, wd = vv[sl].double(), w[sl].double()
        spread = torch.maximum(vd.amax(-2, keepdim=True) - wd, wd - vd.amin(-2, keepdim=True))
        tol = KERNEL_RTOL * w[sl].abs() + KERNEL_ATOL_RMS * rms + (ulp * spread / l_sum).float()
        worst = max(worst, float((err[sl] / tol).max()))
    return worst


def nomax_case(name, q, k, v, flip_bound=False):
    """The no-max forward (K1/K2) on q, k, v against its plain version, with
    CUDA-event and device times of the kernel, the plain version and sdpa's
    forward, and the bound. Returns (the numbers, a failure message or
    None): a kernel that disagrees is timed all the same. The check is the
    one-ulp bound, or with ``flip_bound`` the bound widened by one flipped
    rounding of a row's largest p (``p_flip_ratio``); the one-ulp ratio is
    recorded either way."""
    import torch
    import torch.nn.functional as F

    from diffmining_tpu_torch.ops.flash_attention import flash_attention_nomax_plain, flash_fwd_nomax

    b, h, l, d = q.shape
    got = flash_fwd_nomax(q, k, v)
    torch.cuda.synchronize()
    want = plain_chunked(flash_attention_nomax_plain, q, k, v)
    max_err, worst = kernel_error(got, want)
    flip = p_flip_ratio(got, want, q, k, v) if flip_bound else None
    failed = None
    if (worst if flip is None else flip) > 1.0 or not torch.isfinite(got).all():
        failed = (f"{name}: kernel disagrees with the plain version (max abs err {max_err}, {worst:.3g} x the "
                  f"one-ulp tolerance, {flip} x the p-flip one)")
    del got, want
    ms = cuda_time_ms(lambda: flash_fwd_nomax(q, k, v))
    plain_ms = cuda_time_ms(lambda: plain_chunked(flash_attention_nomax_plain, q, k, v), reps=3, warmup=1)
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    _, device_ms = device_split(lambda: flash_fwd_nomax(q, k, v), "flash_fwd_nomax_kernel")
    lib_device, _ = device_split(lambda: F.scaled_dot_product_attention(q, k, v), "")
    bound, by, exp2 = attention_bound(b, h, l, l, d)
    flip_txt = "" if flip is None else f" ({flip:.3g} x the p-flip tolerance)"
    log(f"kernel {name} B{b} H{h} L{l} D{d}: max|err| {max_err:.3g} = {worst:.3g} x tolerance{flip_txt} "
        f"ms {ms:.4f}  device {device_ms:.4f}  plain {plain_ms:.3f}  sdpa {lib_ms:.4f} (device {lib_device:.4f})  "
        f"bound {bound:.4f} ({by})  exp2 {exp2:.4f}")
    torch.cuda.empty_cache()
    out = dict(shape=[b, h, l, d], max_abs_err=max_err, err_over_tol=worst, ms=ms, device_ms=device_ms,
               plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_device, library="sdpa forward",
               bound_ms=bound, bound_by=by)
    if flip is not None:
        out["err_over_p_flip_tol"] = flip
    return out, failed


def projections(g, b, h, l, d):
    """q, k, v as the UNet hands them over: [B, L, H*D] bf16 projections
    viewed as [B, H, L, D]."""
    import torch

    return [torch.randn(b, l, h * d, generator=g, device=g.device).to(torch.bfloat16)
            .view(b, l, h, d).transpose(1, 2) for _ in range(3)]


def phase_kernels():
    import torch

    from diffmining_tpu_torch.ops.flash_attention import flash_attention_nomax_plain, flash_fwd_nomax

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    cases = [
        ("K1 L4096 D40", (16, 8, 4096, 40)),
        ("K1 L1024 D80", (16, 8, 1024, 80)),
        ("K2 L16384 D40", (2, 8, 16384, 40)),
        ("masked tail L1000 D40", (2, 8, 1000, 40)),
        ("masked tail L1100 D160", (2, 8, 1100, 160)),
    ]
    # X-ray at 1024px: the sweep's self-attention batch, 4 images x 3 x 2
    # (phase 9's path), at its three gated levels. These, and PnP's layout
    # below, are held to the bound that allows one flipped bf16 rounding of
    # a row's largest p (the card test's bound): on an H100, K1 at L1024
    # D160 read 1.53x the one-ulp bound on this data (0.91x on another draw)
    new_cases = [
        ("K2 X-ray L16384 D40", (24, 8, 16384, 40)),
        ("K1 X-ray L4096 D80", (24, 8, 4096, 80)),
        ("K1 X-ray L1024 D160", (24, 8, 1024, 160)),
    ]
    results, failed = {}, []
    for name, shape in cases + new_cases:
        results[name], fail = nomax_case(name, *projections(g, *shape), flip_bound=(name, shape) in new_cases)
        failed += [fail] if fail else []
    # PnP's injected q/k (phase 11's path, up block 3 at 512px, 2 targets):
    # one source row broadcast over the CFG batch of 4 and materialised, as
    # the UNet's _apply_injection hands it over; v is the batch's own
    # projection. Timed here, early: torch.profiler traces taken late in the
    # process lose records (phase 11 holds the path's own q/k to the plain
    # version)
    q1, k1, v = projections(g, 4, 8, 4096, 40)
    q, k = (t[:1].expand(4, -1, -1, -1).contiguous() for t in (q1, k1))
    name = "K1 PnP injected q/k L4096 D40"
    results[name], fail = nomax_case(name, q, k, v, flip_bound=True)
    results[name].update(q_strides=list(q.stride()), v_strides=list(v.stride()))
    failed += [fail] if fail else []
    del q1, k1, q, k, v
    if failed:
        raise AssertionError("; ".join(failed))

    # the designed underflow edge: every natural logit -95 -> p = 0 -> zeros
    d, l = 40, 1024
    q = torch.zeros(1, 2, l, d, device=dev)
    k = torch.zeros(1, 2, l, d, device=dev)
    q[..., 0] = -95.0 * math.sqrt(d)
    k[..., 0] = 1.0
    v = torch.randn(1, 2, l, d, generator=g, device=dev)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = flash_fwd_nomax(q, k, v)
    want = flash_attention_nomax_plain(q, k, v)
    torch.cuda.synchronize()
    if float(got.float().abs().max()) != 0.0 or float(want.float().abs().max()) != 0.0:
        raise AssertionError("underflow edge: the kernel or the plain version is not all zeros")
    log("kernel underflow edge (all natural logits -95): kernel and plain both return zeros")
    return results


def phase_slice(smi):
    import numpy as np
    import torch

    from diffmining_tpu_torch.models import unet as unet_mod
    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.ops.attention import sdpa, sdpa_plain
    from diffmining_tpu_torch.ops.flash_attention import flash_fwd_nomax
    from diffmining_tpu_torch.typicality.compute import SD, D, Typicality
    from diffmining_tpu_torch.utils.images import array_from_uint8

    labels, per_label, px, N, batch_images, chunk = ["1920", "1960"], 8, 512, 4, 8, 1
    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    data, out, subs = (os.path.join(work, n) for n in ("ftt", "typicality", "subs"))
    rng = np.random.RandomState(SEED)
    arrays = {}
    for c in labels:
        os.makedirs(os.path.join(data, c))
        for i in range(per_label):
            path = os.path.join(data, c, f"img{i}.jpg")
            open(path, "wb").close()  # a name for the work queue; never decoded
            arrays[path] = array_from_uint8(rng.randint(0, 256, (px, px, 3), dtype=np.uint8))
    log(f"slice: the smoke bypasses image decoding: {len(arrays)} synthetic {px}x{px} uint8 images "
        "(numpy, seeded) go to the sweep through compute_submission(load=...)")

    t0 = time.perf_counter()
    sd = SD.init_random("ftt", labels, SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED,
                        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"slice: SD-v1.5 widths, random weights (seed {SEED}), bf16, built in "
        f"{time.perf_counter() - t0:.1f} s")
    typ = Typicality("ftt", None, data, out, t_min=0.1, t_max=0.9, sd=sd, N=N,
                     batch_images=batch_images, chunk=chunk, device="cuda")
    typ.make_submission(data, subs, sub_split=1)

    flash_fwd_nomax.launches = 0
    t0 = time.perf_counter()
    typ.compute_submission(os.path.join(subs, "0.txt"), load=arrays.__getitem__)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = flash_fwd_nomax.launches

    n_passes = sum(math.ceil(per_label / batch_images) for _ in labels) * (N // chunk)
    if launches != 10 * n_passes:
        raise AssertionError(f"flash_fwd_nomax launched {launches} times, expected 10 x {n_passes} UNet passes")
    log(f"slice: flash_fwd_nomax launched {launches} times = 10 per UNet pass x {n_passes} passes")
    n_art = 0
    for c in labels:
        for i in range(per_label):
            a = np.load(os.path.join(out, c, f"img{i}.npy"))
            if a.shape != (N, 2, 4, px // 8, px // 8) or a.dtype != np.float16 or not np.isfinite(a).all():
                raise AssertionError(f"artifact {c}/img{i}.npy: {a.shape} {a.dtype}")
            n_art += 1
    imgs_hr = len(arrays) / dt * 3600.0
    log(f"slice: {n_art} artifacts [{N}, 2, 4, {px // 8}, {px // 8}] fp16, all finite; "
        f"{imgs_hr:.1f} imgs/hr at N={N} ({dt:.2f} s for {len(arrays)} images, first run) on {smi}")

    # one UNet pass: bf16 with the kernel vs float32 through the plain attention
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 1)
    x = torch.randn(batch_images, 4, px // 8, px // 8, generator=g, device="cuda")
    t = torch.randint(100, 900, (batch_images,), generator=g, device="cuda")
    ctx = torch.stack([torch.stack([sd.country_embeds[labels[0]], sd.country_embeds[""]])] * batch_images)
    ctx = ctx.reshape(batch_images * 2, *ctx.shape[2:])
    with torch.inference_mode():
        before = flash_fwd_nomax.launches
        eps16 = sd.unet(x, t, ctx, ctx_tile=2).float()
        if flash_fwd_nomax.launches - before != 10:
            raise AssertionError("the bf16 UNet pass did not launch the kernel 10 times")
        pass_ms = cuda_time_ms(lambda: sd.unet(x, t, ctx, ctx_tile=2), reps=5, warmup=1)
        # these launches are not the main path's: its counts were read above
        busy_ms, k1_ms = device_split(lambda: sd.unet(x, t, ctx, ctx_tile=2), "flash_fwd_nomax_kernel", launches=10)
        # the float32 reference: this pass (and only this one) swaps the
        # UNet's attention for the plain softmax
        unet_mod.sdpa = sdpa_plain
        try:
            eps32 = sd.unet.float()(x, t, ctx, ctx_tile=2)
        finally:
            unet_mod.sdpa = sdpa
            sd.unet.to(torch.bfloat16)
    rel = float((eps16 - eps32).norm() / eps32.norm())
    if not (torch.isfinite(eps16).all() and rel < UNET_REL_L2):
        raise AssertionError(f"UNet pass: bf16+kernel vs float32 plain relative L2 error {rel}")
    log(f"slice: UNet pass (B={batch_images}x2, 512px) bf16+kernel vs float32+plain attention: "
        f"relative L2 error {rel:.4g} (limit {UNET_REL_L2}: bf16 rounding through the whole UNet)")
    log(f"slice: one UNet pass (batch {batch_images * 2}, dedup) {pass_ms:.2f} ms; device busy {busy_ms:.2f} ms, "
        f"of which flash_fwd_nomax "
        + ("not measured" if k1_ms is None else f"{10 * k1_ms:.2f} ms ({10 * k1_ms / busy_ms:.1%}; 10 launches)"))

    # the product setting, N=100, on one warm group of 8 images
    d100 = D(sd, os.path.join(work, "n100"), "ftt", N=100, t_min=0.1, t_max=0.9,
             batch_images=batch_images, chunk=chunk)
    group = [(p, labels[0], arrays[p]) for p in sorted(arrays)[:batch_images]]
    t0 = time.perf_counter()
    d100._compute_group(group)
    dt100 = time.perf_counter() - t0
    for p, _, _ in group:
        a = d100(p)
        if a.shape != (100, 2, 4, px // 8, px // 8) or not np.isfinite(a).all():
            raise AssertionError(f"N=100 artifact {p}: {a.shape}")
    imgs_hr_100 = batch_images / dt100 * 3600.0
    log(f"slice: N=100 sweep of {batch_images} images in {dt100:.2f} s = {imgs_hr_100:.1f} imgs/hr on {smi}")
    shutil.rmtree(work, ignore_errors=True)
    return launches, imgs_hr, imgs_hr_100, dict(unet_pass_ms=pass_ms, unet_pass_busy_ms=busy_ms,
                                                 unet_pass_k1_ms=None if k1_ms is None else 10 * k1_ms)


def phase_train_kernels():
    import torch
    import torch.nn.functional as F

    from diffmining_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)

    def operands(b, h, l, d):
        # q, k, v and dO as [B, L, H*D] tensors viewed as [B, H, L, D]
        return [torch.randn(b, l, h * d, generator=g, device=dev).to(torch.bfloat16)
                .view(b, l, h, d).transpose(1, 2) for _ in range(4)]

    def k4_plain(q, k, v):
        return fa.flash_fwd_lse_plain(q, k, v, block_k=fa.ONLINE_BLOCK_K)  # the kernel's key tiles

    cases = [
        ("L4096 D40", (4, 8, 4096, 40)),
        ("L1024 D80", (4, 8, 1024, 80)),
        ("masked tail L1000 D40", (2, 8, 1000, 40)),
        ("masked tail L1100 D160", (2, 8, 1100, 160)),
    ]
    results = {"K4": {}, "K5": {}, "K6": {}}
    for name, (b, h, l, d) in cases:
        q, k, v, do = operands(b, h, l, d)
        o, lse = fa.flash_fwd_lse(q, k, v)
        delta = fa.attention_delta(do, o)
        qs = fa.prescaled_q(q)  # as the backward forms it, once for K5 and K6
        dq, delta_k = fa.flash_bwd_dq(q, k, v, do, o, lse, qs)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, qs)
        torch.cuda.synchronize()
        delta_err = float(((delta_k - delta).abs() / (do.float() * o.float()).abs().sum(-1)).max())
        if not delta_err <= DELTA_RTOL:
            raise AssertionError(f"K5 {name}: delta differs from attention_delta by {delta_err:.3g} of sum|dO o|")
        o_p, lse_p = plain_chunked(k4_plain, q, k, v)
        dq_p = plain_chunked(fa.flash_bwd_dq_plain, q, k, v, do, lse, delta)
        dk_p, dv_p = plain_chunked(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta)
        lse_err = float((lse - lse_p).abs().max())
        errs = {"K4": [kernel_error(o, o_p)], "K5": [kernel_error(dq, dq_p, BWD_RTOL)],
                "K6": [kernel_error(dk, dk_p, BWD_RTOL), kernel_error(dv, dv_p, BWD_RTOL)]}
        for kind, pairs in errs.items():
            worst = max(w for _, w in pairs)
            outs = {"K4": (o,), "K5": (dq,), "K6": (dk, dv)}[kind]
            if worst > 1.0 or not all(bool(torch.isfinite(t).all()) for t in outs):
                raise AssertionError(f"{kind} {name}: kernel disagrees with its plain version ({worst:.3g} x the tolerance)")
        if lse_err > LSE_ATOL:
            raise AssertionError(f"K4 {name}: lse differs from the plain version by {lse_err}")
        del o_p, lse_p, dq_p, dk_p, dv_p

        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        ref = F.scaled_dot_product_attention(qr, kr, vr)
        times = {
            "K4": (cuda_time_ms(lambda: fa.flash_fwd_lse(q, k, v)),
                   cuda_time_ms(lambda: plain_chunked(k4_plain, q, k, v), reps=3, warmup=1),
                   cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v))),
            "K5": (cuda_time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, o, lse, qs)),
                   cuda_time_ms(lambda: plain_chunked(fa.flash_bwd_dq_plain, q, k, v, do, lse, delta),
                                reps=3, warmup=1), None),
            "K6": (cuda_time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, qs)),
                   cuda_time_ms(lambda: plain_chunked(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta),
                                reps=3, warmup=1), None),
        }
        # one library call computes dq, dk and dv together: sdpa's backward
        lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True))
        # device times beside the CUDA-event times (a short call is host-bound):
        # each kernel's own launch; sdpa's forward and its backward as a whole
        # (every kernel of a call); and the port's whole backward through the
        # autograd Function (delta, the pre-scale, K5, K6)
        _, k4_device = device_split(lambda: fa.flash_fwd_lse(q, k, v), "flash_fwd_online_kernel")
        _, k5_device = device_split(lambda: fa.flash_bwd_dq(q, k, v, do, o, lse, qs), "flash_bwd_dq_kernel")
        _, k6_device = device_split(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, qs),
                                    "flash_bwd_dkv_kernel")
        lib_device, _ = device_split(lambda: F.scaled_dot_product_attention(q, k, v), "")
        lib_bwd_device, _ = device_split(lambda: torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True), "")
        port = fa.flash_attention(qr, kr, vr)
        bwd_device, _ = device_split(lambda: torch.autograd.grad(port, (qr, kr, vr), do, retain_graph=True), "")
        devices = {"K4": (k4_device, lib_device), "K5": (k5_device, lib_bwd_device), "K6": (k6_device, lib_bwd_device)}
        for kind, (ms, plain_ms, lib_ms) in times.items():
            bound, by, exp2 = training_bound(kind, b, h, l, d)
            max_err = max(e for e, _ in errs[kind])
            worst = max(w for _, w in errs[kind])
            results[kind][name] = dict(
                shape=[b, h, l, d], max_abs_err=max_err, err_over_tol=worst, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms if lib_ms is not None else lib_bwd,
                library="sdpa forward" if kind == "K4" else "sdpa backward (dq, dk, dv together)",
                bound_ms=bound, bound_by=by)
            device, lib_dev = devices[kind]
            results[kind][name].update(device_ms=device, library_device_ms=lib_dev)
            if kind == "K4":
                results[kind][name].update(lse_max_abs_err=lse_err)
            else:
                results[kind][name].update(backward_device_ms=bwd_device)
            if kind == "K5":
                results[kind][name].update(delta_err_over_abs_sum=delta_err)
            log(f"kernel {kind} {name} B{b} H{h}: max|err| {max_err:.3g} = {worst:.3g} x tolerance  "
                f"ms {ms:.4f}  plain {plain_ms:.3f}  {results[kind][name]['library']} "
                f"{results[kind][name]['library_ms']:.4f}  bound {bound:.4f} ({by})  exp2 {exp2:.4f}  "
                f"device {device:.4f} (sdpa {'forward' if kind == 'K4' else 'backward'} {lib_dev:.4f}"
                + (")" if kind == "K4" else f"; the port's backward {bwd_device:.4f})")
                + (f"  delta {delta_err / DELTA_RTOL:.3g} x its bound" if kind == "K5" else ""))
        del q, k, v, do, o, lse, delta, qs, dq, delta_k, dk, dv, qr, kr, vr, ref, port
        torch.cuda.empty_cache()
    return results


def places_trainer(work, batch, px, n_images, max_train_steps, extra=()):
    """The places trainer at SD-v1.5 widths with random weights from SEED:
    float32 master weights, bf16 autocast (float32 throughout with ``extra``
    ("--mixed_precision", "no")), EMA, batches of ``batch`` out of
    ``n_images`` synthetic px x px images (numpy, seeded) handed in through
    BaseTrainer(load=...), trainer flags ``extra`` added. Returns the trainer
    after training_init(), its args and the epoch's batches on the card."""
    import numpy as np
    import torch

    from diffmining_tpu_torch.finetuning.args import parse_args
    from diffmining_tpu_torch.finetuning.base import BaseTrainer
    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.typicality.compute import SD
    from diffmining_tpu_torch.utils.images import array_from_uint8

    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "places")
    rng = np.random.RandomState(SEED + 2)
    arrays = {}
    for i in range(n_images):
        folder = os.path.join(data, "a", ("abbey", "alley")[i % 2])
        os.makedirs(folder, exist_ok=True)
        path = os.path.join(folder, f"img{i}.jpg")
        open(path, "wb").close()  # a name for the dataset's index; never decoded
        arrays[path] = array_from_uint8(rng.randint(0, 256, (px, px, 3), dtype=np.uint8))
    sd = SD.init_random("places", [], SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED,
                        dtype=torch.float32, device="cuda")
    argv = ["--data_path", data, "--output_dir", os.path.join(work, "run"), "--train_batch_size", str(batch),
            "--resolution", str(px), "--mixed_precision", "bf16", "--use_ema", "--seed", str(SEED),
            "--max_train_steps", str(max_train_steps), "--device", "cuda", *extra]
    args = parse_args(argv)
    tr = BaseTrainer("places", args, sd=sd, load=arrays.__getitem__)
    tr.training_init()
    return tr, args, [tr._batch(b) for b in tr.loader.epoch(0)]


STEP_CATEGORIES = (  # first match wins, on the lower-cased kernel name
    # K4 runs the online-softmax kernel that K3 shares (flash_fwd_online_kernel)
    ("flash kernels (K4, K5, K6)", ("flash_fwd_online", "flash_bwd_dq", "flash_bwd_dkv")),
    ("optimizer and EMA (foreach)", ("foreach", "multi_tensor")),
    ("NCHW/NHWC layout transposes", ("nchwtonhwc", "nhwctonchw")),
    ("casts and copies", ("copy_kernel", "direct_copy", "bfloat16_copy")),
    ("matmul and convolution", ("gemm", "nvjet", "xmma", "cutlass", "conv", "implicit", "dgrad", "wgrad", "sm90_",
                                "cudnn")),
    ("normalisation", ("norm", "moments", "fusedparams", "welford")),
)


def profile_steps(tr, args, batches, warm_ms):
    """Trace len(batches) train steps with torch.profiler: the device's busy
    time a step (the sum of its kernels' times), the idle share that leaves
    against the untraced warm step ``warm_ms``, and the busy time split by
    kernel-name category. These launches are not the main path's: the
    counts were read before."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            tr.state, _ = tr.train_step(tr.state, *b, args.seed)
        torch.cuda.synchronize()
    n = len(batches)
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.device_time_total / 1e3 / n  # ms a step
    busy = sum(kernels.values())
    if busy <= 0:
        raise AssertionError("train profile: the trace holds no device time")

    def category(name):
        low = name.lower()
        return next((cat for cat, keys in STEP_CATEGORIES if any(k in low for k in keys)),
                    "other (elementwise, reductions)")

    by_cat = {}
    for name, ms in kernels.items():
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    idle = max(0.0, 1 - busy / warm_ms)
    log(f"train profile ({n} traced steps): device busy {busy:.2f} ms a step against the untraced warm step "
        f"{warm_ms:.1f} ms, idle share {idle:.3f}")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        log(f"  {cat}: {ms:.2f} ms a step ({ms / busy:.1%} of busy)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    log("  top kernels (ms a step): " + "; ".join(f"{ms:.2f} {name[:60]}" for name, ms in top))
    return dict(busy_ms=busy, idle_share=idle, by_category_ms=by_cat)


def phase_train(smi):
    import torch

    from diffmining_tpu_torch.models import unet as unet_mod
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops.attention import sdpa, sdpa_plain
    from diffmining_tpu_torch.utils.weights import load_pipeline_dir

    batch, px, n_images, n_steps = 4, 512, 16, 3
    work = os.path.join(ROOT, "build", "chip_smoke_train")
    t0 = time.perf_counter()
    tr, args, batches = places_trainer(work, batch, px, n_images, max_train_steps=n_steps)
    torch.cuda.synchronize()
    log(f"train: places trainer at SD-v1.5 widths, float32 master weights, bf16 autocast, EMA, batch {batch}; "
        f"{n_images} synthetic {px}x{px} images (numpy, seeded) go in through BaseTrainer(load=...); "
        f"built and training_init in {time.perf_counter() - t0:.1f} s")

    proj = [f"down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_{n}.weight" for n in "qkv"]
    before = {n: tr.state.params[n].detach().clone() for n in proj}
    ema_before = {n: tr.state.ema_params[n].clone() for n in proj}
    kernels = (fa.flash_fwd_lse, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_nomax)

    # one forward+backward at the seed's weights, bf16 + kernels vs float32 +
    # plain attention (before any step, so the reading does not depend on
    # how many steps the phase takes)
    b = tr.builder
    images, tokens = batches[0][0][:1], batches[0][1][:1]
    draws = b.draw(SEED + 3, 0, (1, 4, px // 8, px // 8), torch.device("cuda"))

    def proj_grads():
        b.loss(images, tokens, draws=draws).backward()
        grads = {n: tr.state.params[n].grad.float().clone() for n in proj}
        for p in tr.state.params.values():
            p.grad = None
        return grads

    g16 = proj_grads()
    b.mixed_precision = False
    unet_mod.sdpa = sdpa_plain  # the float32 reference: this pass alone uses the plain softmax
    try:
        g32 = proj_grads()
    finally:
        unet_mod.sdpa = sdpa
        b.mixed_precision = True
    rel = {n.split(".")[-2]: float((g16[n] - g32[n]).norm() / g32[n].norm()) for n in proj}
    if not all(float(g16[n].abs().max()) > 0 for n in proj) or max(rel.values()) >= GRAD_REL_L2:
        raise AssertionError(f"train: level-0 projection gradients bf16+kernels vs float32+plain: {rel}")
    log(f"train: level-0 to_q/to_k/to_v gradients, bf16+kernels vs float32+plain attention (batch 1): relative "
        f"L2 error {', '.join(f'{k} {v:.4g}' for k, v in rel.items())} (limit {GRAD_REL_L2}); all nonzero")

    # the main path: n_steps through the trainer's train_step
    for f in kernels:
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        tr.state, loss = tr.train_step(tr.state, *batches[i], args.seed)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {f.__name__: f.launches for f in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {"flash_fwd_lse": 10 * n_steps, "flash_bwd_dq": 10 * n_steps, "flash_bwd_dkv": 10 * n_steps,
            "flash_fwd_nomax": 0}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want} (10 gated attentions a step)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: loss not finite: {losses}")
    moved = min(float((tr.state.params[n].detach() - before[n]).abs().max()) for n in proj)
    ema_moved = min(float((tr.state.ema_params[n] - ema_before[n]).abs().max()) for n in proj)
    if not (moved > 0 and ema_moved > 0):
        raise AssertionError(f"train: parameters moved {moved}, EMA moved {ema_moved}")
    warm_ms = statistics.median(step_s[1:]) * 1e3
    log(f"train: {n_steps} steps, losses {', '.join(f'{x:.4f}' for x in losses)}; launches {launches} "
        f"(10 each of K4, K5, K6 a step); level-0 to_q/to_k/to_v moved by >= {moved:.3g}, EMA by >= {ema_moved:.3g}")
    log(f"train: step times {', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms; warm median {warm_ms:.1f} ms = "
        f"{batch / warm_ms * 1e3:.2f} images/s; peak allocated {peak_gib:.2f} GiB on {smi}")
    profile = profile_steps(tr, args, [batches[(n_steps + i) % len(batches)] for i in range(2)], warm_ms)

    # two steps under full gradient checkpointing (K4 runs again in the
    # backward); the second is the warm one
    tr.unet.set_gradient_checkpointing("full")
    want = {"flash_fwd_lse": 20, "flash_bwd_dq": 10, "flash_bwd_dkv": 10, "flash_fwd_nomax": 0}
    remat_ms = []
    for i in range(2):
        for f in kernels:
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr.state, loss = tr.train_step(tr.state, *batches[(n_steps + i) % len(batches)], args.seed)
        torch.cuda.synchronize()
        remat_ms.append((time.perf_counter() - t0) * 1e3)
        remat_launches = {f.__name__: f.launches for f in kernels}
        if remat_launches != want or not math.isfinite(float(loss)):
            raise AssertionError(f"train (full remat): launches {remat_launches}, expected {want}; loss {float(loss)}")
    remat_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    tr.unet.set_gradient_checkpointing(None)
    log(f"train: two steps under full gradient checkpointing: {remat_ms[0]:.1f} ms, {remat_ms[1]:.1f} ms (warm); "
        f"launches {remat_launches} each; peak allocated {remat_peak_gib:.2f} GiB")

    # the export, read back
    t0 = time.perf_counter()
    export_dir = tr.end_training()
    export_s = time.perf_counter() - t0
    p = load_pipeline_dir(export_dir)
    ema = tr.state.ema_params
    if set(p["unet"]["state_dict"]) != set(ema) or not all(
            torch.equal(p["unet"]["state_dict"][k], ema[k].cpu()) for k in ema):
        raise AssertionError("train: the exported UNet is not the EMA weights")
    if set(p["vae"]["state_dict"]) != set(tr.vae.state_dict()) or set(p["text_encoder"]["state_dict"]) != set(
            tr.clip.state_dict()):
        raise AssertionError("train: the exported VAE or text encoder does not match the trainer's")
    log(f"train: end_training() exported the pipeline in {export_s:.1f} s; load_pipeline_dir reads it back, "
        "the UNet equal to the EMA weights")

    # --log_previews: one category's preview grid of 2 samples (50 DDIM
    # steps, CFG 7.5 against the domain's negative prompt, EMA weights)
    fa.flash_fwd_nomax.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.save_logs(tr.sample(categories=["abbey"], num_samples=2))
    torch.cuda.synchronize()
    preview_s = time.perf_counter() - t0
    preview_launches = fa.flash_fwd_nomax.launches
    grid = os.path.join(args.output_dir, "plots", str(tr.global_step), "abbey.png")
    from PIL import Image

    with Image.open(grid) as im:
        grid_size = im.size
    if preview_launches != 10 * args.num_inference_steps or grid_size != (2 * px, px):
        raise AssertionError(f"train preview: {preview_launches} launches of K1 (expected 10 a step, "
                             f"{args.num_inference_steps} steps), grid {grid_size}")
    log(f"train: sample() + save_logs(): {args.num_inference_steps}-step preview of 2 samples in {preview_s:.2f} s "
        f"(EMA weights, bf16 autocast), K1 launched {preview_launches} times, grid {grid_size} written")
    del tr, batches, p
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(steps=n_steps, batch=batch, px=px, losses=losses, step_ms=[x * 1e3 for x in step_s],
                warm_step_ms=warm_ms, images_per_s=batch / warm_ms * 1e3, peak_gib=peak_gib,
                remat_step_ms=remat_ms[1], remat_peak_gib=remat_peak_gib, launches=launches,
                remat_launches=remat_launches, grad_rel_l2=rel, export_s=export_s, profile=profile,
                preview_s=preview_s, preview_launches=preview_launches, card=smi)


def k3_case(g, name, b, h, l, d):
    """K3 (bf16) at [b, h, l, d] on fused-QKV-like views against its plain
    version at the kernel's key tile, with event and device times, the
    plain version's, sdpa's and the bound. These launches are not the main
    path's."""
    import torch
    import torch.nn.functional as F

    from diffmining_tpu_torch.ops import flash_attention as fa

    def k3_plain(q, k, v):
        return fa.flash_fwd_online_plain(q, k, v, block_k=fa.ONLINE_BLOCK_K)  # the kernel's key tiles

    q, k, v = [torch.randn(b, l, h * d, generator=g, device="cuda").to(torch.bfloat16)
               .view(b, l, h, d).transpose(1, 2) for _ in range(3)]
    got = fa.flash_fwd_online(q, k, v)
    torch.cuda.synchronize()
    max_err, worst = kernel_error(got, plain_chunked(k3_plain, q, k, v))
    # every shape is timed before a disagreement raises
    ms = cuda_time_ms(lambda: fa.flash_fwd_online(q, k, v))
    plain_ms = cuda_time_ms(lambda: plain_chunked(k3_plain, q, k, v), reps=3, warmup=1)
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    _, device_ms = device_split(lambda: fa.flash_fwd_online(q, k, v), "flash_fwd_online_kernel")
    lib_device, _ = device_split(lambda: F.scaled_dot_product_attention(q, k, v), "")
    bound, by, exp2 = training_bound("K3", b, h, l, d)
    log(f"kernel K3 {name} B{b} H{h}: max|err| {max_err:.3g} = {worst:.3g} x tolerance  ms {ms:.4f}  "
        f"device {device_ms:.4f}  plain {plain_ms:.3f}  sdpa forward {lib_ms:.4f} (device {lib_device:.4f})  "
        f"bound {bound:.4f} ({by})  exp2 {exp2:.4f}")
    if worst > 1.0 or not torch.isfinite(got).all():
        raise AssertionError(f"K3 {name}: kernel disagrees with the plain version ({worst:.3g} x the tolerance)")
    del q, k, v, got
    torch.cuda.empty_cache()
    return dict(shape=[b, h, l, d], max_abs_err=max_err, err_over_tol=worst, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_device, library="sdpa forward",
                bound_ms=bound, bound_by=by)


def phase_inference_kernels(smi):
    """K3 and K7 against their plain versions at the mining path's shapes,
    with times and bounds. These launches are not the main path's."""
    import torch

    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops.attention import sdpa_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 5)

    def k3_plain(q, k, v):
        return fa.flash_fwd_online_plain(q, k, v, block_k=fa.ONLINE_BLOCK_K)  # the kernel's key tiles

    results = {"K3": {}}
    for name, shape in [("L4096 D40", (8, 8, 4096, 40)), ("L1024 D80", (8, 8, 1024, 80)),
                        ("L4096 D160", (2, 8, 4096, 160)), ("masked tail L1100 D160", (2, 8, 1100, 160))]:
        results["K3"][name] = k3_case(g, name, *shape)

    # the underflow edge: every natural logit -95, where the no-max kernel
    # gives zeros; K3 keeps the running max and gives the softmax
    d, l = 40, 1024
    q = torch.zeros(1, 2, l, d, device=dev)
    k = torch.zeros(1, 2, l, d, device=dev)
    q[..., 0] = -95.0 * math.sqrt(d)
    k[..., 0] = 1.0
    v = torch.randn(1, 2, l, d, generator=g, device=dev)
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    got = fa.flash_fwd_online(q, k, v)
    torch.cuda.synchronize()
    _, worst = kernel_error(got, k3_plain(q, k, v))
    softmax = sdpa_plain(q.float(), k.float(), v.float())
    soft_err = float((got.float() - softmax).abs().max())
    if worst > 1.0 or soft_err > 2.0**-7 * float(softmax.abs().max()) or float(got.float().abs().max()) == 0.0:
        raise AssertionError(f"K3 underflow edge: {worst:.3g} x the tolerance, {soft_err} off the softmax")
    log(f"kernel K3 underflow edge (all natural logits -95): the softmax, within {soft_err:.3g} of it; "
        "the no-max kernel gives zeros there (phase 3)")

    results["K7"] = phase_fused_norm(smi)
    return results


def phase_fused_norm(smi):
    """K7 (the statistics kernel, then the normalise + projection kernel)
    against its plain version at the mining path's shapes, with the
    statistics checked, device times of both kernels, the bound and the
    library pair by events and device time."""
    import torch
    import torch.nn.functional as F

    from diffmining_tpu_torch.ops import fused_norm as fn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    results = {}
    # the four SpatialTransformer entries of a 512px pass at batch 8 (the
    # first of a level takes NCHW x, the ones after a transformer's proj_out
    # channels-last x), odd pixel counts in both layouts (element loads for
    # NCHW x), the SiLU variant, and data whose mean is large against its
    # spread
    cases = [("N4096 C320", (8, 64, 64, 320, "none", "nchw", 0.5)),
             ("N1024 C640", (8, 32, 32, 640, "none", "nchw", 0.5)),
             ("N256 C1280", (8, 16, 16, 1280, "none", "nchw", 0.5)),
             ("N64 C1280", (8, 8, 8, 1280, "none", "nchw", 0.5)),
             ("channels-last N4096 C320", (8, 64, 64, 320, "none", "channels_last", 0.5)),
             ("channels-last N1024 C640", (8, 32, 32, 640, "none", "channels_last", 0.5)),
             ("odd N4095 C320", (8, 63, 65, 320, "none", "nchw", 0.5)),
             ("channels-last odd N4095 C320", (8, 63, 65, 320, "none", "channels_last", 0.5)),
             ("silu N1024 C640", (8, 32, 32, 640, "silu", "nchw", 0.5)),
             ("silu N64 C1280", (8, 8, 8, 1280, "silu", "nchw", 0.5)),
             ("large-mean N1024 C640", (8, 32, 32, 640, "none", "nchw", 300.0))]
    for name, (b, hh, ww, c, act, layout, mean0) in cases:
        x = (torch.randn(b, c, hh, ww, generator=g, device=dev) * (1 if mean0 > 1 else 2) + mean0).to(torch.bfloat16)
        if layout == "channels_last":  # as the UNet hands it after a transformer's proj_out
            x = x.contiguous(memory_format=torch.channels_last)
        gamma, beta, bias = ((torch.randn(c, generator=g, device=dev) * s + o).to(torch.bfloat16)
                             for s, o in ((0.3, 1.0), (0.3, 0.0), (0.5, 0.0)))
        weight = (torch.randn(c, c, 1, 1, generator=g, device=dev) / math.sqrt(c)).to(torch.bfloat16)
        xv, w = x.permute(0, 2, 3, 1), weight[:, :, 0, 0].t()  # the UNet's activations viewed as NHWC; [C, Cout]
        stats = torch.empty(b, 2, c, device=dev)
        got = fn.gn_act_proj(xv, gamma, beta, w, bias, 32, act=act, stats=stats)
        torch.cuda.synchronize()
        mean, rsig = fn.group_stats_plain(xv, 32, 1e-6)
        mean_err = float((stats[:, 0] - mean).abs().max() / xv.float().abs().max())
        rsig_err = float((stats[:, 1] / rsig - 1).abs().max())
        if not mean_err <= GN_MEAN_TOL or not rsig_err <= GN_RSIG_RTOL:
            raise AssertionError(f"K7 {name}: statistics off the plain version's (mean {mean_err:.3g} of max|x|, "
                                 f"rsig {rsig_err:.3g} relative)")
        want = fn.gn_act_proj_plain(xv, gamma, beta, w, bias, 32, act=act)
        max_err, worst = kernel_error(got, want, rounded_before=want.float() - bias.float())
        if worst > 1.0 or not torch.isfinite(got).all():
            raise AssertionError(f"K7 {name}: kernel disagrees with the plain version ({worst:.3g} x the tolerance)")
        call = lambda: fn.gn_act_proj(xv, gamma, beta, w, bias, 32, act=act)  # noqa: E731
        ms = cuda_time_ms(call)
        plain_ms = cuda_time_ms(lambda: fn.gn_act_proj_plain(xv, gamma, beta, w, bias, 32, act=act), reps=3, warmup=1)
        # the call launches the statistics kernel, then the projection kernel
        busy_ms, proj_ms, stats_ms = device_split(call, "gn_act_proj_kernel", other="gn_stats_kernel")
        lib_ms = lib_device = None
        if act == "none":
            lib = lambda: F.conv2d(F.group_norm(x, 32, gamma, beta, 1e-6), weight, bias)  # noqa: E731
            lib_ms = cuda_time_ms(lib)
            lib_device, _ = device_split(lib, "")
        bound, by = gn_proj_bound(b, hh * ww, c, c)
        results[name] = dict(shape=[b, hh * ww, c, c], act=act, layout=layout, max_abs_err=max_err,
                                   err_over_tol=worst, stats_mean_err=mean_err, stats_rsig_err=rsig_err, ms=ms,
                                   plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_device,
                                   library="F.group_norm + 1x1 F.conv2d (two calls)", bound_ms=bound, bound_by=by,
                                   device_ms=busy_ms, stats_device_ms=stats_ms, proj_device_ms=proj_ms)
        lib_txt = f"{lib_ms:.4f} (device {lib_device:.4f})" if lib_ms is not None else "-"
        log(f"kernel K7 {name} B{b} act={act}: max|err| {max_err:.3g} = {worst:.3g} x tolerance, statistics "
            f"{mean_err:.3g} / {rsig_err:.3g}; ms {ms:.4f} (device {busy_ms:.4f} = statistics {fmt(stats_ms)} + "
            f"projection {fmt(proj_ms)})  plain {plain_ms:.3f}  group_norm+conv2d {lib_txt}  bound {bound:.4f} ({by}) "
            f"on {smi}")
        del x, xv, got, want
        torch.cuda.empty_cache()
    return results


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def modes_pass_times(sd2, x, t, ctx):
    """A modes-on UNet pass (the DIFT pass: batch 8 with the up-block tap):
    its CUDA-event time, its device busy time and K7's part of it (16
    projection launches and their statistics), by torch.profiler."""
    pass_fn = lambda: sd2.unet(x, t, ctx, up_ft_indices=(1,))  # noqa: E731
    pass_ms = cuda_time_ms(pass_fn, reps=5, warmup=1)
    busy_ms, proj_ms, stats_ms = device_split(pass_fn, "gn_act_proj_kernel", launches=16, other="gn_stats_kernel")
    k7_ms = None if proj_ms is None else 16 * proj_ms + stats_ms
    return dict(pass_ms=pass_ms, busy_ms=busy_ms, k7_ms=k7_ms, k7_proj_ms=proj_ms, k7_stats_ms=stats_ms)


def phase_modes_pass(smi):
    """The mining phase's modes-on UNet pass alone, on a fresh SD-v1.5 bundle
    under DIFFMINING_FUSED_NORM=1, DIFFMINING_FLASH_ONESHOT=0 and
    DIFFMINING_FLASH_NOMAX=0 (to time it against another tree in one call)."""
    import torch

    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.typicality.compute import SD

    modes = {"DIFFMINING_FUSED_NORM": "1", "DIFFMINING_FLASH_ONESHOT": "0", "DIFFMINING_FLASH_NOMAX": "0"}
    saved_env = {k: os.environ.get(k) for k in modes}
    saved_gates = fa._ONESHOT, fa._NOMAX
    os.environ.update(modes)
    fa._ONESHOT, fa._NOMAX = "0", "0"
    try:
        sd2 = SD.init_random("ftt", ["1920", "1960"], SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED,
                             dtype=torch.bfloat16, device="cuda")
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 7)
        x = torch.randn(8, 4, 64, 64, generator=g, device="cuda")
        t = torch.full((8,), 161, device="cuda", dtype=torch.long)
        ctx = sd2.country_embeds["1920"][None].expand(8, -1, -1)
        with torch.inference_mode():
            times = modes_pass_times(sd2, x, t, ctx)
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        fa._ONESHOT, fa._NOMAX = saved_gates
    log(f"modes-on UNet pass (B=8, 512px, t=161, tap): {times['pass_ms']:.3f} ms, device busy {times['busy_ms']:.3f} ms, "
        f"K7 {fmt(times['k7_ms'])} ms (16 projections x {fmt(times['k7_proj_ms'])} + statistics "
        f"{fmt(times['k7_stats_ms'])}) "
        f"on {smi}")
    del sd2
    torch.cuda.empty_cache()
    return times


def phase_mining(smi):
    """The mining path: sweep, then Cluster.clustering("dift-161") under the
    default modes and under the K3/K7 modes, on synthetic PNGs."""
    import numpy as np
    import torch
    from PIL import Image

    from diffmining_tpu_torch.models import unet as unet_mod
    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops import fused_norm as fn
    from diffmining_tpu_torch.ops.attention import sdpa, sdpa_plain
    from diffmining_tpu_torch.typicality.cluster import Cluster
    from diffmining_tpu_torch.typicality.compute import SD, Typicality
    from diffmining_tpu_torch.typicality.templates import dift_prompt
    from diffmining_tpu_torch.utils.images import array_from_uint8, image_uid

    labels, per_label, px, N, feature = ["1920", "1960"], 24, 512, 4, "dift-161"  # 64 a label until PR 11
    work = os.path.join(ROOT, "build", "chip_smoke_mining")
    shutil.rmtree(work, ignore_errors=True)
    data, tree, subs = (os.path.join(work, n) for n in ("ftt", "typicality", "subs"))
    rng = np.random.RandomState(SEED + 6)
    t0 = time.perf_counter()
    for c in labels:
        os.makedirs(os.path.join(data, c))
        for i in range(per_label):
            # names unique across labels: patch ids, the embedding cache and
            # the DIFT draws key on the file name, as in the reference
            Image.fromarray(rng.randint(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(data, c, f"{c}_img{i}.png"), compress_level=1)
    log(f"mining: {len(labels)} labels x {per_label} synthetic {px}x{px} PNGs (numpy, seeded; reduced from 64 a "
        f"label for the script's time) written in {time.perf_counter() - t0:.1f} s; the sweep and the miner decode them")

    def bundle():
        return SD.init_random("ftt", labels, SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED, dtype=torch.bfloat16,
                              device="cuda")

    sd = bundle()
    typ = Typicality("ftt", None, data, tree, t_min=0.1, t_max=0.9, sd=sd, N=N, batch_images=8, chunk=1,
                     device="cuda")
    typ.make_submission(data, subs, sub_split=1)
    t0 = time.perf_counter()
    typ.compute_submission(os.path.join(subs, "0.txt"))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    log(f"mining: swept {len(labels) * per_label} images at N={N} in {sweep_s:.1f} s")

    kernels = (fa.flash_fwd_nomax, fa.flash_fwd_online, fn.gn_act_proj)

    def mine(sd_, cache):
        """One clustering run with the CLI defaults; the counts are set to 0
        just before it and read just after."""
        cl = Cluster("ftt", tree, data, cache, dift_sd=sd_, device="cuda")
        cl.init_dift()
        forward, dift_s = cl.dift.forward, [0.0]

        def timed(*a, **k):
            t = time.perf_counter()
            out = forward(*a, **k)  # returns host numpy: synchronised
            dift_s[0] += time.perf_counter() - t
            return out

        cl.dift.forward = timed
        for f in kernels:
            f.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        ranked = cl.clustering(feature, k=1000, num_clusters=32)
        wall = time.perf_counter() - t
        launches = {f.__name__: f.launches for f in kernels}
        cl.dift.forward = forward
        return cl, ranked, launches, dict(wall_s=wall, dift_s=dift_s[0], passes=cl.dift.n_passes,
                                          dift_images_per_s=cl.dift.n_passes / dift_s[0])

    def check_clusters(cl, ranked, tag):
        tables = cl.patch_tables()
        for c in labels:
            top = cl.get_top_k(tables[c][0], k=1000)
            ids = [m[2] for members, _ in ranked[c] for m in members]
            want = {os.path.splitext(os.path.basename(p))[0] + f"_{x0}-{y0}-{x1}-{y1}" for p, x0, y0, x1, y1 in
                    zip(top.seed, top.x_start, top.y_start, top.x_end, top.y_end)}
            if len(ids) != len(set(ids)) or set(ids) != want:
                raise AssertionError(f"mining {tag} {c}: {len(ids)} members for {len(want)} top patches")
            scores = [s for _, s in ranked[c]]
            medians = [float(np.median([m[1] for m in members])) for members, _ in ranked[c]]
            if scores != sorted(scores, reverse=True) or not np.allclose(scores, medians):
                raise AssertionError(f"mining {tag} {c}: clusters not sorted by median D")
            crops = os.listdir(os.path.join(cl.cache_path, "images", "clusters", "ranked", feature, c))
            if len(crops) != len(ids):
                raise AssertionError(f"mining {tag} {c}: {len(crops)} member crops for {len(ids)} members")
        return {c: len(ranked[c]) for c in labels}, sum(len(cl.get_top_k(tables[c][0], k=1000)) for c in labels)

    runs = {}
    cl1, ranked1, launches1, stats1 = mine(sd, os.path.join(work, "cache_default"))
    want1 = {"flash_fwd_nomax": 10 * stats1["passes"], "flash_fwd_online": 0, "gn_act_proj": 0}
    if launches1 != want1:
        raise AssertionError(f"mining (default modes): launches {launches1}, expected {want1}")
    n_clusters, n_patches = check_clusters(cl1, ranked1, "default")
    runs["default"] = dict(stats1, launches=launches1, clusters=n_clusters, patches=n_patches)
    log(f"mining (default modes): {n_patches} top patches in {n_clusters} clusters; {stats1['passes']} DIFT passes "
        f"(E=8); launches {launches1}; wall {stats1['wall_s']:.1f} s, DIFT {stats1['dift_s']:.1f} s = "
        f"{stats1['dift_images_per_s']:.2f} images/s on {smi}")

    modes = {"DIFFMINING_FUSED_NORM": "1", "DIFFMINING_FLASH_ONESHOT": "0", "DIFFMINING_FLASH_NOMAX": "0"}
    saved_env = {k: os.environ.get(k) for k in modes}
    saved_gates = fa._ONESHOT, fa._NOMAX
    os.environ.update(modes)
    fa._ONESHOT, fa._NOMAX = "0", "0"  # the gates are read at import: set them as the tests do
    try:
        sd2 = bundle()
        if not sd2.unet.config.fused_norm:
            raise AssertionError("DIFFMINING_FUSED_NORM=1 did not turn the bundle's fused entry on")
        cl2, ranked2, launches2, stats2 = mine(sd2, os.path.join(work, "cache_modes"))
        want2 = {"flash_fwd_nomax": 0, "flash_fwd_online": 10 * stats2["passes"], "gn_act_proj": 16 * stats2["passes"]}
        if launches2 != want2:
            raise AssertionError(f"mining (K3/K7 modes): launches {launches2}, expected {want2}")
        n_clusters, n_patches = check_clusters(cl2, ranked2, "modes")
        runs["modes"] = dict(stats2, launches=launches2, clusters=n_clusters, patches=n_patches)
        log(f"mining (FUSED_NORM=1, ONESHOT=0, NOMAX=0): {n_patches} top patches in {n_clusters} clusters; "
            f"{stats2['passes']} DIFT passes; launches {launches2} = 10 of K3 and 16 of K7 a pass; wall "
            f"{stats2['wall_s']:.1f} s, DIFT {stats2['dift_s']:.1f} s = {stats2['dift_images_per_s']:.2f} images/s")

        # the DIFT feature map of one image under both modes (same weights and draws)
        path = os.path.join(data, labels[0], f"{labels[0]}_img0.png")
        arr = array_from_uint8(np.asarray(Image.open(path).convert("RGB")))
        prompt = dift_prompt("ftt", labels[0])
        f_default = torch.from_numpy(cl1.dift.forward(arr, prompt, t=161, uid=image_uid(path)))
        f_modes = torch.from_numpy(cl2.dift.forward(arr, prompt, t=161, uid=image_uid(path)))
        dift_rel = rel_l2(f_modes, f_default)
        if not (torch.isfinite(f_modes).all() and dift_rel < DIFT_MODES_REL_L2):
            raise AssertionError(f"DIFT feature map, K3/K7 modes vs default modes: relative L2 {dift_rel}")
        log(f"mining: DIFT feature map {tuple(f_modes.shape)} of one image, K3/K7 modes vs default modes: relative "
            f"L2 {dift_rel:.4g} (limit {DIFT_MODES_REL_L2})")

        # one modes-on UNet pass (batch 8, t=161, with the tap) against float32
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 7)
        x = torch.randn(8, 4, px // 8, px // 8, generator=g, device="cuda")
        t = torch.full((8,), 161, device="cuda", dtype=torch.long)
        ctx = sd2.country_embeds[labels[0]][None].expand(8, -1, -1)
        with torch.inference_mode():
            before = [f.launches for f in kernels]
            out16 = sd2.unet(x, t, ctx, up_ft_indices=(1,))
            per_pass = [f.launches - b for f, b in zip(kernels, before)]
            if per_pass != [0, 10, 16]:
                raise AssertionError(f"modes-on UNet pass launched {per_pass} of K1, K3, K7")
            pass_times = modes_pass_times(sd2, x, t, ctx)
            pass_ms = pass_times["pass_ms"]
            # the float32 reference: this pass alone takes the module path
            # and the plain softmax
            cfg = sd2.unet.config
            sd2.unet.config = dataclasses.replace(cfg, fused_norm=False)
            unet_mod.sdpa = sdpa_plain
            try:
                out32 = sd2.unet.float()(x, t, ctx, up_ft_indices=(1,))
            finally:
                unet_mod.sdpa = sdpa
                sd2.unet.config = cfg
                sd2.unet.to(torch.bfloat16)
        rel = rel_l2(out16["sample"], out32["sample"])
        tap_rel = rel_l2(out16["up_ft"][1], out32["up_ft"][1])
        if not (torch.isfinite(out16["sample"]).all() and rel < UNET_REL_L2 and tap_rel < UNET_REL_L2):
            raise AssertionError(f"modes-on UNet pass vs float32: relative L2 {rel} (eps), {tap_rel} (tap)")
        log(f"mining: modes-on UNet pass (B=8, 512px, t=161) vs float32 + plain attention + module path: relative "
            f"L2 {rel:.4g} (eps), {tap_rel:.4g} (up block 1 tap) (limit {UNET_REL_L2}); {pass_ms:.2f} ms a pass, "
            f"device busy {pass_times['busy_ms']:.3f} ms, of which K7 {fmt(pass_times['k7_ms'], '.3f')} ms (16 calls) "
            f"on {smi}")
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        fa._ONESHOT, fa._NOMAX = saved_gates
    del sd, sd2, cl1, cl2
    torch.cuda.empty_cache()
    # the data, the swept tree and the default run's patch tables stay for
    # phase 14's clip+dift-161 run; main() removes them after it
    return dict(labels=len(labels), images_per_label=per_label, px=px, N=N, feature=feature, sweep_s=sweep_s,
                runs=runs, unet_rel_l2_modes=rel, tap_rel_l2_modes=tap_rel, dift_modes_rel_l2=dift_rel,
                unet_pass_ms_modes=pass_ms, unet_pass_modes=pass_times, card=smi,
                work=dict(root=work, data=data, tree=tree, tables=os.path.join(work, "cache_default", "clusters")))


def sdpa_query_chunked(q, k, v, mask=None, scale=None):
    """sdpa_plain over query blocks whose float32 logits stay near 1 GiB: the
    float32 reference at 1024px, where one L=16384 self-attention's logits
    for all its rows would take 17 GB."""
    import torch

    from diffmining_tpu_torch.ops.attention import sdpa_plain

    rows = max(1, (1 << 28) // (q.shape[0] * q.shape[1] * k.shape[2]))
    return torch.cat([sdpa_plain(q[:, :, i:i + rows], k, v, mask, scale) for i in range(0, q.shape[2], rows)], dim=2)


class RouteCounts:
    """Counts the gated forwards by the TPU kernel they replace (K1, K2) and
    the shapes each saw, by wrapping ``ops.attention.FORWARD``'s entries;
    ``flash_fwd_nomax.launches`` counts the launches themselves. With
    ``injected``, a K1 call whose q was made by the UNet's injection is
    counted apart and its first (q, k, v) at ``keep_len`` kept."""

    def __init__(self, injected=False, keep_len=4096):
        from diffmining_tpu_torch.models import unet as unet_mod
        from diffmining_tpu_torch.ops import attention

        self.attention, self.unet_mod = attention, unet_mod
        self.saved = dict(attention.FORWARD)
        self.apply = unet_mod._apply_injection
        self.counts = {"K1": 0, "K2": 0, "K1 injected": 0}
        self.shapes = {"K1": set(), "K2": set()}
        self.kept = None
        for kind in ("K1", "K2"):
            attention.FORWARD[kind] = self._counting(kind, self.saved[kind], keep_len)
        if injected:
            def marking(current, value):
                out = self.apply(current, value)
                if out is not current:
                    out._injected = True  # a tensor attribute: the activation was replaced
                return out

            unet_mod._apply_injection = marking

    def _counting(self, kind, fn, keep_len):
        def call(q, k, v, scale=None):
            self.counts[kind] += 1
            self.shapes[kind].add(tuple(q.shape))
            if getattr(q, "_injected", False):
                self.counts[kind + " injected"] += 1
                if self.kept is None and q.shape[2] == keep_len:
                    self.kept = (q, k, v)
            return fn(q, k, v, scale)
        return call

    def close(self):
        self.attention.FORWARD.update(self.saved)
        self.unet_mod._apply_injection = self.apply


def xray_data(root, diseases, per_disease, px, seed):
    """Synthetic grayscale PNGs with a findings table and a bbox table in
    the CSV's coordinates, twice the image's: the loader halves them, and
    every halved box lies inside the image."""
    import csv

    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"))
    meta, boxes = [("Image Index", "Finding Labels")], [("Image Index", "Finding Label", "Bbox [x", "y", "w", "h]")]
    for d in diseases:
        for i in range(per_disease):
            name = f"{d}_{i:03d}.png"  # unique across diseases: the draws key on the file name
            Image.fromarray(rng.randint(0, 256, (px, px), dtype=np.uint8), mode="L").save(
                os.path.join(root, "images", name), compress_level=1)
            meta.append((name, d))
            x, y = rng.uniform(0, 1.2 * px, 2)
            w, h = rng.uniform(0.2 * px, 0.6 * px, 2)
            boxes.append((name, d, f"{x:.2f}", f"{y:.2f}", f"{w:.2f}", f"{h:.2f}"))
    for name, rows in (("metadata.csv", meta), ("BBox_List_2017.csv", boxes)):
        with open(os.path.join(root, name), "w", newline="") as f:
            csv.writer(f).writerows(rows)


def phase_xray(smi, sd):
    """X-ray localization at 1024px through XRayTypicality.main: 2 diseases x
    4 synthetic images, N=6 (cut from 100 for time), chunk 3, groups of 4
    (UNet batch 24); level 0 self-attends at L=16384 (K2). Phase 3 holds the
    kernels at this path's shapes."""
    import numpy as np
    import torch

    from diffmining_tpu_torch.applications.xray import XRayTypicality
    from diffmining_tpu_torch.models import unet as unet_mod
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops.attention import sdpa

    diseases, per, px, N, chunk, batch_images = ["Cardiomegaly", "Effusion"], 4, 1024, 6, 3, 4
    work = os.path.join(ROOT, "build", "chip_smoke_xray")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "CXR8")
    t0 = time.perf_counter()
    xray_data(data, diseases, per, px, SEED + 10)
    log(f"xray: {len(diseases)} diseases x {per} synthetic {px}x{px} grayscale PNGs with metadata.csv and "
        f"BBox_List_2017.csv (numpy, seeded) written in {time.perf_counter() - t0:.1f} s")

    xr = XRayTypicality(sd, data, os.path.join(work, "out"), diseases, N=N, chunk=chunk)
    routes = RouteCounts()
    fa.flash_fwd_nomax.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        report, auc = xr.main(batch_images=batch_images)
        torch.cuda.synchronize()
    finally:
        routes.close()
    main_s = time.perf_counter() - t0
    launches = fa.flash_fwd_nomax.launches
    passes = len(diseases) * math.ceil(per / batch_images) * (N // chunk)
    if launches != 15 * passes or routes.counts["K2"] != 5 * passes or routes.counts["K1"] != 10 * passes:
        raise AssertionError(f"xray: {launches} launches of flash_fwd_nomax, routes {routes.counts}; expected 5 of K2 "
                             f"and 10 of K1 per UNet pass, {passes} passes")
    log(f"xray: main() in {main_s:.1f} s (first run); flash_fwd_nomax launched {launches} times = 5 K2 + 10 K1 per "
        f"UNet pass x {passes} passes; shapes K2 {sorted(routes.shapes['K2'])}, K1 {sorted(routes.shapes['K1'])}")
    for d in diseases:
        for fpath, _ in xr.parent[d]:
            name = os.path.splitext(os.path.basename(fpath))[0]
            dm = np.load(os.path.join(work, "out", d, "typicality", f"{name}_loss_pixel.npy"))
            if dm.shape != (px, px) or not np.isfinite(dm).all():
                raise AssertionError(f"xray: pixel map {name}: {dm.shape}, finite {np.isfinite(dm).all()}")
        for table in (report, auc):
            vals = table[d]
            if len(vals) != per or not all(math.isfinite(x) for x in vals.values()):
                raise AssertionError(f"xray: {d}: {vals}")
    for name in ("report.json", "auc.json"):
        if json.load(open(os.path.join(work, "out", name))) != (report if name == "report.json" else auc):
            raise AssertionError(f"xray: {name} does not hold what main() returned")
    log(f"xray: {len(diseases) * per} pixel maps [{px}, {px}] float32, all finite; report.json and auc.json hold "
        f"one finite value per image; mean AUC-PR {np.mean([x for d in auc.values() for x in d.values()]):.4g}")

    # one bf16 UNet pass at 1024px (one image: its cond/null pair) against
    # float32 through a query-chunked plain attention
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 11)
    x = torch.randn(1, 4, px // 8, px // 8, generator=g, device="cuda")
    t = torch.randint(0, 1000, (1,), generator=g, device="cuda")
    ctx = torch.stack([xr.embeds[diseases[0]], xr.embeds[""]])
    with torch.inference_mode():
        before = fa.flash_fwd_nomax.launches
        eps16 = sd.unet(x, t, ctx, ctx_tile=2).float()
        if fa.flash_fwd_nomax.launches - before != 15:
            raise AssertionError("xray: the 1024px bf16 UNet pass did not launch the kernel 15 times")
        unet_mod.sdpa = sdpa_query_chunked  # the float32 reference: this pass alone takes the plain softmax
        try:
            eps32 = sd.unet.float()(x, t, ctx, ctx_tile=2)
        finally:
            unet_mod.sdpa = sdpa
            sd.unet.to(torch.bfloat16)
    rel = rel_l2(eps16, eps32)
    if not (torch.isfinite(eps16).all() and rel < UNET_REL_L2):
        raise AssertionError(f"xray: 1024px UNet pass, bf16+kernels vs float32 plain: relative L2 error {rel}")
    log(f"xray: UNet pass (1 image x cond/null, 1024px, t={int(t)}) bf16+kernels vs float32+plain attention: "
        f"relative L2 error {rel:.4g} (limit {UNET_REL_L2})")
    del eps16, eps32
    torch.cuda.empty_cache()

    # the product setting, N=100 (chunk snaps to 2: UNet batch 16), on one
    # group of 4 after a warm-up pass of the same shapes
    group = [p for p, _ in xr.parent[diseases[0]]][:batch_images]
    XRayTypicality(sd, data, os.path.join(work, "warm"), diseases[:1], N=2, chunk=chunk).pixel_maps(diseases[0], group)
    x100 = XRayTypicality(sd, data, os.path.join(work, "n100"), diseases[:1], N=100, chunk=chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = x100.pixel_maps(diseases[0], group)
    torch.cuda.synchronize()
    dt100 = time.perf_counter() - t0
    if not all(m.shape == (px, px) and np.isfinite(m).all() for m in maps):
        raise AssertionError("xray: an N=100 pixel map is not finite or not the image's shape")
    imgs_hr_100 = batch_images / dt100 * 3600.0
    log(f"xray: N=100 (chunk {x100.engine.chunk}, {100 // x100.engine.chunk} passes of UNet batch "
        f"{batch_images * x100.engine.chunk * 2}) on one warm group of {batch_images} {px}px images in {dt100:.2f} s = "
        f"{imgs_hr_100:.1f} imgs/hr on {smi}")

    # one UNet pass of that grouping (8 unique rows, tiled to 16): its time,
    # its device busy time and the no-max kernel's part (5 K2 + 10 K1)
    rows = batch_images * x100.engine.chunk
    x = torch.randn(rows, 4, px // 8, px // 8, generator=g, device="cuda")
    t = torch.randint(0, 1000, (rows,), generator=g, device="cuda")
    ctx = torch.stack([xr.embeds[diseases[0]], xr.embeds[""]]).repeat(rows, 1, 1)
    with torch.inference_mode():
        pass_fn = lambda: sd.unet(x, t, ctx, ctx_tile=2)  # noqa: E731
        pass_ms = cuda_time_ms(pass_fn, reps=5, warmup=1)
        busy_ms, nomax_ms = device_split(pass_fn, "flash_fwd_nomax_kernel", launches=15)
    nomax_txt = "not measured" if nomax_ms is None else f"{15 * nomax_ms:.2f} ms ({15 * nomax_ms / busy_ms:.1%})"
    log(f"xray: one 1024px UNet pass (batch {2 * rows}, dedup) {pass_ms:.2f} ms; device busy {busy_ms:.2f} ms, of "
        f"which flash_fwd_nomax (5 K2 + 10 K1) {nomax_txt} on {smi}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(diseases=len(diseases), images_per_disease=per, px=px, N=N, chunk=chunk, batch_images=batch_images,
                main_s=main_s, launches=launches, routes={k: routes.counts[k] for k in ("K1", "K2")}, passes=passes,
                unet_rel_l2=rel, imgs_per_hr_n100=imgs_hr_100, n100_s=dt100, unet_pass_ms=pass_ms,
                unet_pass_busy_ms=busy_ms, unet_pass_nomax_ms=None if nomax_ms is None else 15 * nomax_ms, card=smi)


DECODE_REL_L2 = 5e-2  # bf16 rounding through the decoder's ~30 convolutions, as UNET_REL_L2 for the UNet


def phase_sampling(smi, sd):
    """sample_ddim at 512px: 2 prompts, 50 steps, CFG 7.5, then the VAE
    decode; one latent's decode against float32."""
    import torch

    from diffmining_tpu_torch.diffusion.sampling import sample_ddim
    from diffmining_tpu_torch.ops import flash_attention as fa

    px, steps, prompts = 512, 50, ["Chest X-Ray with Cardiomegaly.", "Chest X-Ray with Effusion."]
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 13)
    lat = torch.randn(len(prompts), 4, px // 8, px // 8, generator=g, device="cuda")
    with torch.inference_mode():
        cond = sd.clip(torch.from_numpy(sd.tokenizer(prompts)).long().cuda())
        uncond = sd.clip(torch.from_numpy(sd.tokenizer([""] * len(prompts))).long().cuda())

    def eps_fn(x, t, c):
        return sd.unet(x.to(sd.dtype), t, c)

    routes = RouteCounts()
    fa.flash_fwd_nomax.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            z = sample_ddim(eps_fn, sd.schedule, lat, cond, uncond, num_inference_steps=steps, guidance_scale=7.5)
            images = sd.vae.decode(z)
        torch.cuda.synchronize()
    finally:
        routes.close()
    sample_s = time.perf_counter() - t0
    launches = fa.flash_fwd_nomax.launches
    if launches != 10 * steps or routes.counts["K1"] != 10 * steps or routes.counts["K2"] != 0:
        raise AssertionError(f"sampling: {launches} launches, routes {routes.counts}; expected 10 of K1 a step")
    if tuple(images.shape) != (len(prompts), 3, px, px) or not torch.isfinite(images).all():
        raise AssertionError(f"sampling: decoded images {tuple(images.shape)}, "
                             f"finite {bool(torch.isfinite(images).all())}")
    with torch.inference_mode():
        sd.vae.float()
        try:
            ref = sd.vae.decode(z[:1].float())
        finally:
            sd.vae.to(sd.dtype)
    rel = rel_l2(images[:1], ref)
    if not rel < DECODE_REL_L2:
        raise AssertionError(f"sampling: bf16 decode vs float32: relative L2 error {rel}")
    log(f"sampling: sample_ddim ({len(prompts)} prompts, {steps} steps, CFG 7.5, {px}px) + decode in {sample_s:.2f} s; "
        f"K1 launched {launches} times (10 a step); images finite; one latent's bf16 decode vs float32: relative L2 "
        f"{rel:.4g} (limit {DECODE_REL_L2}) on {smi}")
    return dict(prompts=len(prompts), steps=steps, px=px, sample_s=sample_s, launches=launches, decode_rel_l2=rel,
                card=smi)


def phase_pnp(smi, sd):
    """PnP through Generator's file protocol: 2 synthetic 512px sources
    inverted as one stack over PNP_INVERSION_STEPS steps, reconstructed, and
    translated to 2 target prompts each at 50 steps; then K1 held on the
    injected q/k it received."""
    import numpy as np
    import torch
    from PIL import Image

    from diffmining_tpu_torch.applications.pnp import PNP, Generator
    from diffmining_tpu_torch.ops import flash_attention as fa

    px, n_src, targets = 512, 2, ["France", "Japan"]
    work = os.path.join(ROOT, "build", "chip_smoke_pnp")
    shutil.rmtree(work, ignore_errors=True)
    out = os.path.join(work, "translated")
    rng = np.random.RandomState(SEED + 14)
    # one source from each country, named so that PnP's files follow the geo
    # protocol ({country}__{id}): phase 13 mines them as a parallel dataset
    paths = []
    for i in range(n_src):
        src_dir = os.path.join(work, "base", targets[i])
        os.makedirs(src_dir)
        paths.append(os.path.join(src_dir, f"id__{i:03d}.png"))
        Image.fromarray(rng.randint(0, 256, (px, px, 3), dtype=np.uint8)).save(paths[-1], compress_level=1)

    routes = RouteCounts(injected=True)
    fa.flash_fwd_nomax.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        gen = Generator(sd, paths, inversion_steps=PNP_INVERSION_STEPS)  # and 50 translation steps
        torch.cuda.synchronize()
        invert_s = time.perf_counter() - t0
        gen.plotum(out, targets, batch_size=len(targets))
        torch.cuda.synchronize()
    finally:
        routes.close()
    total_s = time.perf_counter() - t0
    launches, pnp = fa.flash_fwd_nomax.launches, gen.pnp
    n, inv = pnp.n_timesteps, pnp.inversion_steps
    passes = 2 * inv + n_src * (n + int(n * pnp.pnp_f_t))  # inversion, reconstruction, CFG + source passes
    injected = n_src * int(n * pnp.pnp_attn_t) * 6  # q/k injected at up.2 (L1024) and up.3 (L4096), 3 blocks each
    if launches != 10 * passes or routes.counts["K1"] != 10 * passes or routes.counts["K1 injected"] != injected:
        raise AssertionError(f"pnp: {launches} launches, routes {routes.counts}; expected 10 of K1 per UNet pass x "
                             f"{passes} passes, {injected} of them on injected q/k")
    files = set(os.listdir(out))
    for i in range(n_src):
        src = targets[i]
        want = {f"gt--{src}__{i:03d}.png", f"inverted--{src}__{i:03d}.png", f"projected--{src}__{i:03d}.png"}
        want |= {f"{c}__{i:03d}.png" for c in targets if c != src}
        if not want <= files:
            raise AssertionError(f"pnp: missing {sorted(want - files)}")
    if not (torch.isfinite(pnp._trajectory).all() and torch.isfinite(pnp._source_latent).all()):
        raise AssertionError("pnp: the inversion is not finite")
    log(f"pnp: Generator over {n_src} sources ({px}px): inversion ({inv} steps, batch {n_src}) {invert_s:.1f} s; "
        f"plotum (reconstruction, {len(targets)} targets a source at {n} steps) done at {total_s:.1f} s = "
        f"{total_s / n_src:.1f} s per source image on {smi}; K1 launched {launches} times over {passes} UNet passes, "
        f"{routes.counts['K1 injected']} of them on injected q/k; files {sorted(files)}")

    # injection on against off (pnp_f_t = pnp_attn_t = 0), same trajectory
    with torch.inference_mode():
        on = pnp.translate(["Japan"], source=0)
        off_pnp = PNP(sd, pnp_f_t=0.0, pnp_attn_t=0.0)
        off_pnp._trajectory, off_pnp._source_latent = pnp._trajectory, pnp._source_latent
        off = off_pnp.translate(["Japan"], source=0)
    moved = rel_l2(on, off)
    if not (torch.isfinite(on).all() and torch.isfinite(off).all() and moved > 1e-3):
        raise AssertionError(f"pnp: injection on vs off: relative L2 difference {moved}")
    log(f"pnp: translation with injection against pnp_f_t = pnp_attn_t = 0: relative L2 difference {moved:.4g}; "
        "both finite")

    # one inversion step's UNet pass (batch 2): its time and device busy time
    xs = pnp._source_latent
    ts = torch.full((n_src,), 500, device="cuda", dtype=torch.long)
    with torch.inference_mode():
        ctx = pnp.embed([""]).expand(n_src, -1, -1).to(sd.dtype)
        inv_fn = lambda: sd.unet(xs, ts, ctx)  # noqa: E731
        inv_pass_ms = cuda_time_ms(inv_fn, reps=10, warmup=2)
        inv_busy_ms, _ = device_split(inv_fn, "flash_fwd_nomax_kernel", launches=10)
    log(f"pnp: one inversion UNet pass (batch {n_src}, 512px) {inv_pass_ms:.2f} ms by events, device busy "
        f"{inv_busy_ms:.2f} ms: idle share {max(0.0, 1 - inv_busy_ms / inv_pass_ms):.3f}; the path took "
        f"{invert_s / inv * 1e3:.1f} ms a step of its inversion")

    # K1 on the first injected q/k the path gave it at L=4096 (the broadcast
    # source q/k, materialised), against its plain version; phase 3 times
    # the same layout
    from diffmining_tpu_torch.ops.flash_attention import flash_attention_nomax_plain

    q, k, v = routes.kept
    if 0 in q.stride() or 0 in k.stride():
        raise AssertionError(f"pnp: injected q/k reach the kernel with a zero stride: {q.stride()}, {k.stride()}")
    got = fa.flash_fwd_nomax(q, k, v)
    want = plain_chunked(flash_attention_nomax_plain, q, k, v)
    max_err, worst = kernel_error(got, want)
    flip = p_flip_ratio(got, want, q, k, v)
    if flip > 1.0 or not torch.isfinite(got).all():
        raise AssertionError(f"pnp: K1 on the injected q/k disagrees with the plain version ({worst:.3g} x the "
                             f"one-ulp tolerance, {flip:.3g} x the p-flip one)")
    injected_check = dict(shape=list(q.shape), q_strides=list(q.stride()), k_strides=list(k.stride()),
                          v_strides=list(v.stride()), max_abs_err=max_err, err_over_tol=worst,
                          err_over_p_flip_tol=flip)
    log(f"pnp: K1 on the path's injected q/k {tuple(q.shape)} (q strides {q.stride()}, v strides {v.stride()}) "
        f"against its plain version: max|err| {max_err:.3g} = {worst:.3g} x the one-ulp tolerance, {flip:.3g} x "
        "the p-flip one")
    del routes, q, k, v, got, want
    torch.cuda.empty_cache()
    # PnP's files stay for phase 13 (the parallel dataset); main() removes them
    return dict(out=out, work=work, sources=n_src, px=px, targets=len(targets), inversion_steps=inv, steps=n,
                invert_s=invert_s,
                total_s=total_s, s_per_source=total_s / n_src, launches=launches, passes=passes,
                injected_launches=injected, injection_rel_l2=moved, injected_check=injected_check,
                inversion_pass_ms=inv_pass_ms, inversion_pass_busy_ms=inv_busy_ms, card=smi)


LORA_SITE = "down_blocks.0.attentions.0.transformer_blocks.0.attn1"


def phase_train_lora_8bit(smi, dense):
    """--use_8bit_adam on the dense UNet, then --lora --use_8bit_adam on the
    frozen UNet: the places trainer of phase 6 (SD-v1.5, batch 4 at 512px,
    bf16 autocast, EMA). ``dense`` is phase 6's result (its peak beside
    this phase's)."""
    import torch

    from diffmining_tpu_torch.finetuning import lora
    from diffmining_tpu_torch.models import unet as unet_mod
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops.attention import sdpa, sdpa_plain
    from diffmining_tpu_torch.ops.optim8bit import Adam8bitState
    from diffmining_tpu_torch.utils.weights import load_pipeline_dir

    batch, px, n_images = 4, 512, 8
    work = os.path.join(ROOT, "build", "chip_smoke_lora")
    kernels = (fa.flash_fwd_lse, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_nomax)

    def steps(tr, args, batches, n, want):
        """n train steps, each checked for its launches; -> step ms, peak GiB."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i in range(n):
            for f in kernels:
                f.launches = 0
            t0 = time.perf_counter()
            tr.state, loss = tr.train_step(tr.state, *batches[i % len(batches)], args.seed)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            got = {f.__name__: f.launches for f in kernels}
            if got != want or not math.isfinite(float(loss)):
                raise AssertionError(f"train_lora_8bit: step launches {got}, expected {want}; loss {float(loss)}")
        return ms, torch.cuda.max_memory_allocated() / 2**30

    per_step = {"flash_fwd_lse": 10, "flash_bwd_dq": 10, "flash_bwd_dkv": 10, "flash_fwd_nomax": 0}
    remat_step = dict(per_step, flash_fwd_lse=20)

    # (a) the dense UNet under 8-bit Adam: a cold and two warm steps, as
    # phase 6 times AdamW, then two traced
    tr, args, batches = places_trainer(work, batch, px, n_images, max_train_steps=3, extra=["--use_8bit_adam"])
    inner = tr.state.opt_state
    numel = sum(p.numel() for p in tr.state.params.values())
    if not (isinstance(inner, Adam8bitState) and all(q.dtype == torch.int8 for q in inner.mu_q + inner.nu_q)):
        raise AssertionError("train_lora_8bit: --use_8bit_adam did not give int8 moments")
    ms8, peak8 = steps(tr, args, batches, 3, per_step)
    warm8 = statistics.median(ms8[1:])
    state_bytes = inner.nbytes()
    if not (inner.count == 3 and peak8 < dense["peak_gib"]):
        raise AssertionError(f"train_lora_8bit: 8-bit count {inner.count}, peak {peak8:.2f} GiB against the dense "
                             f"AdamW step's {dense['peak_gib']:.2f} GiB")
    log(f"train_lora_8bit: dense UNet, --use_8bit_adam: steps {', '.join(f'{x:.1f}' for x in ms8)} ms; warm median "
        f"{warm8:.1f} ms = {batch / warm8 * 1e3:.2f} images/s (phase 6's AdamW {dense['warm_step_ms']:.1f} ms); peak "
        f"allocated {peak8:.2f} GiB against phase 6's {dense['peak_gib']:.2f} GiB; optimizer state "
        f"{state_bytes / 1e9:.3f} GB in {len(inner.groups)} groups (float32 moments: {8 * numel / 1e9:.3f} GB for "
        f"{numel / 1e6:.1f}M parameters); int8 moments on {smi}")
    profile8 = profile_steps(tr, args, [batches[i % len(batches)] for i in range(3, 5)], warm8)
    del tr, batches, inner
    torch.cuda.empty_cache()

    # (b) --lora --lora_rank 4 --use_8bit_adam on the frozen UNet
    tr, args, batches = places_trainer(work, batch, px, n_images, max_train_steps=4,
                                       extra=["--use_8bit_adam", "--lora", "--lora_rank", "4"])
    st, b = tr.state, tr.builder
    base = {k: p.detach().clone() for k, p in tr.unet.named_parameters()}
    if any(p.requires_grad for p in tr.unet.parameters()) or not all(k.endswith((".a", ".b")) for k in st.params):
        raise AssertionError("train_lora_8bit: the base UNet is not frozen or the state is not the factors")
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 9)
    with torch.no_grad():  # b drawn nonzero: at init b = 0 and a's gradient is zero
        for k, v in st.params.items():
            if k.endswith(".b"):
                v.copy_(1e-2 * torch.randn(v.shape, generator=g, device="cuda"))
                st.ema_params[k].copy_(v)
    names = [f"{LORA_SITE}.to_{n}.{ab}" for n in "qkv" for ab in "ab"]
    images, tokens = batches[0][0][:1], batches[0][1][:1]
    draws = b.draw(SEED + 3, 0, (1, 4, px // 8, px // 8), torch.device("cuda"))

    def factor_grads():
        b.loss(images, tokens, draws=draws).backward()
        grads = {n: st.params[n].grad.float().clone() for n in names}
        for p in st.params.values():
            p.grad = None
        return grads

    g16 = factor_grads()
    b.mixed_precision = False
    unet_mod.sdpa = sdpa_plain  # the float32 reference: this pass alone uses the plain softmax
    try:
        g32 = factor_grads()
    finally:
        unet_mod.sdpa = sdpa
        b.mixed_precision = True
    rel = {n[len(LORA_SITE) + 1:]: float((g16[n] - g32[n]).norm() / g32[n].norm()) for n in names}
    if not all(float(g16[n].abs().max()) > 0 for n in names) or max(rel.values()) >= GRAD_REL_L2:
        raise AssertionError(f"train_lora_8bit: level-0 attn1 factor gradients bf16+kernels vs float32: {rel}")
    log(f"train_lora_8bit: level-0 attn1 factor gradients (b nonzero), bf16+kernels vs float32+plain attention "
        f"(batch 1): relative L2 {', '.join(f'{k} {v:.4g}' for k, v in rel.items())} (limit {GRAD_REL_L2})")

    before = {n: st.params[n].detach().clone() for n in names}
    ema_before = {n: st.ema_params[n].clone() for n in names}
    ms_plain, peak_lora = steps(tr, args, batches, 2, per_step)
    tr.unet.set_gradient_checkpointing("full")
    ms_remat, peak_remat = steps(tr, args, batches[2:] + batches[:2], 2, remat_step)
    tr.unet.set_gradient_checkpointing(None)
    moved = min(float((st.params[n].detach() - before[n]).abs().max()) for n in names)
    ema_moved = min(float((st.ema_params[n] - ema_before[n]).abs().max()) for n in names)
    unchanged = all(torch.equal(p.detach(), base[k]) and p.grad is None for k, p in tr.unet.named_parameters())
    if not (moved > 0 and ema_moved > 0 and unchanged and st.opt_state.count == 4):
        raise AssertionError(f"train_lora_8bit: factors moved {moved}, EMA {ema_moved}, base unchanged {unchanged}, "
                             f"count {st.opt_state.count}")
    n_factors = sum(v.numel() for v in st.params.values())
    log(f"train_lora_8bit: --lora (rank 4, {len(st.params) // 2} sites, {n_factors / 1e6:.3f}M factor parameters) "
        f"--use_8bit_adam: steps {ms_plain[0]:.1f}, {ms_plain[1]:.1f} ms (warm: {batch / ms_plain[1] * 1e3:.2f} "
        f"images/s; phase 6's AdamW {dense['warm_step_ms']:.1f} ms), peak {peak_lora:.2f} GiB; under full "
        f"checkpointing {ms_remat[0]:.1f}, {ms_remat[1]:.1f} ms, peak {peak_remat:.2f} GiB; launches a step "
        f"{per_step} ({remat_step} under checkpointing); factors moved by >= {moved:.3g}, EMA by >= "
        f"{ema_moved:.3g}; the base UNet bit for bit unchanged, no dense gradient")

    t0 = time.perf_counter()
    export_dir = tr.end_training()
    export_s = time.perf_counter() - t0
    p = load_pipeline_dir(export_dir)["unet"]["state_dict"]
    want = lora.merge_lora({k: v.detach() for k, v in tr.unet.named_parameters()}, lora.unflatten(st.ema_params))
    if set(p) != set(want) or not all(torch.equal(p[k], want[k].cpu()) for k in want):
        raise AssertionError("train_lora_8bit: the exported UNet is not merge_lora of the EMA factors")
    log(f"train_lora_8bit: end_training() exported in {export_s:.1f} s; the UNet read back equals merge_lora of the "
        f"base and the EMA factors")
    launches = {"flash_fwd_lse": 2 * 10 + 2 * 20, "flash_bwd_dq": 40, "flash_bwd_dkv": 40}
    del tr, batches, base, p, want, st, b
    kept = os.path.join(ROOT, "build", "chip_smoke_export")  # phase 16 verifies it
    shutil.rmtree(kept, ignore_errors=True)
    shutil.move(export_dir, kept)
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(batch=batch, px=px, dense_8bit=dict(step_ms=ms8, warm_step_ms=warm8, images_per_s=batch / warm8 * 1e3,
                                                   peak_gib=peak8, optimizer_state_bytes=state_bytes,
                                                   float32_moment_bytes=8 * numel, profile=profile8,
                                                   adamw_peak_gib=dense["peak_gib"],
                                                   adamw_warm_step_ms=dense["warm_step_ms"],
                                                   adamw_busy_ms=dense["profile"]["busy_ms"]),
                lora=dict(rank=4, factor_params=n_factors, step_ms=ms_plain, images_per_s=batch / ms_plain[1] * 1e3,
                          peak_gib=peak_lora, remat_step_ms=ms_remat, remat_peak_gib=peak_remat,
                          launches_per_step=per_step, remat_launches_per_step=remat_step, factor_grad_rel_l2=rel,
                          export_s=export_s),
                launches=launches, export_dir=kept, card=smi)


def phase_parallel(smi, pnp_out, sd):
    """The parallel dataset over phase 11's PnP output: ParallelTypicality at
    N=4 over every ground-truth and translated file, then
    ParallelCluster.clustering("dift-161")."""
    import numpy as np
    import torch

    from diffmining_tpu_torch.applications.parallel import ParallelCluster, ParallelTypicality
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.utils.images import array_from_uint8, image_uid
    from PIL import Image

    countries, N, k_per_image = ["France", "Japan"], 4, 5
    work = os.path.join(ROOT, "build", "chip_smoke_parallel")
    shutil.rmtree(work, ignore_errors=True)
    root, tree, subs, cache = (os.path.join(work, n) for n in ("parallel", "typicality", "subs", "cache"))
    # PnP writes every source's files into one directory; the parallel
    # dataset holds each under its source's country, as the reference's
    # per-country PnP jobs write them
    files = sorted(os.listdir(pnp_out))
    source_of = {f.split("__", 1)[1]: f.split("__")[0][len("gt--"):] for f in files if f.startswith("gt--")}
    for f in files:
        dst = os.path.join(root, source_of[f.split("__", 1)[1]])
        os.makedirs(dst, exist_ok=True)
        shutil.copy(os.path.join(pnp_out, f), dst)

    passes = [0]
    hook = sd.unet.register_forward_hook(lambda *a: passes.__setitem__(0, passes[0] + 1))
    try:
        typ = ParallelTypicality(None, root, tree, sd=sd, N=N, batch_images=8, device="cuda")
        groups = {c: typ.parallel[c] for c in countries}
        if sorted(typ.parent) != countries or not all(
                len(gs) == 1 and {c for _p, c in gs[0]} == set(countries) for gs in groups.values()):
            raise AssertionError(f"parallel: the groups of PnP's output are not complete: {groups}")
        typ.make_submission(root, subs, sub_split=1)
        fa.flash_fwd_nomax.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        typ.compute_submission(os.path.join(subs, "0.txt"))
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        sweep_launches, sweep_passes = fa.flash_fwd_nomax.launches, passes[0]
        seeds = {c: typ.get_seeds_(c) for c in countries}
        if sum(map(len, seeds.values())) != 4 or not all(typ.D[c].exists(p) for c in countries for p in seeds[c]):
            raise AssertionError(f"parallel: artifacts missing for {seeds}")
        if sweep_launches != 10 * sweep_passes or sweep_passes == 0:
            raise AssertionError(f"parallel sweep: {sweep_launches} K1 launches over {sweep_passes} UNet passes")

        cl = ParallelCluster(tree, root, cache, dift_sd=sd, device="cuda")
        fa.flash_fwd_nomax.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        df, df_random = cl.df_PD(k_per_image=k_per_image)
        clusters = cl.clustering("dift-161", k_per_image=k_per_image, num_clusters=3, num_components=4)
        torch.cuda.synchronize()
        mine_s = time.perf_counter() - t0
        mine_launches = fa.flash_fwd_nomax.launches
    finally:
        hook.remove()
    dift_passes = cl.dift.n_passes
    for origin in countries:
        gt = groups[origin][0][0][0]
        if (df["path_" + origin] == gt).sum() != k_per_image:
            raise AssertionError(f"parallel: the {origin} source group gave {(df['path_' + origin] == gt).sum()} rows")
    if mine_launches != 10 * dift_passes or dift_passes == 0:
        raise AssertionError(f"parallel: {mine_launches} K1 launches over {dift_passes} DIFT passes")
    scores = [s for _, s in clusters]
    medians = [float(np.median([m[1] for m in members])) for members, _ in clusters]
    if scores != sorted(scores, reverse=True) or not np.allclose(scores, medians) or \
            sum(len(m) for m, _ in clusters) != len(df):
        raise AssertionError(f"parallel: clusters not ranked by the median D: {scores}")
    # country-major: the first block of an embedding is the box's DIFT in
    # the first country's image (from the DIFT cache)
    row = df.sort_values(by=["D"], ascending=False).iloc[0]
    x0, y0, x1, y1 = (int(row[c]) for c in ["x_start", "y_start", "x_end", "y_end"])
    idd = os.path.splitext(os.path.basename(row["path_" + row["origin"]]))[0] + f"_{x0}-{y0}-{x1}-{y1}"
    emb = cl._cached("dift-161", idd, lambda: None)
    first = cl.dift.patch_feature(array_from_uint8(np.asarray(Image.open(row["path_" + countries[0]]).convert("RGB"))),
                                  countries[0], (x0, y0, x1, y1), t=161, uid=image_uid(idd + countries[0]))
    if emb is None or emb.shape != (len(countries) * first.shape[0],) or not np.isfinite(emb).all() or \
            not np.array_equal(emb[:first.shape[0]], first):
        raise AssertionError("parallel: an embedding is not the country-major concatenation of finite DIFT features")
    log(f"parallel: PnP's {len(files)} files as a parallel dataset of {len(countries)} countries x 1 source; "
        f"ParallelTypicality at N={N} (cut from 100) over the {sum(map(len, seeds.values()))} ground-truth and "
        f"translated files in {sweep_s:.1f} s ({sweep_launches} K1 launches over {sweep_passes} UNet passes); "
        f"df_PD gave {len(df)} rows ({k_per_image} from every source group) and {len(df_random)} random ones; "
        f"clustering(dift-161) into {len(clusters)} clusters ranked by median D; embeddings {emb.shape}, finite, "
        f"country-major; df_PD + clustering wall {mine_s:.1f} s ({mine_launches} K1 launches over {dift_passes} "
        f"DIFT passes) on {smi}")
    shutil.rmtree(work, ignore_errors=True)
    return dict(countries=len(countries), files=len(files), N=N, sweep_s=sweep_s, sweep_passes=sweep_passes,
                sweep_launches=sweep_launches, rows=len(df), clusters=len(clusters), wall_s=mine_s,
                dift_passes=dift_passes, dift_launches=mine_launches, launches=sweep_launches + mine_launches,
                embedding_dim=int(emb.shape[0]), card=smi)


def phase_f32_kernels():
    """flash_fwd_f32's two modes against their plain versions in float32
    (TF32 off) at the CLIP towers' shapes: online (K3) at ViT-L/14's crop
    448 batch (B8 H16 L1025 D64), no-max (K1/K2) at crop 896 (B2 H16 L4097
    D64), both on a masked key tail (L1000: 15 full 64-key tiles and 40
    keys); with CUDA-event and device times, the plain version's, sdpa's
    float32 forward (a yardstick only) and the bound. These launches are
    not the main path's."""
    import torch
    import torch.nn.functional as F

    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.utils.device import exact_float32

    exact_float32()  # the plain versions and sdpa's float32 forward in full float32, whatever ran before
    assert_no_tf32()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 23)
    modes = {"online": (fa.flash_fwd_online_f32, fa.flash_fwd_online_plain),
             "nomax": (fa.flash_fwd_nomax_f32, fa.flash_attention_nomax_plain)}
    cases = [("online", "L1025 D64", (8, 16, 1025, 64)), ("online", "masked tail L1000 D64", (2, 16, 1000, 64)),
             ("nomax", "L4097 D64", (2, 16, 4097, 64)), ("nomax", "masked tail L1000 D64", (2, 16, 1000, 64))]
    results, failed = {"online": {}, "nomax": {}}, []
    for mode, name, (b, h, l, d) in cases:
        kernel, plain = modes[mode]
        # [B, L, H*D] float32 projections viewed as [B, H, L, D], as the tower hands them over
        q, k, v = [torch.randn(b, l, h * d, generator=g, device=dev).view(b, l, h, d).transpose(1, 2)
                   for _ in range(3)]
        got = kernel(q, k, v)
        torch.cuda.synchronize()
        want = plain_chunked(plain, q, k, v)
        max_err, worst = f32_error(got, want)
        if worst > 1.0 or not torch.isfinite(got).all():
            failed.append(f"flash_fwd_f32 {mode} {name}: {worst:.3g} x the tolerance (max abs err {max_err})")
        lib_err = float((F.scaled_dot_product_attention(q, k, v) - want).abs().max())
        del got, want
        ms = cuda_time_ms(lambda: kernel(q, k, v))
        plain_ms = cuda_time_ms(lambda: plain_chunked(plain, q, k, v), reps=3, warmup=1)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        _, device_ms = device_split(lambda: kernel(q, k, v), "flash_fwd_f32_kernel")
        lib_device, _ = device_split(lambda: F.scaled_dot_product_attention(q, k, v), "")
        bound, by = f32_attention_bound(b, h, l, l, d)
        results[mode][name] = dict(shape=[b, h, l, d], max_abs_err=max_err, err_over_tol=worst, ms=ms,
                                   device_ms=device_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                   library_device_ms=lib_device, library="sdpa forward, float32, TF32 off",
                                   library_max_abs_err=lib_err, bound_ms=bound, bound_by=by)
        log(f"kernel flash_fwd_f32 {mode} {name} B{b} H{h}: max|err| {max_err:.3g} = {worst:.3g} x tolerance "
            f"(rtol 2^-14, atol 2^-14 rms)  ms {ms:.4f}  device {fmt(device_ms)}  plain {plain_ms:.3f}  "
            f"sdpa float32 {lib_ms:.4f} (device {fmt(lib_device)}; max|err| {lib_err:.3g})  bound {bound:.4f} ({by})")
        del q, k, v
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    return results


def phase_f32_unet_kernels(smi):
    """The float32 kernels at the UNet's shapes (SD-v1.5's head dims 40, 80
    and 160), each against its plain version in float32 with TF32 off:
    flash_fwd_f32's no-max (K1/K2) and online (K3) modes at the 512px
    sweep's B4 H8 L4096 D40 and L1024 D80, 1024px's L1024 D160 and L16384
    D40 (B1) and masked key tails (L1000 D40, L1100 D160); its lse mode (K4),
    flash_bwd_dq_f32 (K5, and delta, held to attention_delta) and
    flash_bwd_dkv_f32 (K6) at the trainer's shapes and a masked tail at
    D160 and Lq != Lk; gn_act_proj_f32 (K7) at the four SpatialTransformer
    entries of a 512px pass at batch 8 in both layouts, its statistics held
    to group_stats_plain. The forward modes, K5, K6 and K7 are run twice and
    must repeat bit for bit (no atomics; K7's split sums add in a fixed
    order).
    With CUDA-event and device times, the plain version's, the library's
    (sdpa's float32 forward or backward; F.group_norm + 1x1 F.conv2d) and
    the bound. These launches are not the main path's."""
    import torch
    import torch.nn.functional as F

    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops import fused_norm as fn
    from diffmining_tpu_torch.utils.device import exact_float32

    exact_float32()  # the plain versions and the library's float32 calls in full float32, whatever ran before
    assert_no_tf32()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 25)

    def views(b, h, l, d, n):  # float32 [B, L, H*D] projections viewed as [B, H, L, D]
        return [torch.randn(b, l, h * d, generator=g, device=dev).view(b, l, h, d).transpose(1, 2) for _ in range(n)]

    results = {k: {} for k in ("nomax", "online", "lse", "K5", "K6", "K7")}
    failed = []

    def record(kind, name, shape, errs, ms, device_ms, plain_ms, lib_ms, lib_device, library, bound, by, **extra):
        max_err, worst = max(e for e, _ in errs), max(w for _, w in errs)
        if worst > 1.0:
            failed.append(f"{kind} float32 {name}: {worst:.3g} x the tolerance (max abs err {max_err})")
        results[kind][name] = dict(shape=shape, max_abs_err=max_err, err_over_tol=worst, ms=ms, device_ms=device_ms,
                                   plain_ms=plain_ms, library_ms=lib_ms, library_device_ms=lib_device,
                                   library=library, bound_ms=bound, bound_by=by, **extra)
        log(f"kernel {kind} float32 {name}: max|err| {max_err:.3g} = {worst:.3g} x tolerance (rtol 2^-14, atol 2^-14 "
            f"rms)  ms {ms:.4f}  device {fmt(device_ms)}  plain {plain_ms:.3f}  {library} {fmt(lib_ms)} (device "
            f"{fmt(lib_device)})  bound {bound:.4f} ({by})" + "".join(f"  {k} {fmt(v, '.3g')}" for k, v in extra.items()))

    fwd_cases = [("L4096 D40", (4, 8, 4096, 40)), ("L1024 D80", (4, 8, 1024, 80)), ("L1024 D160", (4, 8, 1024, 160)),
                 ("L16384 D40", (1, 8, 16384, 40)), ("masked tail L1000 D40", (2, 8, 1000, 40)),
                 ("masked tail L1100 D160", (2, 8, 1100, 160))]
    modes = {"nomax": (fa.flash_fwd_nomax_f32, fa.flash_attention_nomax_plain),
             "online": (fa.flash_fwd_online_f32, fa.flash_fwd_online_plain)}
    for name, (b, h, l, d) in fwd_cases:
        q, k, v = views(b, h, l, d, 3)
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        lib_ms = cuda_time_ms(sdpa)
        lib_device, _ = device_split(sdpa, "")
        bound, by = f32_attention_bound(b, h, l, l, d)
        for mode, (kernel, plain) in modes.items():
            got = kernel(q, k, v)
            torch.cuda.synchronize()
            if not torch.equal(got, kernel(q, k, v)):  # no atomics: a call repeats bit for bit
                failed.append(f"{mode} float32 {name}: a repeated call differs")
            want = plain_chunked(plain, q, k, v)
            err = f32_error(got, want) if bool(torch.isfinite(got).all()) else (math.inf, math.inf)
            del got, want
            ms = cuda_time_ms(lambda: kernel(q, k, v))
            plain_ms = cuda_time_ms(lambda: plain_chunked(plain, q, k, v), reps=3, warmup=1)
            _, device_ms = device_split(lambda: kernel(q, k, v), "flash_fwd_f32_kernel")
            record(mode, name, [b, h, l, d], [err], ms, device_ms, plain_ms, lib_ms, lib_device,
                   "sdpa forward, float32, TF32 off", bound, by)
        del q, k, v
        torch.cuda.empty_cache()

    train_cases = [("L4096 D40", (4, 8, 4096, 4096, 40)), ("L1024 D80", (4, 8, 1024, 1024, 80)),
                   ("masked tail L1100 D160", (2, 8, 1100, 1100, 160)), ("Lq1100 Lk300 D80", (2, 8, 1100, 300, 80))]
    for name, (b, h, lq, lk, d) in train_cases:
        q, do = views(b, h, lq, d, 2)
        k, v = views(b, h, lk, d, 2)
        o, lse = fa.flash_fwd_lse_f32(q, k, v)
        qs = fa.prescaled_q(q)
        dq, delta_k = fa.flash_bwd_dq_f32(q, k, v, do, o, lse, qs)
        delta = fa.attention_delta(do, o)
        dk, dv = fa.flash_bwd_dkv_f32(q, k, v, do, lse, delta, qs)
        torch.cuda.synchronize()
        # no atomics: a second call gives the same dq, delta, dk and dv bit for bit
        again = (*fa.flash_bwd_dq_f32(q, k, v, do, o, lse, qs), *fa.flash_bwd_dkv_f32(q, k, v, do, lse, delta, qs))
        for label, a, b_ in zip(("dq", "delta", "dk", "dv"), (dq, delta_k, dk, dv), again):
            if not torch.equal(a, b_):
                failed.append(f"{'K5' if label in ('dq', 'delta') else 'K6'} float32 {name}: a repeated call's {label} differs")
        del again
        delta_err = float(((delta_k - delta).abs() / (do * o).abs().sum(-1)).max())
        if not delta_err <= DELTA_RTOL:
            failed.append(f"K5 float32 {name}: delta differs from attention_delta by {delta_err:.3g} of sum|dO o|")
        o_p, lse_p = plain_chunked(fa.flash_fwd_lse_plain, q, k, v)
        lse_err = float(((lse - lse_p).abs() / lse_p.abs().clamp_min(1.0)).max())
        if not lse_err <= F32_LSE_RTOL:
            failed.append(f"K4 float32 {name}: lse off the plain version's by {lse_err:.3g} of max(1, |lse|)")
        dq_p = plain_chunked(fa.flash_bwd_dq_plain, q, k, v, do, lse, delta)
        dk_p, dv_p = plain_chunked(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta)
        errs = {"lse": [f32_error(o, o_p)], "K5": [f32_error(dq, dq_p)], "K6": [f32_error(dk, dk_p), f32_error(dv, dv_p)]}
        del o_p, lse_p, dq_p, dk_p, dv_p
        qr, kr, vr = (t.detach().requires_grad_(True) for t in (q, k, v))
        ref = F.scaled_dot_product_attention(qr, kr, vr)
        lib_bwd = lambda: torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True)  # noqa: E731
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        lib = {"fwd": (cuda_time_ms(sdpa), device_split(sdpa, "")[0]),
               "bwd": (cuda_time_ms(lib_bwd), device_split(lib_bwd, "")[0])}
        calls = {
            "lse": (lambda: fa.flash_fwd_lse_f32(q, k, v), lambda: plain_chunked(fa.flash_fwd_lse_plain, q, k, v),
                    "flash_fwd_f32_kernel", "K4", "fwd"),
            "K5": (lambda: fa.flash_bwd_dq_f32(q, k, v, do, o, lse, qs),
                   lambda: plain_chunked(fa.flash_bwd_dq_plain, q, k, v, do, lse, delta), "flash_bwd_dq_f32_kernel",
                   "K5", "bwd"),
            "K6": (lambda: fa.flash_bwd_dkv_f32(q, k, v, do, lse, delta, qs),
                   lambda: plain_chunked(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta),
                   "flash_bwd_dkv_f32_kernel", "K6", "bwd"),
        }
        for kind, (call, plain, kname, bkind, libkind) in calls.items():
            ms = cuda_time_ms(call)
            plain_ms = cuda_time_ms(plain, reps=3, warmup=1)
            _, device_ms = device_split(call, kname)
            bound, by = f32_training_bound(bkind, b, h, lq, lk, d)
            extra = {"lse": dict(lse_rel_err=lse_err), "K5": dict(delta_err_over_abs_sum=delta_err), "K6": {}}[kind]
            record(kind, name, [b, h, lq, lk, d], errs[kind], ms, device_ms, plain_ms, *lib[libkind],
                   "sdpa forward, float32, TF32 off" if libkind == "fwd"
                   else "sdpa backward (dq, dk, dv together), float32, TF32 off", bound, by, **extra)
        del q, k, v, do, o, lse, qs, dq, delta_k, delta, dk, dv, qr, kr, vr, ref
        torch.cuda.empty_cache()

    gn_cases = [("N4096 C320", (8, 64, 64, 320)), ("N1024 C640", (8, 32, 32, 640)), ("N256 C1280", (8, 16, 16, 1280)),
                ("N64 C1280", (8, 8, 8, 1280))]
    for layout in ("nchw", "channels_last"):
        for base, (b, hh, ww, c) in gn_cases:
            name = base if layout == "nchw" else f"channels-last {base}"
            x = torch.randn(b, c, hh, ww, generator=g, device=dev) * 2 + 0.5
            if layout == "channels_last":  # as the UNet hands it after a transformer's proj_out
                x = x.contiguous(memory_format=torch.channels_last)
            gamma, beta, bias = (torch.randn(c, generator=g, device=dev) * s_ + o_
                                 for s_, o_ in ((0.3, 1.0), (0.3, 0.0), (0.5, 0.0)))
            weight = torch.randn(c, c, 1, 1, generator=g, device=dev) / math.sqrt(c)
            xv, w = x.permute(0, 2, 3, 1), weight[:, :, 0, 0].t()
            stats = torch.empty(b, 2, c, device=dev)
            got = fn.gn_act_proj_f32(xv, gamma, beta, w, bias, 32, stats=stats)
            torch.cuda.synchronize()
            if not torch.equal(got, fn.gn_act_proj_f32(xv, gamma, beta, w, bias, 32)):  # a split sum adds in order
                failed.append(f"K7 float32 {name}: a repeated call differs")
            mean, rsig = fn.group_stats_plain(xv, 32, 1e-6)
            mean_err = float((stats[:, 0] - mean).abs().max() / xv.abs().max())
            rsig_err = float((stats[:, 1] / rsig - 1).abs().max())
            if not mean_err <= GN_MEAN_TOL or not rsig_err <= GN_RSIG_RTOL:
                failed.append(f"K7 float32 {name}: statistics off the plain version's ({mean_err:.3g}, {rsig_err:.3g})")
            want = fn.gn_act_proj_plain(xv, gamma, beta, w, bias, 32)
            err = f32_error(got, want) if bool(torch.isfinite(got).all()) else (math.inf, math.inf)
            del got, want
            call = lambda: fn.gn_act_proj_f32(xv, gamma, beta, w, bias, 32)  # noqa: E731
            lib = lambda: F.conv2d(F.group_norm(x, 32, gamma, beta, 1e-6), weight, bias)  # noqa: E731
            ms = cuda_time_ms(call)
            plain_ms = cuda_time_ms(lambda: fn.gn_act_proj_plain(xv, gamma, beta, w, bias, 32), reps=3, warmup=1)
            busy_ms, proj_ms, stats_ms = device_split(call, "gn_proj_f32_kernel", other="gn_stats_f32_kernel")
            bound, by = gn_proj_f32_bound(b, hh * ww, c, c)
            record("K7", name, [b, hh * ww, c, c], [err], ms, busy_ms, plain_ms, cuda_time_ms(lib),
                   device_split(lib, "")[0], "F.group_norm + 1x1 F.conv2d (two calls), float32, TF32 off", bound,
                   by, stats_mean_err=mean_err, stats_rsig_err=rsig_err, stats_device_ms=stats_ms,
                   proj_device_ms=proj_ms)
            del x, xv
            torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    log(f"float32 UNet kernels: every shape within its bound of its plain version on {smi}")
    return results


def phase_f32_sweep(smi):
    """The typicality sweep with --dtype fp32 (an SD-v1.5-width bundle in
    float32, random weights from SEED) over 2 labels x 4 synthetic 512x512
    images at N=4, batch_images 4: 10 launches of the float32 no-max mode a
    UNet pass (5 at L4096 D40, 5 at L1024 D80) and none of a bf16 kernel;
    artifacts checked; one UNet pass against the same pass through the plain
    attention (relative L2), its event time and device busy share; then one
    pass of the same bundle under DIFFMINING_FUSED_NORM=1 (16 launches of
    the float32 K7) against the module path, with its event time, device
    busy time and the float32 K7's part of it."""
    import dataclasses

    import numpy as np
    import torch

    from diffmining_tpu_torch.models import unet as unet_mod
    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops import fused_norm as fn
    from diffmining_tpu_torch.ops.attention import kernel_route, sdpa, sdpa_plain
    from diffmining_tpu_torch.typicality.compute import SD, Typicality
    from diffmining_tpu_torch.utils.device import exact_float32
    from diffmining_tpu_torch.utils.images import array_from_uint8

    labels, per_label, px, N, batch_images = ["1920", "1960"], 4, 512, 4, 4
    work = os.path.join(ROOT, "build", "chip_smoke_f32")
    shutil.rmtree(work, ignore_errors=True)
    data, out, subs = (os.path.join(work, n) for n in ("ftt", "typicality", "subs"))
    rng = np.random.RandomState(SEED + 26)
    arrays = {}
    for c in labels:
        os.makedirs(os.path.join(data, c))
        for i in range(per_label):
            path = os.path.join(data, c, f"img{i}.jpg")
            open(path, "wb").close()  # a name for the work queue; never decoded
            arrays[path] = array_from_uint8(rng.randint(0, 256, (px, px, 3), dtype=np.uint8))
    t0 = time.perf_counter()
    pytorch_default_tf32()
    sd = SD.init_random("ftt", labels, SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED, dtype=torch.float32,
                        device="cuda")
    assert_no_tf32()  # the float32 bundle's own set-up turned both off
    torch.cuda.synchronize()
    log(f"f32 sweep: SD-v1.5 widths, random weights (seed {SEED}), float32 (--dtype fp32), built in "
        f"{time.perf_counter() - t0:.1f} s; from PyTorch's TF32 defaults, the bundle turned both flags off")
    typ = Typicality("ftt", None, data, out, t_min=0.1, t_max=0.9, sd=sd, N=N, batch_images=batch_images, chunk=1,
                     dtype=torch.float32, device="cuda")
    typ.make_submission(data, subs, sub_split=1)
    kernels = (fa.flash_fwd_nomax_f32, fa.flash_fwd_online_f32, fa.flash_fwd_lse_f32, fa.flash_fwd_nomax,
               fa.flash_fwd_online, fa.flash_fwd_lse)
    for f in kernels:
        f.launches = 0
    t0 = time.perf_counter()
    typ.compute_submission(os.path.join(subs, "0.txt"), load=arrays.__getitem__)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in kernels}
    n_passes = len(labels) * math.ceil(per_label / batch_images) * N
    want = dict.fromkeys(launches, 0)
    for l, d in UNET_512_GATED:  # the wrapper each gated call's route names
        for name in kernel_route(torch.float32, d, l, l, False).wrappers:
            want[name] += n_passes
    if launches != want:
        raise AssertionError(f"f32 sweep: launches {launches}, expected {want} (10 a UNet pass x {n_passes})")
    for c in labels:
        for i in range(per_label):
            a = np.load(os.path.join(out, c, f"img{i}.npy"))
            if a.shape != (N, 2, 4, px // 8, px // 8) or a.dtype != np.float16 or not np.isfinite(a).all():
                raise AssertionError(f"f32 sweep artifact {c}/img{i}.npy: {a.shape} {a.dtype}")
    imgs_hr = len(arrays) / dt * 3600.0
    log(f"f32 sweep: {len(arrays)} artifacts [{N}, 2, 4, {px // 8}, {px // 8}] fp16, all finite; launches {launches} "
        f"(10 a UNet pass x {n_passes} passes); {imgs_hr:.1f} imgs/hr at N={N} ({dt:.2f} s, first run) on {smi}")
    # the same sweep with cuDNN's TF32 on (PyTorch's default, where the
    # float32 CLIs left it before the port turned it off): how far it moves
    # the artifacts
    tree_on = os.path.join(work, "tf32_on")
    torch.backends.cudnn.allow_tf32 = True
    try:
        Typicality("ftt", None, data, tree_on, t_min=0.1, t_max=0.9, sd=sd, N=N, batch_images=batch_images, chunk=1,
                   dtype=torch.float32, device="cuda").compute_submission(os.path.join(subs, "0.txt"),
                                                                          load=arrays.__getitem__)
        torch.cuda.synchronize()
    finally:
        exact_float32()
    pairs = [(np.load(os.path.join(tree_on, c, f"img{i}.npy")), np.load(os.path.join(out, c, f"img{i}.npy")))
             for c in labels for i in range(per_label)]
    tf32 = dict(max_abs=max(float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max()) for a, b in pairs),
                max_ulps=max(fp16_ulps(a, b) for a, b in pairs), bit_equal=sum(bool(np.array_equal(a, b)) for a, b in pairs))
    log(f"f32 sweep: cuDNN TF32 on moved the artifacts by up to {tf32['max_abs']:.4g} ({tf32['max_ulps']:.1f} fp16 "
        f"ulps), {tf32['bit_equal']}/{len(arrays)} bit-equal")

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 27)
    x = torch.randn(batch_images, 4, px // 8, px // 8, generator=g, device="cuda")
    t = torch.randint(100, 900, (batch_images,), generator=g, device="cuda")
    ctx = torch.stack([torch.stack([sd.country_embeds[labels[0]], sd.country_embeds[""]])] * batch_images)
    ctx = ctx.reshape(batch_images * 2, *ctx.shape[2:])
    unet_pass = lambda: sd.unet(x, t, ctx, ctx_tile=2)  # noqa: E731
    with torch.inference_mode():
        eps = unet_pass()
        pass_ms = cuda_time_ms(unet_pass, reps=5, warmup=1)
        _, k_ms = device_split(unet_pass, "flash_fwd_f32_kernel", launches=10)
        # the device's busy time as the union of the kernels' intervals: in
        # float32 the kernels' summed times came to 1.89x the event time of
        # a pass (kernels that overlap their neighbours), so the sum is no
        # busy time; both are printed, with the largest kernels
        kernel_sum_ms, busy_ms, top, _ = device_busy(unet_pass)
        # the pass with cuDNN's TF32 on (PyTorch's default, where the float32
        # CLIs left it) and off (the port's set-up now), in turns off, on, on,
        # off; after each switch one pass unmeasured (cuDNN picks its
        # algorithms anew), then the event time and the device busy time
        tf32_pass = {tag: {"ms": [], "busy_ms": []} for tag in ("off", "on")}
        for tag in ("off", "on", "on", "off"):
            torch.backends.cudnn.allow_tf32 = tag == "on"
            unet_pass()
            tf32_pass[tag]["ms"].append(cuda_time_ms(unet_pass, reps=5, warmup=1))
            tf32_pass[tag]["busy_ms"].append(device_busy(unet_pass)[1])
        exact_float32()
        unet_mod.sdpa = sdpa_plain  # the reference: the same float32 pass through the plain attention
        try:
            eps_plain = unet_pass()
        finally:
            unet_mod.sdpa = sdpa
        rel = rel_l2(eps, eps_plain)
        # DIFFMINING_FUSED_NORM=1 on the same modules: the bundle's own gate
        # turns the UNet's transformer entries to the fused kernel
        saved = os.environ.get("DIFFMINING_FUSED_NORM")
        os.environ["DIFFMINING_FUSED_NORM"] = "1"
        try:
            SD("ftt", sd.unet, sd.vae, sd.clip, sd.tokenizer, sd.schedule, labels, torch.float32, "cuda")
        finally:
            if saved is None:
                os.environ.pop("DIFFMINING_FUSED_NORM")
            else:
                os.environ["DIFFMINING_FUSED_NORM"] = saved
        try:
            before = (fn.gn_act_proj_f32.launches, fn.gn_act_proj.launches)
            eps_fused = unet_pass()
            k7 = (fn.gn_act_proj_f32.launches - before[0], fn.gn_act_proj.launches - before[1])
            fused_ms = cuda_time_ms(unet_pass, reps=5, warmup=1)
            _, fused_busy_ms, _, k7_parts = device_busy(unet_pass,
                                                        parts=("gn_proj_f32_kernel", "gn_stats_f32_kernel"))
            k7_pass_ms = sum(k7_parts.values()) if k7_parts else None
        finally:
            sd.unet.config = dataclasses.replace(sd.unet.config, fused_norm=False)
        rel_fused = rel_l2(eps_fused, eps)
    if not (torch.isfinite(eps).all() and rel < UNET_F32_REL_L2):
        raise AssertionError(f"f32 UNet pass: kernels vs plain attention relative L2 {rel}")
    if k7 != (16, 0) or not (torch.isfinite(eps_fused).all() and rel_fused < UNET_F32_REL_L2):
        raise AssertionError(f"f32 fused-norm pass: K7 launches (float32, bf16) {k7}, relative L2 {rel_fused}")
    busy_share = None if busy_ms is None else busy_ms / pass_ms
    log(f"f32 sweep: UNet pass (B={batch_images}x2, 512px, float32) kernels vs plain attention: relative L2 "
        f"{rel:.4g} (limit {UNET_F32_REL_L2}); {pass_ms:.2f} ms, device busy {fmt(busy_ms, '.2f')} ms "
        f"({fmt(busy_share, '.3f')} of the pass; kernel times summed {fmt(kernel_sum_ms, '.2f')} ms), of which the "
        "float32 no-max mode " + ("not measured" if k_ms is None else f"{10 * k_ms:.2f} ms (10 launches)")
        + f"; under DIFFMINING_FUSED_NORM=1: {k7[0]} launches of the float32 K7, relative L2 {rel_fused:.4g} from "
        f"the module path; that pass {fused_ms:.2f} ms, device busy {fmt(fused_busy_ms, '.2f')} ms, of which the "
        f"float32 K7 {fmt(k7_pass_ms, '.2f')} ms (statistics and projection, 16 launches), on {smi}")
    log(f"f32 sweep: the UNet pass (B={batch_images}x2, 512px) with cuDNN TF32 in turns off, on, on, off: on "
        + ", ".join(f"{ms:.2f} ms (busy {fmt(b, '.2f')})" for ms, b in zip(*tf32_pass["on"].values())) + "; off "
        + ", ".join(f"{ms:.2f} ms (busy {fmt(b, '.2f')})" for ms, b in zip(*tf32_pass["off"].values()))
        + f", on {smi}")
    log("f32 sweep: the pass's largest kernels (ms a pass, summed): "
        + "; ".join(f"{ms:.2f} {name[:70]}" for name, ms in top))
    del sd, typ, eps, eps_plain, eps_fused
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(images=len(arrays), N=N, batch_images=batch_images, imgs_per_hr_n4=imgs_hr, launches=launches,
                unet_pass_tf32=tf32_pass, tf32_artifacts=tf32,
                unet_pass_ms=pass_ms, unet_pass_busy_ms=busy_ms, busy_share=busy_share,
                unet_pass_kernel_sum_ms=kernel_sum_ms, top_kernels=top,
                unet_pass_nomax_f32_ms=None if k_ms is None else 10 * k_ms, rel_l2_vs_plain=rel,
                fused_norm_launches=k7[0], fused_norm_rel_l2=rel_fused, fused_norm_pass_ms=fused_ms,
                fused_norm_pass_busy_ms=fused_busy_ms, fused_norm_k7_ms=k7_pass_ms, card=smi)


def fp16_ulps(got, want) -> float:
    """Largest |got - want| of two fp16 arrays in fp16 ulps of the larger
    magnitude of each pair."""
    import numpy as np

    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want))).astype(np.float32)
    return float((np.abs(got.astype(np.float32) - want.astype(np.float32)) / ulp).max())


def phase_train_f32(smi):
    """finetune --mixed_precision no: the places trainer at SD-v1.5 widths
    (random weights from SEED, as phase 6's: no pipeline export), float32
    throughout, EMA, batch 2 of synthetic 512x512 images: one forward and
    backward at the seed's weights with the float32 kernels against the same
    through the plain attention (level-0 to_q/to_k/to_v gradients); 3 steps
    through train_step, each launching the float32 lse mode, K5 and K6 10
    times and no bf16 kernel; warm step ms and peak memory; then a warm
    step's device busy time from a trace of two more steps and the part of
    it in the lse mode, K5 and K6 (their launches are not counted)."""
    import torch

    from diffmining_tpu_torch.models import unet as unet_mod
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops.attention import kernel_route, sdpa, sdpa_plain
    from diffmining_tpu_torch.utils.device import exact_float32

    batch, px, n_images, n_steps = 2, 512, 4, 3
    work = os.path.join(ROOT, "build", "chip_smoke_train_f32")
    t0 = time.perf_counter()
    pytorch_default_tf32()
    tr, args, batches = places_trainer(work, batch, px, n_images, max_train_steps=n_steps,
                                       extra=("--mixed_precision", "no"))
    assert_no_tf32()  # the trainer's --mixed_precision no set-up turned both off
    torch.cuda.synchronize()
    if tr.builder.mixed_precision:
        raise AssertionError("train f32: --mixed_precision no left autocast on")
    log(f"train f32: places trainer at SD-v1.5 widths, --mixed_precision no (float32 throughout), EMA, batch "
        f"{batch}; built and training_init in {time.perf_counter() - t0:.1f} s")
    proj = [f"down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_{n}.weight" for n in "qkv"]
    before = {n: tr.state.params[n].detach().clone() for n in proj}
    b = tr.builder
    images, tokens = batches[0][0][:1], batches[0][1][:1]
    draws = b.draw(SEED + 3, 0, (1, 4, px // 8, px // 8), torch.device("cuda"))

    def proj_grads():
        b.loss(images, tokens, draws=draws).backward()
        grads = {n: tr.state.params[n].grad.clone() for n in proj}
        for p in tr.state.params.values():
            p.grad = None
        return grads

    g_kernel = proj_grads()
    unet_mod.sdpa = sdpa_plain  # the reference: the same float32 pass through the plain attention
    try:
        g_plain = proj_grads()
    finally:
        unet_mod.sdpa = sdpa
    rel = {n.split(".")[-2]: rel_l2(g_kernel[n], g_plain[n]) for n in proj}
    if not all(float(g_kernel[n].abs().max()) > 0 for n in proj) or max(rel.values()) >= F32_GRAD_REL_L2:
        raise AssertionError(f"train f32: level-0 projection gradients, float32 kernels vs plain: {rel}")
    log(f"train f32: level-0 to_q/to_k/to_v gradients, float32 kernels vs the plain attention (batch 1): relative L2 "
        f"{', '.join(f'{k} {v:.4g}' for k, v in rel.items())} (limit {F32_GRAD_REL_L2}); all nonzero")

    kernels = (fa.flash_fwd_lse_f32, fa.flash_bwd_dq_f32, fa.flash_bwd_dkv_f32, fa.flash_fwd_lse, fa.flash_bwd_dq,
               fa.flash_bwd_dkv, fa.flash_fwd_nomax_f32)
    for f in kernels:
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_s, losses = [], []
    for i in range(n_steps):
        t0 = time.perf_counter()
        tr.state, loss = tr.train_step(tr.state, *batches[i % len(batches)], args.seed)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {f.__name__: f.launches for f in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = dict.fromkeys(launches, 0)
    for l, d in UNET_512_GATED:  # under grad: the lse mode, K5 and K6, once each a gated call a step
        for name in kernel_route(torch.float32, d, l, l, True).wrappers:
            want[name] += n_steps
    if launches != want:
        raise AssertionError(f"train f32: launches {launches}, expected {want} (10 gated attentions a step)")
    moved = min(float((tr.state.params[n].detach() - before[n]).abs().max()) for n in proj)
    if not all(math.isfinite(x) for x in losses) or not moved > 0:
        raise AssertionError(f"train f32: losses {losses}, level-0 projections moved by {moved}")
    warm_ms = statistics.median(step_s[1:]) * 1e3
    log(f"train f32: {n_steps} steps, losses {', '.join(f'{x:.4f}' for x in losses)}; launches {launches}; step times "
        f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms, warm median {warm_ms:.1f} ms = "
        f"{batch / warm_ms * 1e3:.2f} images/s; peak allocated {peak_gib:.2f} GiB on {smi}")

    # a warm step's device busy time and the float32 attention kernels' part of it
    def step():
        tr.state, _ = tr.train_step(tr.state, *batches[0], args.seed)

    # before and after the repair, in turns off, on, on, off: cuDNN's TF32
    # on (PyTorch's default, where --mixed_precision no left it) and off
    # (the trainer's set-up now); after each switch one step unmeasured
    # (cuDNN picks its algorithms anew), then five timed steps
    tf32_ms = {"off": [], "on": []}
    for tag in ("off", "on", "on", "off"):
        torch.backends.cudnn.allow_tf32 = tag == "on"
        step()
        torch.cuda.synchronize()
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            tf32_ms[tag].append((time.perf_counter() - t0) * 1e3)
    exact_float32()
    log(f"train f32, cuDNN TF32 in turns off, on, on, off (one step unmeasured after each switch, five timed): on "
        f"{', '.join(f'{x:.1f}' for x in tf32_ms['on'])} ms, median {statistics.median(tf32_ms['on']):.1f}; off "
        f"{', '.join(f'{x:.1f}' for x in tf32_ms['off'])} ms, median {statistics.median(tf32_ms['off']):.1f}, on {smi}")

    parts = {"lse mode": "flash_fwd_f32_kernel", "K5": "flash_bwd_dq_f32_kernel", "K6": "flash_bwd_dkv_f32_kernel"}
    kernel_sum_ms, busy_ms, _, part_ms = device_busy(step, calls=2, parts=tuple(parts.values()))
    split = {kind: part_ms.get(name) for kind, name in parts.items()}
    log(f"train f32: a warm step's device busy time {fmt(busy_ms, '.2f')} ms (kernel times summed "
        f"{fmt(kernel_sum_ms, '.2f')}), of which " + ", ".join(f"{kind} {fmt(ms, '.2f')}" for kind, ms in split.items())
        + f" ms (10 launches each) on {smi}")
    del tr, batches
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(steps=n_steps, batch=batch, px=px, losses=losses, step_ms=[x * 1e3 for x in step_s],
                warm_step_ms=warm_ms, images_per_s=batch / warm_ms * 1e3, peak_gib=peak_gib, launches=launches,
                step_ms_tf32_off=tf32_ms["off"], step_ms_tf32_on=tf32_ms["on"], grad_rel_l2=rel, step_busy_ms=busy_ms,
                step_kernel_sum_ms=kernel_sum_ms, step_attention_ms=split,
                card=smi)


def phase_clip(smi, mining_work, dift_sd):
    """CLIPRankCluster at ViT-L/14-336 widths on synthetic geo images, both
    scoring paths; then cluster's clip+dift-161 mode over phase 8's top
    patches with a ViT-B/32-width tower."""
    import numpy as np
    import torch
    from PIL import Image

    from diffmining_tpu_torch.baselines.clipmining import CLIPRankCluster, random_towers, random_vision_tower
    from diffmining_tpu_torch.models.clip import CLIP_VIT_B32_VISION
    from diffmining_tpu_torch.ops import flash_attention as fa
    from diffmining_tpu_torch.ops import fused_norm as fn
    from diffmining_tpu_torch.typicality.cluster import Cluster

    countries, per_country, px, batch_images = ["France", "Japan"], 16, 512, 8
    work = os.path.join(ROOT, "build", "chip_smoke_clip")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "geo")
    rng = np.random.RandomState(SEED + 21)
    for c in countries:
        os.makedirs(os.path.join(data, c))
        for i in range(per_country):
            Image.fromarray(rng.randint(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(data, c, f"gt--{c}__{i:03d}.png"), compress_level=1)
    kernels = (fa.flash_fwd_nomax, fa.flash_fwd_online, fa.flash_fwd_lse, fa.flash_bwd_dq, fa.flash_bwd_dkv,
               fn.gn_act_proj)
    t0 = time.perf_counter()
    vision, text = random_towers(None, None, SEED)
    log(f"clip: ViT-L/14-336 vision and ViT-L/14 text towers with projections, random weights (seed {SEED}), "
        f"built in {time.perf_counter() - t0:.1f} s")

    def ranker(cache, **kw):
        return CLIPRankCluster(data, os.path.join(work, cache), "diff", vision=vision, text=text,
                               batch_images=batch_images, device="cuda", **kw)

    for f in kernels:
        f.launches = 0
    pytorch_default_tf32()
    dev = ranker("cache_device")
    assert_no_tf32()  # the float32 ranker's own set-up (its device, resolve_device) turned both off
    log("clip: from PyTorch's TF32 defaults, the ranker's set-up turned both flags off")
    imgs = [dev.load_image(p) for p in dev.get_seeds(countries[0])[:batch_images]]
    dev._project_device(imgs)  # warm
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        dev._project_device(imgs)
    torch.cuda.synchronize()
    tower_ips = reps * len(imgs) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ranked = dev.clustering()  # the command's constants: k 5 a image, 1000, 32 clusters, 64 px boxes
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    for c in countries:
        scores = [s for _, s in ranked[c]]
        if scores != sorted(scores, reverse=True) or sum(len(m) for m, _ in ranked[c]) != 5 * per_country:
            raise AssertionError(f"clip: clipmining {c}: {sum(len(m) for m, _ in ranked[c])} members, scores {scores}")
    host = ranker("cache_host", host_scoring=True)
    df_d, emb_d = dev.rank(countries[0])
    df_h, emb_h = host.rank(countries[0])
    d_err = float(np.max(np.abs(df_d["D"].to_numpy() - df_h["D"].to_numpy())))
    e_err = float(max(np.max(np.abs(a - b_)) for a, b_ in zip(emb_d, emb_h)))
    if not df_d.drop(columns=["D"]).equals(df_h.drop(columns=["D"])) or not np.allclose(
            df_d["D"], df_h["D"], rtol=1e-4, atol=1e-5) or not all(
            np.allclose(a, b_, rtol=1e-4, atol=1e-5) for a, b_ in zip(emb_d, emb_h)):
        raise AssertionError(f"clip: the device scoring path disagrees with the host path (D {d_err}, embeds {e_err})")
    log(f"clip: clipmining over {len(countries)} countries x {per_country} synthetic {px}px images (crop 336, "
        f"batch {batch_images}): the ViT-L/14-336 tower {tower_ips:.1f} images/s; clustering wall {wall_s:.1f} s; "
        f"device vs host scoring on {countries[0]}: the same {len(df_d)} boxes, max |dD| {d_err:.3g}, max |d embed| "
        f"{e_err:.3g} (bound rtol 1e-4, atol 1e-5) on {smi}")
    del dev, host
    torch.cuda.empty_cache()
    large = clip_large_crops(smi, ranker, vision, countries, per_country, batch_images, kernels)
    del vision, text
    torch.cuda.empty_cache()

    # cluster's clip+dift-161 mode over phase 8's top patches
    b32 = random_vision_tower(CLIP_VIT_B32_VISION, torch.Generator().manual_seed(SEED + 22))
    cache = os.path.join(work, "cache_mining")
    shutil.copytree(mining_work["tables"], os.path.join(cache, "clusters"))  # phase 8's patch tables
    cl = Cluster("ftt", mining_work["tree"], mining_work["data"], cache, dift_sd=dift_sd, device="cuda",
                 clip_bundle={"config": CLIP_VIT_B32_VISION, "state_dict": b32.state_dict()})
    cl.init_dift()
    t0 = time.perf_counter()
    mined = cl.clustering("clip+dift-161", k=1000, num_clusters=32)
    torch.cuda.synchronize()
    mix_s = time.perf_counter() - t0
    dift_passes = cl.dift.n_passes
    launches = {f.__name__: f.launches for f in kernels}
    want = dict.fromkeys(launches, 0)
    want["flash_fwd_nomax"] = 10 * dift_passes
    if launches != want:
        raise AssertionError(f"clip: launches {launches}, expected {want}: the towers must reach no kernel")
    embs = [np.load(os.path.join(cache, "embeddings", "clip+dift-161", n), allow_pickle=True)
            for n in os.listdir(os.path.join(cache, "embeddings", "clip+dift-161"))]
    if not embs or not all(np.isfinite(e).all() and abs(np.linalg.norm(e[:512]) - 1) < 1e-4 for e in embs):
        raise AssertionError("clip: a clip+dift-161 embedding is not finite or its CLIP part not unit length")
    n_patches = sum(len(m) for c in mined for m, _ in mined[c])
    for c in mined:
        scores = [s for _, s in mined[c]]
        if scores != sorted(scores, reverse=True):
            raise AssertionError(f"clip: clip+dift-161 clusters of {c} not ranked")
    log(f"clip: cluster clip+dift-161 (ViT-B/32 widths, random weights) over phase 8's {n_patches} top patches: "
        f"{sum(len(v) for v in mined.values())} clusters, embeddings {embs[0].shape} ([clip 512 | dift]), wall "
        f"{mix_s:.1f} s; {dift_passes} DIFT passes; launches {launches} (K1 for DIFT only)")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(countries=len(countries), images_per_country=per_country, px=px, crop=336,
                batch_images=batch_images, tower_images_per_s=tower_ips, clipmining_wall_s=wall_s, large_crops=large,
                device_vs_host=dict(boxes=len(df_d), max_abs_dD=d_err, max_abs_dembed=e_err, rtol=1e-4, atol=1e-5),
                clip_dift=dict(patches=n_patches, wall_s=mix_s, dift_passes=dift_passes,
                               embedding_dim=int(embs[0].shape[0])),
                launches=launches, card=smi)


def tower_rel_l2(vision, pixels):
    """The tower's projected tokens through the float32 flash forward
    against the same forward with every attention on the plain path
    (float32, TF32 off): relative L2 error."""
    import torch

    from diffmining_tpu_torch.ops import attention as pattn

    with torch.no_grad():
        got = vision(pixels)[1]
        gate = pattn.use_kernel
        pattn.use_kernel = lambda *a: False
        try:
            want = vision(pixels)[1]
        finally:
            pattn.use_kernel = gate
    return rel_l2(got, want)


def clip_large_crops(smi, ranker, vision, countries, per_country, batch_images, kernels):
    """The CLIP towers at crops of 448 and 896 px, where the vision tower's
    self-attention passes the flash gate in float32: clipmining end to end at
    crop 448 (each tower forward launches the online mode once a layer, 24
    times), the tower at crop 896 (the no-max mode, 24 a forward; the
    largest logit·log2e printed: exp2 overflows past 128 there, as in JAX),
    and each crop's tokens against the same forward through the plain
    attention."""
    import numpy as np
    import torch

    from diffmining_tpu_torch.baselines.clipmining import preprocess
    from diffmining_tpu_torch.ops import attention as pattn
    from diffmining_tpu_torch.ops import flash_attention as fa

    f32 = (fa.flash_fwd_online_f32, fa.flash_fwd_nomax_f32)
    layers = vision.config.num_layers
    forwards = [0]
    tower_forward = vision.forward

    def counted(pixels):
        forwards[0] += 1
        return tower_forward(pixels)

    vision.forward = counted
    out = {}
    try:
        # crop 448: the main path of the online mode, counts from 0
        for f in (*kernels, *f32):
            f.launches = 0
        forwards[0] = 0
        big = ranker("cache_448", crop=448)
        imgs = [big.load_image(p) for p in big.get_seeds(countries[0])[:batch_images]]
        big._project_device(imgs)  # warm
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            big._project_device(imgs)
        torch.cuda.synchronize()
        ips = reps * len(imgs) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        ranked = big.clustering()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {f.__name__: f.launches for f in (*kernels, *f32)}
        n_fw = forwards[0]
        want = dict.fromkeys(launches, 0)
        want["flash_fwd_online_f32"] = layers * n_fw
        if launches != want or n_fw == 0:
            raise AssertionError(f"clip 448: launches {launches} over {n_fw} tower forwards, expected {want}")
        for c in countries:
            scores = [sc for _, sc in ranked[c]]
            if scores != sorted(scores, reverse=True) or sum(len(m) for m, _ in ranked[c]) != 5 * per_country:
                raise AssertionError(f"clip 448: clipmining {c}: {sum(len(m) for m, _ in ranked[c])} members")
        pixels = torch.from_numpy(np.stack([preprocess(im) for im in imgs])).permute(0, 3, 1, 2).cuda()
        err448 = tower_rel_l2(vision, pixels)
        if not err448 <= CLIP_F32_REL_L2:
            raise AssertionError(f"clip 448: tokens through the kernel {err448:.3g} (rel L2) off the plain path")
        log(f"clip: clipmining at crop 448 (L 1025, ViT-L/14 widths, float32): {n_fw} tower forwards launched "
            f"flash_fwd_f32's online mode {launches['flash_fwd_online_f32']} times ({layers} a forward), no other "
            f"kernel; the tower {ips:.1f} images/s at batch {batch_images}; clustering wall {wall:.1f} s; tokens "
            f"against the plain attention: rel L2 {err448:.3g} (bound {CLIP_F32_REL_L2:g}) on {smi}")
        out["crop448"] = dict(tower_forwards=n_fw, launches=launches, launches_per_forward=layers,
                              tower_images_per_s=ips, clustering_wall_s=wall, tokens_rel_l2=err448)
        del big, ranked

        # crop 896: one tower forward at batch 2 through the no-max mode
        top = [0.0]
        nomax = pattn.FORWARD["K2"]

        def k2_with_max_logit(q, k, v, scale=None):
            scale = scale if scale is not None else q.shape[-1] ** -0.5
            for i in range(q.shape[0]):
                s = torch.matmul(q[i] * scale, k[i].transpose(-1, -2))
                top[0] = max(top[0], float(s.max()) * fa.LOG2E)
            return nomax(q, k, v, scale)

        imgs = [im.resize((896, 896)) for im in imgs[:2]]
        pixels = torch.from_numpy(np.stack([preprocess(im) for im in imgs])).permute(0, 3, 1, 2).cuda()
        with torch.no_grad():
            vision(pixels)  # warm
            for f in (*kernels, *f32):
                f.launches = 0
            forwards[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pooled, tokens = vision(pixels)
            torch.cuda.synchronize()
            fw_s = time.perf_counter() - t0
        launches896 = {f.__name__: f.launches for f in (*kernels, *f32)}
        want = dict.fromkeys(launches896, 0)
        want["flash_fwd_nomax_f32"] = layers
        if launches896 != want or not (torch.isfinite(pooled).all() and torch.isfinite(tokens).all()):
            raise AssertionError(f"clip 896: launches {launches896}, expected {want}; finite "
                                 f"{bool(torch.isfinite(tokens).all())}")
        pattn.FORWARD["K2"] = k2_with_max_logit
        try:
            with torch.no_grad():
                vision(pixels)
        finally:
            pattn.FORWARD["K2"] = nomax
        err896 = tower_rel_l2(vision, pixels)
        if not err896 <= CLIP_F32_REL_L2:
            raise AssertionError(f"clip 896: tokens through the kernel {err896:.3g} (rel L2) off the plain path")
        log(f"clip: the ViT-L/14 tower at crop 896 (L 4097), batch 2: one forward {fw_s * 1e3:.1f} ms, "
            f"flash_fwd_f32's no-max mode launched {launches896['flash_fwd_nomax_f32']} times; the largest "
            f"logit x log2e {top[0]:.3f} (exp2 overflows past 128); tokens against the plain attention: rel L2 "
            f"{err896:.3g} (bound {CLIP_F32_REL_L2:g})")
        out["crop896"] = dict(batch=2, forward_ms=fw_s * 1e3, launches=launches896, max_logit_log2e=top[0],
                              tokens_rel_l2=err896)
    finally:
        del vision.forward
    return out


def phase_doersch(smi):
    """The Doersch baseline at its production widths on synthetic geo
    images: HOG+LAB features, detector init (dense search), three folds of
    the batched SVM over the full 25,000-row negative pool, the final
    search and figure; per-stage times, the last fold's duality gaps and
    objectives, the duality gap at the production shape, and one dense
    search and one batched SVM held to the same call on the CPU."""
    import numpy as np
    import torch
    from PIL import Image

    from diffmining_tpu_torch.baselines import doersch as dm
    from diffmining_tpu_torch.ops import hog as hog_mod
    from diffmining_tpu_torch.ops import svm

    countries, per_country, px = ["France", "Japan"], 32, 512
    how_many, num_detectors, folds = 256, 64, 3  # how_many cut from 25,000 for the script's time
    work = os.path.join(ROOT, "build", "chip_smoke_doersch")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "geo")
    rng = np.random.RandomState(SEED + 31)
    for c in countries:
        os.makedirs(os.path.join(data, c))
        for i in range(per_country):
            # smooth blobs plus noise, so patches have contrast and HOG structure
            base = rng.randint(0, 256, (px // 32, px // 32, 3), dtype=np.uint8)
            img = np.asarray(Image.fromarray(base).resize((px, px), Image.BICUBIC), np.int16)
            img = np.clip(img + rng.randint(-24, 25, img.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(data, c, f"gt--{c}__{i:03d}.png"), compress_level=1)
    timing = {"svm_s": [], "search_s": []}
    last_fold = {}
    fit_batch, search = dm.fit_linear_svm_batch, dm.dense_search

    def timed_fit(P, Pm, HN, HNm, NEG, NEGm, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fit_batch(P, Pm, HN, HNm, NEG, NEGm, **kw)
        timing["svm_s"].append(time.perf_counter() - t0)
        last_fold.update(P=P, Pm=Pm, HN=HN, HNm=HNm, NEG=NEG, NEGm=NEGm, W=out[0], b=out[1])
        return out

    def timed_search(*a, **kw):
        t0 = time.perf_counter()
        out = search(*a, **kw)
        timing["search_s"].append(time.perf_counter() - t0)
        return out

    dm.fit_linear_svm_batch, dm.dense_search = timed_fit, timed_search
    try:
        t_all = time.perf_counter()
        d = dm.Doersch(os.path.join(work, "run"), "geo", data, how_many=how_many, device="cuda")
        c = countries[0]
        t0 = time.perf_counter()
        for p in d.positive_paths(c) + d.negative_paths(c):
            d.store.image_features(p)
        hog_s = time.perf_counter() - t0
        img0 = np.asarray(Image.open(d.positive_paths(c)[0]).convert("RGB"))
        hog_mod.hoglab_features(img0, device="cuda")  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            hog_mod.hoglab_features(img0, device="cuda")
        hog_call_ms = (time.perf_counter() - t0) / 5 * 1e3
        n_images = len(d.positive_paths(c)) + len(d.negative_paths(c))
        t0 = time.perf_counter()
        init = d.initialize_classifier(c, num_detectors=num_detectors)
        init_s = time.perf_counter() - t0
        init_search_s = sum(timing["search_s"])
        n_before = len(timing["search_s"])
        t0 = time.perf_counter()
        img = d.get_top(c, num_detectors=num_detectors, l=folds)
        iter_s = time.perf_counter() - t0
        total_s = time.perf_counter() - t_all
    finally:
        dm.fit_linear_svm_batch, dm.dense_search = fit_batch, search
    iter_search = timing["search_s"][n_before:]
    det_dir = os.path.join(work, "run", "geo", c, "detectors", "50")
    dets = [os.path.join(det_dir, f) for f in os.listdir(det_dir)]
    hog_ms = hog_s / n_images * 1e3
    log(f"doersch: geo, {len(countries)} categories x {per_country} synthetic {px}px images (cut from a dataset), "
        f"how_many {how_many} (cut from 25,000 for the script's time), {num_detectors} detectors (one chunk, J = {num_detectors}), "
        f"{folds} folds, the 25,000-row x 2112 negative pool and 400 Adam steps (production widths), {c}'s "
        f"detectors trained: features {hog_ms:.1f} ms/image (decode, HOG+LAB, the fp16 cache, normalise; "
        f"hoglab_features alone {hog_call_ms:.1f} ms, its result on the host); init {init_s:.1f} s (dense search "
        f"{init_search_s * 1e3:.0f} ms over {how_many} patches); the folds' and final dense searches "
        f"{', '.join(f'{t * 1e3:.0f}' for t in iter_search)} ms; SVM {', '.join(f'{t * 1e3:.0f}' for t in timing['svm_s'])} "
        f"ms a fold; iterative training and figure {iter_s:.1f} s; total {total_s:.1f} s on {smi}")
    if len(init) != num_detectors or len(dets) != num_detectors or len(timing["svm_s"]) != folds or img.width <= 0:
        raise AssertionError(f"doersch: {len(init)} init detectors, {len(dets)} trained, {len(timing['svm_s'])} "
                             f"SVM solves, figure {img.size}")
    import pickle

    accs = []
    for fp in dets:
        with open(fp, "rb") as f:
            acc, hits, _top, w = pickle.load(f)
        if not (np.isfinite(w).all() and all(np.isfinite(h[0]) for h in hits) and 0 <= acc <= len(hits)):
            raise AssertionError(f"doersch: detector {fp} has non-finite weights or scores")
        accs.append(acc)

    # The weak-duality certificate (ops/svm.py duality_gap) of the last
    # fold's solves, and each objective against the point w = 0, b = -1,
    # which meets every negative's margin. A fold has about 5 positives
    # against 25,000 negatives: where no negative violates its margin, the
    # certificate's dual point is zero (every violator is a positive, and
    # shaving Σ α·y to 0 removes them all), so it reads 1.0.
    lf = last_fold
    t0 = time.perf_counter()
    # each solve's rows are its positives, its hard negatives and a prefix of
    # the shared pool: one float64 buffer holds the pool once, and each
    # detector's positives and hard negatives are written just before it
    pos_hn = [(lf["P"][j][lf["Pm"][j] > 0], lf["HN"][j][lf["HNm"][j] > 0]) for j in range(num_detectors)]
    head = max(len(p_) + len(h_) for p_, h_ in pos_hn)
    buf = np.empty((head + len(lf["NEG"]), lf["NEG"].shape[1]))
    buf[head:] = lf["NEG"]
    gaps, over_trivial = [], []
    for j, (pos, hn) in enumerate(pos_hn):
        m = int(lf["NEGm"][j].sum())
        if not lf["NEGm"][j][:m].all():
            raise AssertionError(f"doersch: detector {j}'s pool rows are not a prefix of the pool")
        start = head - len(pos) - len(hn)
        buf[start:start + len(pos)] = pos
        buf[start + len(pos):head] = hn
        X = buf[start:head + m]
        y = np.concatenate([np.ones(len(pos)), -np.ones(len(X) - len(pos))])
        gap = svm.duality_gap(X, y, lf["W"][j], float(lf["b"][j]), 0.1)
        gaps.append(gap[1])
        over_trivial.append(gap[2] / svm.primal_objective(X, y, np.zeros(X.shape[1]), -1.0, 0.1))
    fold_gap_s = time.perf_counter() - t0

    def production_gap(rows):
        """The certificate at the production shape of tests/test_doersch.py
        (:193-222): 25,000 x 2112 rows, 1,250 positives moved along a planted
        direction drawn after the rows from RandomState(0), C = 0.1, 400
        steps; fitted on the card."""
        X = rows[:25000].astype(np.float64)
        u = prng.randn(X.shape[1])
        u /= np.linalg.norm(u)
        y = np.asarray([1.0] * 1250 + [-1.0] * (len(X) - 1250))
        X[:1250] += 0.5 * u
        X[:1250] /= np.linalg.norm(X[:1250], axis=1, keepdims=True)
        w, b = svm.fit_linear_svm(X, y, C=0.1, device="cuda")
        return svm.duality_gap(X, y, w, b, 0.1)

    # the test's own rows: the features of random 128 px 8-bit images drawn
    # from RandomState(0), as many as reach 25,000 positions (the gated bound)
    prng = np.random.RandomState(0)
    cells, n_rows = [], 0
    while n_rows < 25000:
        f = hog_mod.normalize_features(hog_mod.hoglab_features(prng.randint(0, 255, (128, 128, 3), dtype=np.uint8),
                                                               device="cuda"))
        cells.append(f.reshape(-1, f.shape[-1]))
        n_rows += len(cells[-1])
    _, test_gap, test_primal, test_dual = production_gap(np.concatenate(cells))
    # the same construction on this run's smooth synthetic images (printed)
    prng = np.random.RandomState(0)
    run_rows = np.concatenate([d.store.image_features(p).reshape(-1, 2112) for p in d.positive_paths(c)[:8]])
    _, run_gap, _, _ = production_gap(run_rows)
    log(f"doersch: the last fold's {num_detectors} solves: worst relative duality gap {max(gaps):.4g} (the "
        f"certificate's dual point is zero where only positives violate), objective {min(over_trivial):.4g}-"
        f"{max(over_trivial):.4g} x that of w = 0, b = -1 ({fold_gap_s:.1f} s on the host); at the production shape "
        f"of tests/test_doersch.py (25,000 x 2112, 1,250 planted positives) the relative duality gap {test_gap:.4g} "
        f"on its random 128 px images (bound {DOERSCH_GAP}; primal {test_primal:.5g}, dual {test_dual:.5g}) and "
        f"{run_gap:.4g} on this run's smooth images; accuracies {min(accs)}-{max(accs)}")

    # one dense search and one batched SVM on the card against the CPU
    shards = d.store.build_shards(d.positive_paths(c), f"{c}-pos", num_splits=1)
    ws = np.stack([w for _k, _p, w in init])
    got = dm.dense_search(ws, shards, top_k=5, fold=(1, folds), ret_ws=True, device="cuda")
    want = dm.dense_search(ws, shards, top_k=5, fold=(1, folds), ret_ws=True, device="cpu")
    s_got = np.asarray([h[0] for hits in got for h in hits])
    s_want = np.asarray([h[0] for hits in want for h in hits])
    search_err = float(np.abs(s_got - s_want).max()) if s_got.shape == s_want.shape else float("inf")
    J, M = 4, 3000  # cut from 64 x 25,000 for the CPU's time
    args = (lf["P"][:J], lf["Pm"][:J], lf["HN"][:J], lf["HNm"][:J], lf["NEG"][:M], lf["NEGm"][:J, :M])
    Wg, bg, sg = svm.fit_linear_svm_batch(*args, device="cuda")
    Wc, bc, sc = svm.fit_linear_svm_batch(*args, device="cpu")
    # float32 sums in another order, carried through 400 Adam steps: each
    # output within 1e-4 of its largest magnitude
    svm_err = {k: float(np.abs(g - c_).max() / max(np.abs(c_).max(), 1e-30))
               for k, g, c_ in (("W", Wg, Wc), ("b", bg, bc), ("scores", sg, sc))}
    log(f"doersch: card vs CPU: dense search of {len(ws)} detectors max |d score| {search_err:.3g} (rtol 1e-5, "
        f"atol 1e-6); fit_linear_svm_batch at J {J} x {M} pool rows, max |d| over the largest magnitude {svm_err} "
        f"(bound {SVM_CARD_RTOL:g})")
    if not np.allclose(s_got, s_want, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"doersch: dense_search on the card vs the CPU: max |d score| {search_err}")
    if not max(svm_err.values()) <= SVM_CARD_RTOL:
        raise AssertionError(f"doersch: fit_linear_svm_batch on the card vs the CPU: {svm_err}")
    if not test_gap <= DOERSCH_GAP:
        raise AssertionError(f"doersch: the relative duality gap at the production shape {test_gap:.4g} > {DOERSCH_GAP}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(categories=len(countries), images_per_category=per_country, px=px, how_many=how_many,
                num_detectors=num_detectors, folds=folds, negative_pool=[25000, 2112], adam_steps=400,
                features_ms_per_image=hog_ms, hoglab_features_ms=hog_call_ms, init_s=init_s, init_dense_search_ms=init_search_s * 1e3,
                fold_dense_search_ms=[t * 1e3 for t in iter_search], svm_ms_per_fold=[t * 1e3 for t in timing["svm_s"]],
                iterative_s=iter_s, total_s=total_s, last_fold_worst_rel_duality_gap=float(max(gaps)),
                last_fold_objective_over_trivial=[min(over_trivial), max(over_trivial)],
                production_shape_rel_duality_gap=test_gap, production_shape_gap_on_run_images=run_gap,
                card_vs_cpu=dict(dense_search_max_abs=search_err, svm=svm_err, svm_shape=[J, M]),
                reduced=dict(images_per_category=per_country, how_many=how_many, categories_trained=1), card=smi)


def phase_verify_checkpoint(smi, pipeline_dir):
    """verify_checkpoint on phase 12's SD-v1.5-width export: exit code 0 and
    PASS on convert, structure (three modules) and forward."""
    import contextlib
    import io

    from diffmining_tpu_torch.utils.verify_checkpoint import main as verify

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = verify([pipeline_dir, "--device", "cuda"])
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"  {line}")
    need = ("[convert] PASS", "[structure:unet] PASS", "[structure:vae] PASS", "[structure:text_encoder] PASS",
            "[forward] PASS")
    missing = [n for n in need if not any(line.startswith(n) for line in lines)]
    if rc != 0 or missing:
        raise AssertionError(f"verify_checkpoint: exit {rc}, no {missing}")
    log(f"verify_checkpoint on the SD-v1.5-width export of phase 12: exit 0, {len(need)} stages PASS in {wall:.1f} s "
        f"on {smi}")
    return dict(rc=rc, stages=[line for line in lines if line.startswith("[")], wall_s=wall, card=smi)


# One process of phase 20, written to a file so that torchrun can start it.
# argv: OUT MODE ARGS. MODE "cli": the typicality CLI's main(ARGS); "xray":
# the xray command (under torchrun); "gloo": ARGS[0] is a JSON config, and
# the process is one rank of a gloo group on this card driving the library
# (Typicality with a mesh). Writes to OUT the artifacts the typicality sweep
# wrote, the kernel launches the process made, the backend of each
# gather_object, the TF32 flags after the port's set-up and what it printed.
SWEEP_DP_RANK = r"""
import contextlib, datetime, io, json, os, sys
import torch
import torch.distributed as dist
from diffmining_tpu_torch.ops import flash_attention as fa
from diffmining_tpu_torch.parallel import mesh as pm
from diffmining_tpu_torch.typicality import compute
out, mode, args = sys.argv[1], sys.argv[2], sys.argv[3:]
written, gathers = [], []
save, gather = compute.atomic_save_npy, dist.gather_object
compute.atomic_save_npy = lambda path, a: (written.append(path), save(path, a))
dist.gather_object = lambda *a, **k: (gathers.append(dist.get_backend()), gather(*a, **k))[1]
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    if mode == "cli":
        compute.main(args)
    elif mode == "xray":
        from diffmining_tpu_torch.__main__ import main
        main(["xray", *args])
    else:
        cfg = json.loads(args[0])
        # NCCL refuses two ranks on one card: the group is gloo's, made here
        dist.init_process_group("gloo", init_method=f"tcp://{cfg['address']}", world_size=cfg["world"],
                                rank=cfg["rank"], timeout=datetime.timedelta(minutes=5))
        mesh = pm.make_mesh(dp=cfg["world"])
        typ = compute.Typicality("ftt", cfg["pipe"], cfg["data"], cfg["tree"], t_min=0.1, t_max=0.9, N=cfg["N"],
                                 batch_images=cfg["batch_images"], dtype=torch.float32, device="cuda", mesh=mesh)
        if mesh.rank == 0:
            typ.make_submission(cfg["data"], cfg["subs"], sub_split=1)
        pm.host_barrier("submission")
        typ.compute_submission(os.path.join(cfg["subs"], "0.txt"))
        pm.destroy()
kernels = (fa.flash_fwd_nomax, fa.flash_fwd_nomax_f32, fa.flash_fwd_online, fa.flash_fwd_online_f32,
           fa.flash_fwd_nomax_cm, fa.flash_fwd_online_cm)
with open(out, "w") as f:
    json.dump(dict(written=written, launches={k.__name__: k.launches for k in kernels}, gathers=gathers,
                   printed=printed.getvalue(),
                   tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]), f)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_sweep_dp(smi, pipeline_dir):
    """The sweep over dp on one card, from phase 12's SD-v1.5-width export,
    each run a process of its own. (a) The typicality CLI in bf16 over 2
    labels x 4 synthetic 512x512 PNGs at N=4, batch_images 4, plain and
    under --distributed as an NCCL group of one (--coordinator_address):
    the artifacts bit-equal, or the largest difference printed and at most
    one fp16 ulp; K1 launches. (b) xray --mesh_dp 1 under torchrun
    (--nproc_per_node 1), an NCCL group of one, over 2 synthetic 1024x1024
    Cardiomegaly images at N=2, chunk 1, groups of 2: its maps go through
    gather_object over NCCL to rank 0, which writes them, report.json and
    auc.json; maps finite and of the image's shape, 5 K2 + 10 K1 launches a
    UNet pass. (c) Two ranks of a gloo group on this card (NCCL refuses two
    ranks on one GPU) driving the library at float32, dp 2 (two images a
    rank a group), against the plain CLI at --dtype fp32: every real
    artifact written by exactly one rank; each within one fp16 ulp of one
    process sweeping two images a group (a rank's batch); against one
    process at batch_images 4, the largest difference in fp16 ulps printed
    and each element within the fp16 artifact bound of the CPU tests (rtol
    2e-3, atol 1e-4): at another UNet batch cuDNN takes other algorithms,
    and (pred - noise)^2 loses the relative precision of a small
    difference, so a float32 rounding can move an fp16 loss by more than
    one ulp; the bit-equal ones counted; the TF32 flags each process's port
    set-up left; the float32 no-max launches on each rank. (b) runs beside
    (c). Every process starts cold, so the rate a CLI prints counts its
    start-up and first calls: it is kept as a cold-process rate, not a
    throughput. The images and the plain bf16 tree stay for phase 21, which
    removes them (``work``)."""
    import glob

    import numpy as np
    from PIL import Image

    labels, per_label, px, N, batch_images = ["1920", "1960"], 4, 512, 4, 4
    work = os.path.join(ROOT, "build", "chip_smoke_sweep_dp")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "ftt")
    rng = np.random.RandomState(SEED + 31)
    names = []
    for c in labels:
        os.makedirs(os.path.join(data, c))
        for i in range(per_label):
            # names unique across labels: an image's draws key on its file name
            Image.fromarray(rng.randint(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(data, c, f"{c}_{i}.png"), compress_level=1)
            names.append(os.path.join(c, f"{c}_{i}.npy"))
    xray_diseases, xray_per, xray_px, xray_N, xray_batch = ["Cardiomegaly"], 2, 1024, 2, 2
    cxr = os.path.join(work, "CXR8")
    xray_data(cxr, xray_diseases, xray_per, xray_px, SEED + 32)
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(SWEEP_DP_RANK)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(tag, mode, args, launcher=()):
        out = os.path.join(work, f"{tag}.json")
        return subprocess.Popen([sys.executable, *launcher, script, out, mode, *args], cwd=ROOT, env=env), out

    def wait(procs):
        results = []
        try:
            for p, out in procs:
                p.wait(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"sweep dp: {p.args[-20:]} exited {p.returncode}")
                with open(out) as f:
                    results.append(json.load(f))
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return results

    def cli_run(tag, dtype, b, extra=()):
        return run(tag, "cli", ["--which", "ftt", "-i", data, "-c", os.path.join(work, tag), "-s",
                                os.path.join(work, f"{tag}_subs"), "-m", pipeline_dir, "--make_submission", "--N",
                                str(N), "--batch_images", str(b), "--dtype", dtype, *extra])

    def cli_result(tag, r, t0):
        r["wall_s"] = time.perf_counter() - t0
        rates = re.findall(r"typicality: (\d+)/(\d+) images \(([\d,.]+) imgs/hr\)", r["printed"])
        if not rates or rates[-1][0] != rates[-1][1]:
            raise AssertionError(f"sweep dp {tag}: no final progress line in {r['printed'][-500:]!r}")
        r["cold_imgs_per_hr"] = float(rates[-1][2].replace(",", ""))
        r["artifacts"] = {n: np.load(os.path.join(work, tag, n)) for n in names}
        return r

    def compare(got, want):
        equal = sum(bool(np.array_equal(got[n], want[n])) for n in names)
        worst = max(fp16_ulps(got[n], want[n]) for n in names)
        diff = max(float(np.abs(got[n].astype(np.float32) - want[n].astype(np.float32)).max()) for n in names)
        return equal, worst, diff

    # (a) bf16: the plain CLI, then the CLI as an NCCL group of one
    t0 = t = time.perf_counter()
    plain = cli_result("plain_bf16", *wait([cli_run("plain_bf16", "bf16", batch_images)]), t)
    t = time.perf_counter()
    group = cli_result("nccl1_bf16", *wait([cli_run("nccl1_bf16", "bf16", batch_images, (
        "--distributed", "--coordinator_address", f"127.0.0.1:{free_port()}", "--num_processes", "1",
        "--process_id", "0"))]), t)
    equal, worst, diff = compare(group["artifacts"], plain["artifacts"])
    passes = len(labels) * N  # one group a label, N passes each; 10 gated attentions a pass
    for r, tag in ((plain, "plain"), (group, "nccl1")):
        if sorted(os.path.relpath(p, os.path.join(work, f"{tag}_bf16")) for p in r["written"]) != sorted(names) \
                or r["launches"]["flash_fwd_nomax"] != 10 * passes:
            raise AssertionError(f"sweep dp (a) {tag}: wrote {r['written']}, launches {r['launches']}")
    if worst > 1.0:
        raise AssertionError(f"sweep dp (a): the NCCL group of one {worst:.2f} fp16 ulps (|d| {diff:.4g}) off the plain CLI")
    log(f"sweep dp (a): typicality CLI, bf16, {len(names)} images at N={N}: plain {plain['wall_s']:.1f} s of process "
        f"(cold-process rate {plain['cold_imgs_per_hr']:.1f} imgs/hr), NCCL group of one {group['wall_s']:.1f} s "
        f"({group['cold_imgs_per_hr']:.1f}); artifacts " + ("bit-equal" if equal == len(names) else
                                                           f"{equal}/{len(names)} bit-equal, largest difference "
                                                           f"{diff:.4g} ({worst:.2f} fp16 ulps)")
        + f"; K1 launches {plain['launches']['flash_fwd_nomax']} and {group['launches']['flash_fwd_nomax']}, on {smi}")

    # (b) beside (c): xray under torchrun as an NCCL group of one; (c) float32:
    # two gloo ranks of the library on this card, and beside them the plain
    # CLI at batch_images 4 and at a rank's 2 (no time is read from them)
    xray_out = os.path.join(work, "xray_out")
    address, tree, subs = f"127.0.0.1:{free_port()}", os.path.join(work, "gloo2_fp32"), os.path.join(work, "gloo2_subs")
    t1 = time.perf_counter()
    xr, ref, ref2, *ranks = wait(
        [run("xray_nccl1", "xray", ["-i", cxr, "-o", xray_out, "-m", pipeline_dir, "--N", str(xray_N), "--chunk", "1",
                                    "--batch_images", str(xray_batch), "--mesh_dp", "1"],
             launcher=("-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1")),
         cli_run("plain_fp32", "fp32", batch_images), cli_run("plain_fp32_b2", "fp32", batch_images // 2)]
        + [run(f"gloo2_rank{r}", "gloo", [json.dumps(dict(
            address=address, world=2, rank=r, pipe=pipeline_dir, data=data, tree=tree,
            subs=subs, N=N, batch_images=batch_images))]) for r in range(2)])
    together_s = time.perf_counter() - t1

    xray_groups = len(xray_diseases) * math.ceil(xray_per / xray_batch)  # one gather_object a group
    xray_passes = xray_groups * xray_N  # chunk 1
    maps = sorted(glob.glob(os.path.join(xray_out, "*", "typicality", "*.npy")))
    report, auc = (json.load(open(os.path.join(xray_out, n))) for n in ("report.json", "auc.json"))
    bad = [m for m in maps if not ((a := np.load(m)).shape == (xray_px, xray_px) and np.isfinite(a).all())]
    if xr["launches"]["flash_fwd_nomax"] != 15 * xray_passes or xr["gathers"] != ["nccl"] * xray_groups \
            or len(maps) != xray_per or bad or not all(
                len(t[d]) == xray_per and all(math.isfinite(x) for x in t[d].values())
                for t in (report, auc) for d in xray_diseases):
        raise AssertionError(f"sweep dp (b): xray under torchrun: launches {xr['launches']}, gathers {xr['gathers']}, "
                             f"maps {maps} (not finite or not [{xray_px}, {xray_px}]: {bad}), report {report}, "
                             f"auc {auc}")
    log(f"sweep dp (b): xray --mesh_dp 1 under torchrun --nproc_per_node 1 (an NCCL group of one), "
        f"{xray_per} {xray_px}px images at N={xray_N}: flash_fwd_nomax launched {xr['launches']['flash_fwd_nomax']} "
        f"times = 5 K2 + 10 K1 per UNet pass x {xray_passes} passes; gather_object over {xr['gathers']}; "
        f"{len(maps)} pixel maps [{xray_px}, {xray_px}] finite, report.json and auc.json finite, written by rank 0")

    ref, ref2 = cli_result("plain_fp32", ref, t1), cli_result("plain_fp32_b2", ref2, t1)
    written = [os.path.relpath(p, tree) for r in ranks for p in r["written"]]
    if sorted(written) != sorted(names):
        raise AssertionError(f"sweep dp (c): the ranks wrote {written}, expected each of {names} once")
    got_b = {n: np.load(os.path.join(tree, n)) for n in names}
    equal_b, worst_b, diff_b = compare(got_b, ref2["artifacts"])
    equal_4, worst_4, diff_4 = compare(got_b, ref["artifacts"])
    beyond_4 = sum(int((np.abs(got_b[n].astype(np.float32) - w) > 2e-3 * np.abs(w) + 1e-4).sum())
                   for n, w in ((n, ref["artifacts"][n].astype(np.float32)) for n in names))
    launches_b = [r["launches"] for r in ranks]  # a rank sweeps two images of each label's group, N passes each
    flags = [r["tf32"] for r in (*ranks, ref, ref2)]
    if worst_b > 1.0 or beyond_4 or any(f != [False, False] for f in flags) \
            or any(l["flash_fwd_nomax_f32"] != 10 * passes or l["flash_fwd_nomax"] for l in launches_b):
        raise AssertionError(f"sweep dp (c): {worst_b:.2f} fp16 ulps off one process at a rank's batch; {beyond_4} "
                             f"elements beyond rtol 2e-3, atol 1e-4 of one process at batch 4 ({worst_4:.2f} ulps); "
                             f"TF32 flags {flags}; launches {launches_b}")
    log(f"sweep dp (c): two gloo ranks on this card, --dtype fp32, dp 2: {len(written)} artifacts, each written once "
        f"({len(ranks[0]['written'])} by rank 0, {len(ranks[1]['written'])} by rank 1); against one process at a "
        f"rank's batch (batch_images 2) {equal_b}/{len(names)} bit-equal, largest difference {diff_b:.4g} "
        f"({worst_b:.2f} fp16 ulps); against one process at batch_images 4 {equal_4}/{len(names)} bit-equal, largest "
        f"difference {diff_4:.4g} ({worst_4:.2f} fp16 ulps), all within rtol 2e-3, atol 1e-4; float32 no-max launches "
        f"{[l['flash_fwd_nomax_f32'] for l in launches_b]} a rank ({ref['launches']['flash_fwd_nomax_f32']} in one "
        f"process); TF32 off after each process's set-up; (b) and (c)'s five processes together {together_s:.1f} s, "
        f"on {smi}")
    return dict(work=work, data=data, tree=os.path.join(work, "plain_bf16"), images=len(names), N=N,
                batch_images=batch_images,
                nccl_group_of_one=dict(cold_imgs_per_hr=group["cold_imgs_per_hr"], wall_s=group["wall_s"],
                                       plain_cold_imgs_per_hr=plain["cold_imgs_per_hr"], plain_wall_s=plain["wall_s"],
                                       bit_equal=equal, max_fp16_ulps=worst, max_abs=diff,
                                       k1_launches=group["launches"]["flash_fwd_nomax"],
                                       plain_k1_launches=plain["launches"]["flash_fwd_nomax"]),
                xray_nccl_group_of_one=dict(images=xray_per, px=xray_px, N=xray_N, passes=xray_passes,
                                            launches=xr["launches"]["flash_fwd_nomax"], gathers=xr["gathers"]),
                gloo_dp2_fp32=dict(bit_equal_at_rank_batch=equal_b, max_fp16_ulps_at_rank_batch=worst_b,
                                   max_abs_at_rank_batch=diff_b, bit_equal_at_batch4=equal_4,
                                   max_fp16_ulps_at_batch4=worst_4, max_abs_at_batch4=diff_4,
                                   written_per_rank=[len(r["written"]) for r in ranks],
                                   nomax_f32_launches_per_rank=[l["flash_fwd_nomax_f32"] for l in launches_b],
                                   one_process_nomax_f32_launches=ref["launches"]["flash_fwd_nomax_f32"],
                                   tf32_after_setup=[r["tf32"] for r in ranks]),
                together_s=together_s, wall_s=time.perf_counter() - t0, card=smi)


# One process of phase 21, written to a file so that torchrun can start it.
# argv: OUT MODE ARGS. MODE "cli": the cluster command's main(ARGS); "gloo":
# ARGS[0] is a JSON config, and the process is one rank of a gloo group on
# this card driving the library over dp (Cluster, then ParallelCluster's
# DIFT, then dense_search); "one": the same library calls in one process,
# without a mesh. Writes to OUT the pickles the process wrote, the kernel
# launches of the clustering run and of the ParallelCluster DIFT pass, each
# DIFT pass's seconds, the TF32 flags after the port's set-up and the
# feature of the ParallelCluster pass and the dense search's lists.
MINING_DP_RANK = r"""
import datetime, json, os, pickle, sys, time
import numpy as np
import torch
import torch.distributed as dist
from diffmining_tpu_torch.applications import parallel
from diffmining_tpu_torch.baselines import doersch
from diffmining_tpu_torch.ops import flash_attention as fa
from diffmining_tpu_torch.parallel import mesh as pm
from diffmining_tpu_torch.typicality import cluster, dift
out, mode, args = sys.argv[1], sys.argv[2], sys.argv[3:]
written, passes = [], []
save = cluster.atomic_save_pickle
cluster.atomic_save_pickle = lambda path, obj: (written.append(path), save(path, obj))
forward = dift.SDFeaturizer.forward


def timed(self, *a, **k):
    t = time.perf_counter()
    feat = forward(self, *a, **k)  # host numpy: synchronised
    passes.append(time.perf_counter() - t)
    return feat


dift.SDFeaturizer.forward = timed
kernels = (fa.flash_fwd_nomax, fa.flash_fwd_nomax_f32)
result = {}
t0 = time.perf_counter()
if mode == "cli":
    from diffmining_tpu_torch.__main__ import main
    main(["cluster", *args])
else:
    cfg = json.loads(args[0])
    mesh = None
    if mode == "gloo":
        # NCCL refuses two ranks on one card: the group is gloo's, made here
        dist.init_process_group("gloo", init_method=f"tcp://{cfg['address']}", world_size=2, rank=cfg["rank"],
                                timeout=datetime.timedelta(minutes=5))
        mesh = pm.make_mesh(dp=2)
    cl = cluster.Cluster("ftt", cfg["tree"], cfg["data"], cfg["cache"], model_path=cfg["pipe"], device="cuda",
                         dtype=torch.float32, mesh=mesh)
    cl.clustering("dift-161", k=1000, num_clusters=cfg["num_clusters"])
    result["launches"] = {k.__name__: k.launches for k in kernels}
    result["passes"] = list(passes)
    # ParallelCluster's DIFT over the same mesh: one image, the France prompt
    pc = parallel.ParallelCluster(cfg["geo"], cfg["geo"], cfg["cache"] + "_parallel", dift_sd=cl.dift.sd, mesh=mesh,
                                  device="cuda", dtype=torch.float32)
    pc.init_dift()
    for k in kernels:
        k.launches = 0
    img = np.load(cfg["img"])
    result["parallel_feat"] = pc.dift.forward(img, "France", t=161, uid=7).tolist()
    result["parallel_launches"] = {k.__name__: k.launches for k in kernels}
    if mesh is not None:
        # dense_search over the two ranks at K = 5 (padded to 6)
        store = doersch.FeatureStore(cfg["hog"], cfg["shards"], device="cuda", mesh=mesh)
        shards = store.build_shards(cfg["hog_images"], "mining_dp", num_splits=2, batch_size=2)
        ws = np.random.RandomState(5).randn(5, 2112).astype(np.float32) * 0.02
        result["shards"], result["ws"] = shards, ws.tolist()
        result["search"] = doersch.dense_search(ws, shards, top_k=5, mesh=mesh, device="cuda")
        pm.destroy()
result.setdefault("launches", {k.__name__: k.launches for k in kernels})
result.setdefault("passes", passes)
result.update(written=written, wall_s=time.perf_counter() - t0,
              tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])
with open(out, "wb") as f:
    pickle.dump(result, f)
"""


def phase_mining_dp(smi, pipeline_dir, sweep_dp):
    """Mining over dp on one card, from phase 12's SD-v1.5-width export and
    phase 20's images and plain bf16 typicality tree (2 labels x 4 512x512
    PNGs at N=4), each run a process of its own, all five together. (a) The
    cluster command in bf16 (DIFT-161, E=8, 4 clusters a label), plain and
    as ``cluster --mesh_dp 1`` under ``torchrun --nproc_per_node 1``, an
    NCCL group of one whose DIFT goes through the all-reduce: embeddings
    and ranked clusters bit-equal; K1 launches (10 a 512px pass). (b) Two
    ranks of a gloo group on this card (NCCL refuses two ranks on one GPU)
    driving Cluster at float32 over dp 2, four draws a rank, against one
    process at float32: each embedding within the CPU tests' feature
    tolerance (rtol 1e-3, atol 2e-4), the largest difference printed; every
    pickle written once, by rank 0; the TF32 flags after each process's
    set-up; the float32 no-max launches on each rank. In the same
    processes, ParallelCluster's DIFT of one image over the same mesh,
    against one process within that tolerance; and dense_search at K = 5
    (padded to 6) over the two ranks on HOG shards of the images, against
    one process here: the same (bbox, path) lists, scores within 1e-4.
    DIFT images/s of each process, over its passes: every process starts
    cold and five share the card, so the rates are cold rates of processes
    sharing one card, the gloo ranks' not a speed-up."""
    import numpy as np
    import torch

    from diffmining_tpu_torch.baselines import doersch

    work = os.path.join(ROOT, "build", "chip_smoke_mining_dp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "geo"))
    labels, num_clusters = ["1920", "1960"], 4
    per_pass = 10  # the gated self-attentions of a 512px UNet pass
    data, tree = sweep_dp["data"], sweep_dp["tree"]
    images = sorted(os.path.join(data, c, f) for c in labels for f in os.listdir(os.path.join(data, c)))
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(MINING_DP_RANK)
    from PIL import Image

    img = np.asarray(Image.open(images[0]).convert("RGB"), np.float32) / 127.5 - 1.0
    np.save(os.path.join(work, "img.npy"), img)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(tag, mode, args, launcher=()):
        out = os.path.join(work, f"{tag}.pkl")
        return subprocess.Popen([sys.executable, *launcher, script, out, mode, *args], cwd=ROOT, env=env), out

    def cli_args(tag, dtype):
        return ["-w", "ftt", "-d", data, "-t", tree, "-c", os.path.join(work, tag), "-m", pipeline_dir, "--cluster",
                "--num_clusters", str(num_clusters), "--dtype", dtype]

    def lib_cfg(tag, **extra):
        return json.dumps(dict(tree=tree, data=data, cache=os.path.join(work, tag), pipe=pipeline_dir,
                               num_clusters=num_clusters, geo=os.path.join(work, "geo"),
                               img=os.path.join(work, "img.npy"), **extra))

    address = f"127.0.0.1:{free_port()}"
    procs = [run("plain_bf16", "cli", cli_args("plain_bf16", "bf16")),
             run("nccl1_bf16", "cli", cli_args("nccl1_bf16", "bf16") + ["--mesh_dp", "1"],
                 launcher=("-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1")),
             run("one_fp32", "one", [lib_cfg("one_fp32")])]
    procs += [run(f"gloo2_rank{r}", "gloo", [lib_cfg("gloo2_fp32", address=address, rank=r,
                                                     hog=os.path.join(work, "hog"), shards=os.path.join(work, "shards"),
                                                     hog_images=images)]) for r in range(2)]
    t0 = time.perf_counter()
    results = []
    try:
        for p, out in procs:
            p.wait(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"mining dp: {p.args[-6:]} exited {p.returncode}")
            with open(out, "rb") as f:
                results.append(pickle.load(f))
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    together_s = time.perf_counter() - t0
    plain, group, one, *ranks = results

    def embeddings(tag):
        d = os.path.join(work, tag, "embeddings", "dift-161")
        return {n: pickle.load(open(os.path.join(d, n), "rb")) for n in sorted(os.listdir(d))}

    def crops(tag, member=True):
        """Each label's member crops, {rank}-{member}-{num_clusters}_{id}.png;
        without the member index (its order by distance to the centre) as
        (rank, id)."""
        names = {c: sorted(os.listdir(os.path.join(work, tag, "images", "clusters", "ranked", "dift-161", c)))
                 for c in labels}
        return names if member else {c: sorted((n.split("-")[0], n.split("_", 1)[1]) for n in v)
                                     for c, v in names.items()}

    def rates(r):
        p = r["passes"]
        return dict(passes=len(p), cold_images_per_s=len(p) / sum(p),
                    warm_images_per_s=(len(p) - 1) / sum(p[1:]) if len(p) > 1 else None, first_pass_s=p[0],
                    wall_s=r["wall_s"])

    # (a) the NCCL group of one against the plain process, bf16
    e_plain, e_group = embeddings("plain_bf16"), embeddings("nccl1_bf16")
    n_patches = sum(len(pickle.load(open(os.path.join(work, "plain_bf16", "clusters", f"{c}.pkl"), "rb"))[0])
                    for c in labels)  # every top patch (k_per_image 5 an image) is clustered
    equal = sum(bool(np.array_equal(e_group[n], e_plain[n])) for n in e_plain) if set(e_plain) == set(e_group) else 0
    k1 = [r["launches"]["flash_fwd_nomax"] for r in (plain, group)]
    if len(e_plain) != n_patches or equal != len(e_plain) or crops("plain_bf16") != crops("nccl1_bf16") \
            or k1 != [per_pass * len(plain["passes"])] * 2 or len(group["passes"]) != len(images):
        raise AssertionError(f"mining dp (a): {equal}/{len(e_plain)} embeddings of the NCCL group of one bit-equal to "
                             f"the plain process's ({len(e_group)} written), crops equal "
                             f"{crops('plain_bf16') == crops('nccl1_bf16')}, K1 launches {k1} over "
                             f"{len(plain['passes'])} and {len(group['passes'])} DIFT passes")
    ra, rg = rates(plain), rates(group)
    log(f"mining dp (a): cluster, bf16, DIFT-161 E=8 over {len(images)} 512px images ({n_patches} patches, "
        f"{num_clusters} clusters a label): cluster --mesh_dp 1 under torchrun --nproc_per_node 1 (an NCCL group of "
        f"one, its DIFT through the all-reduce) against the plain process: {equal}/{len(e_plain)} embeddings and the "
        f"ranked clusters bit-equal; K1 launches {k1[1]} and {k1[0]} ({per_pass} a pass); DIFT {rg['cold_images_per_s']:.2f}"
        f" and {ra['cold_images_per_s']:.2f} images/s cold (warm passes {rg['warm_images_per_s']:.2f} and "
        f"{ra['warm_images_per_s']:.2f}; five processes sharing the card), on {smi}")

    # (b) two gloo ranks at float32 against one process
    e_one, e_gloo = embeddings("one_fp32"), embeddings("gloo2_fp32")
    diffs = {n: float(np.abs(e_gloo[n] - e_one[n]).max()) for n in e_one if n in e_gloo}
    beyond = [n for n in diffs if not np.allclose(e_gloo[n], e_one[n], rtol=1e-3, atol=2e-4)]
    cache = os.path.join(work, "gloo2_fp32")
    written = [[os.path.relpath(p, cache) for p in r["written"]] for r in ranks]
    want_written = sorted([os.path.join("clusters", f"{c}.pkl") for c in labels]
                          + [os.path.join("embeddings", "dift-161", n) for n in e_gloo])
    f32 = [r["launches"]["flash_fwd_nomax_f32"] for r in ranks]
    flags = [r["tf32"] for r in (*ranks, one)]
    pf = [np.asarray(r["parallel_feat"], np.float32) for r in (*ranks, one)]
    pf_diff = float(np.abs(pf[0] - pf[2]).max())
    pf_rel = pf_diff / float(np.abs(pf[2]).max())
    if set(e_gloo) != set(e_one) or len(e_one) != n_patches or beyond or sorted(written[0]) != want_written \
            or written[1] or any(f != [False, False] for f in flags) \
            or f32 != [per_pass * len(images)] * 2 or one["launches"]["flash_fwd_nomax_f32"] != per_pass * len(images) \
            or any(r["launches"]["flash_fwd_nomax"] for r in (*ranks, one)) \
            or not np.array_equal(pf[0], pf[1]) or not np.allclose(pf[0], pf[2], rtol=1e-3, atol=2e-4) \
            or [r["parallel_launches"]["flash_fwd_nomax_f32"] for r in ranks] != [per_pass] * 2:
        raise AssertionError(f"mining dp (b): embeddings {sorted(e_gloo)} against {sorted(e_one)}, beyond rtol 1e-3, "
                             f"atol 2e-4: {beyond} (largest difference {max(diffs.values(), default=0):.3g}); rank 0 "
                             f"wrote {sorted(written[0])}, rank 1 {written[1]}; TF32 flags {flags}; launches "
                             f"{[r['launches'] for r in (*ranks, one)]}; ParallelCluster DIFT off by {pf_diff:.3g}, "
                             f"launches {[r['parallel_launches'] for r in ranks]}")
    same_clusters = crops("gloo2_fp32", member=False) == crops("one_fp32", member=False)
    same_order = crops("gloo2_fp32") == crops("one_fp32")
    # dense_search over the two ranks against one process here, on rank 0's shards
    want = doersch.dense_search(np.asarray(ranks[0]["ws"], np.float32), ranks[0]["shards"], top_k=5, device="cuda")
    got = ranks[0]["search"]
    search_diff = max(abs(g[0] - w[0]) for gl, wl in zip(got, want) for g, w in zip(gl, wl))
    if len(got) != 5 or len(want) != 5 or ranks[1]["search"] != got or search_diff > 1e-4 \
            or [[h[1:] for h in l] for l in got] != [[h[1:] for h in l] for l in want]:
        raise AssertionError(f"mining dp (b): dense_search over two ranks {got} against one process {want}")
    r0, r1, ro = (rates(r) for r in (*ranks, one))
    log(f"mining dp (b): two gloo ranks on this card, float32, dp 2 (four draws a rank): {len(e_gloo)} embeddings, "
        f"written once by rank 0 ({len(written[0])} pickles; rank 1 none), within rtol 1e-3, atol 2e-4 of one "
        f"process, largest difference {max(diffs.values()):.3g}; ranked clusters "
        + ("the same" if same_clusters else "not the same (near-equal distances)")
        + (", members in the same order" if same_order else ", members in another order (near-equal distances)")
        + f"; float32 no-max launches {f32} a rank ({one['launches']['flash_fwd_nomax_f32']} in one process); TF32 "
        f"{flags[0]} after each set-up; ParallelCluster's DIFT over the mesh {pf_diff:.3g} off one process "
        f"({pf_rel:.3g} of its largest element), "
        f"{ranks[0]['parallel_launches']['flash_fwd_nomax_f32']} launches a rank; dense_search at K=5 (padded to 6) "
        f"the same lists as one process, scores within {search_diff:.3g}; DIFT images/s cold {r0['cold_images_per_s']:.2f}"
        f" and {r1['cold_images_per_s']:.2f} (two ranks sharing one card with three other processes, not a speed-up; "
        f"warm passes {r0['warm_images_per_s']:.2f} and {r1['warm_images_per_s']:.2f}), one process "
        f"{ro['cold_images_per_s']:.2f} ({ro['warm_images_per_s']:.2f} warm); five processes together "
        f"{together_s:.1f} s, on {smi}")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(sweep_dp["work"], ignore_errors=True)
    return dict(images=len(images), patches=n_patches, num_clusters=num_clusters,
                nccl_group_of_one=dict(bit_equal=equal, k1_launches=k1[1], plain_k1_launches=k1[0],
                                       dift=rg, plain_dift=ra),
                gloo_dp2_fp32=dict(max_abs=max(diffs.values()), same_clusters=same_clusters, same_member_order=same_order,
                                   written_per_rank=[len(w) for w in written],
                                   nomax_f32_launches_per_rank=f32,
                                   one_process_nomax_f32_launches=one["launches"]["flash_fwd_nomax_f32"],
                                   tf32_after_setup=flags, parallel_dift_max_abs=pf_diff, parallel_dift_max_rel=pf_rel,
                                   parallel_dift_launches_per_rank=[r["parallel_launches"]["flash_fwd_nomax_f32"]
                                                                     for r in ranks],
                                   dense_search_max_abs=search_diff, dift_per_rank=[r0, r1], one_process_dift=ro),
                together_s=together_s, card=smi)


# One process of phase 22, written to a file so that torchrun can start it.
# argv: OUT MODE ARGS. MODE "cli": the finetune command's main(ARGS), with
# each train step timed (synchronised) and its loss read, the seconds of
# the set-up, the checkpoint and the export, and after the run a checksum
# of the bits of every final parameter and EMA tensor, the kernels'
# launches and the peak memory; "gloo": ARGS[0] is a JSON config, and the
# process is one rank of a gloo group on this card running one float32 step
# from the same weights and batch four times: twice without a mesh (the
# spread of two one-process runs), over dp 2 and over dp 1 x fsdp 2, each
# against the first.
TRAIN_DP_RANK = r"""
import datetime, json, os, sys, time
import torch
import torch.distributed as dist
from diffmining_tpu_torch.finetuning import base, train
from diffmining_tpu_torch.ops import flash_attention as fa
from diffmining_tpu_torch.parallel import mesh as pm
out, mode, args = sys.argv[1], sys.argv[2], sys.argv[3:]
kernels = (fa.flash_fwd_lse, fa.flash_bwd_dq, fa.flash_bwd_dkv, fa.flash_fwd_lse_f32, fa.flash_bwd_dq_f32,
           fa.flash_bwd_dkv_f32, fa.flash_fwd_nomax)
result = {}


def gate(point):
    # at a named point: say so (create TRAIN_DP_<POINT>_SAY), then wait for TRAIN_DP_<POINT>_WAIT to exist
    say, wait = (os.environ.get(f"TRAIN_DP_{point}_{k}") for k in ("SAY", "WAIT"))
    if say:
        open(say, "w").close()
    t = time.perf_counter()
    while wait and not os.path.exists(wait):
        if time.perf_counter() - t > 900:
            raise TimeoutError(f"no {wait} after 900 s")
        time.sleep(0.05)


def checksum(t):
    # two sums of the bits as int32 words, plain and weighted by position (int64, wrapping)
    w = t.detach().contiguous().view(torch.int32).reshape(-1).long()
    pos = torch.arange(1, w.numel() + 1, device=w.device)
    return [int(w.sum()), int((w * pos).sum())]


if mode == "cli":
    from diffmining_tpu_torch.__main__ import main
    steps, losses, trainers, seconds = [], [], [], {}
    build, end = train.TrainStepBuilder.build, base.BaseTrainer.end_training

    def timed_method(cls, name):
        method = getattr(cls, name)

        def timed(self, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = method(self, *a, **k)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t
            return r
        setattr(cls, name, timed)

    for name in ("__init__", "training_init", "save_checkpoint"):
        timed_method(base.BaseTrainer, name)
    save = base.BaseTrainer.save_checkpoint

    def gated_save(self, *a, **k):
        if "save_checkpoint" not in seconds:
            gate("SAVE")
        return save(self, *a, **k)

    base.BaseTrainer.save_checkpoint = gated_save
    reduce_ms, reduce = [], train.all_reduce_mean_

    def timed_reduce(tensors, mesh):
        torch.cuda.synchronize()
        t = time.perf_counter()
        reduce(tensors, mesh)
        torch.cuda.synchronize()
        if len(tensors) > 1:  # the gradients (the loss is a tensor alone)
            reduce_ms.append((time.perf_counter() - t) * 1e3)

    train.all_reduce_mean_ = timed_reduce

    def timed_build(self):
        step = build(self)

        def timed(*a, **k):
            if not steps:
                gate("STEPS")
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, loss = step(*a, **k)
            losses.append(float(loss))  # synchronises
            steps.append((time.perf_counter() - t) * 1e3)
            return state, loss
        return timed

    def keep_trainer(self):
        trainers.append(self)
        return end(self)

    train.TrainStepBuilder.build, base.BaseTrainer.end_training = timed_build, keep_trainer
    timed_method(base.BaseTrainer, "end_training")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    main(["finetune", *args])
    seconds["main"] = time.perf_counter() - t
    tr = trainers[0]
    result.update(steps_ms=steps, losses=losses, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                  mesh=None if tr.mesh is None else [tr.mesh.dp, tr.mesh.fsdp, tr.mesh.world],
                  params=[checksum(p) for p in tr.state.params.values()],
                  ema=[checksum(e) for e in tr.builder.whole_ema(tr.state).values()], seconds=seconds,
                  reduce_ms=reduce_ms)
else:
    cfg = json.loads(args[0])
    lr = cfg["lr"]
    # NCCL refuses two ranks on one card: the group is gloo's, made here
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://{cfg['address']}", world_size=2, rank=cfg["rank"],
                            timeout=datetime.timedelta(minutes=5))
    from diffmining_tpu_torch.finetuning.args import parse_args
    targs = parse_args(["--base_name_or_path", cfg["pipe"], "--output_dir", cfg["work"], "--mixed_precision", "no",
                        "--use_ema", "--learning_rate", str(lr), "--seed", str(cfg["seed"]), "--device", "cuda"])
    tr = base.BaseTrainer("ftt", targs)  # no mesh flags: the models alone
    initial = {k: p.detach().clone() for k, p in tr.unet.named_parameters()}
    gate("RUNS")
    g = torch.Generator().manual_seed(cfg["seed"])
    images = (torch.rand((2, 3, cfg["px"], cfg["px"]), generator=g) * 2 - 1).cuda()
    tokens = torch.from_numpy(tr.tokenizer(["A face portrait of the 1930s.", "A face portrait of the 1990s."])).cuda()
    runs, one = {}, None

    def stats(got, want):
        # |got - want| over every element: the largest, and how many exceed 1e-3 lr or differ at all
        worst, beyond, differ, n = 0.0, 0, 0, 0
        for k, w in want.items():
            d = (got[k].detach() - w).abs()
            worst = max(worst, float(d.max()))
            beyond += int((d > 1e-3 * lr).sum())
            differ += int((d > 0).sum())
            n += d.numel()
        return dict(max_abs=worst, beyond_share=beyond / n, differ_share=differ / n, elements=n)

    for name, mesh in (("one", None), ("one again", None), ("dp2", pm.make_mesh(dp=2)),
                       ("fsdp2", pm.make_mesh(dp=1, fsdp=2))):
        with torch.no_grad():
            for k, p in tr.unet.named_parameters():
                p.copy_(initial[k])
        tr.mesh = mesh
        b = tr._builder(train.make_optimizer(train.make_lr_schedule("constant", lr, 0)))
        st = b.init_state()
        rows = slice(None) if mesh is None else pm.host_local_batch_slice(2, mesh)
        for f in kernels:
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        st, loss = b.build()(st, images[rows], tokens[rows], seed=cfg["seed"])
        loss = float(loss)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3
        # the peak less what the comparisons keep on the card: the initial weights and the first run's results
        kept = [initial] if one is None else [initial, *one]
        peak = (torch.cuda.max_memory_allocated() - sum(v.numel() * v.element_size() for part in kept
                                                          for v in part.values())) / 2**30
        ema = b.whole_ema(st)
        params = {k: p.detach() for k, p in st.params.items()}
        state_bytes = dict(moments=sum(m.numel() * m.element_size() for m in (*st.opt_state.mu, *st.opt_state.nu)),
                           ema=sum(e.numel() * e.element_size() for e in st.ema_params.values()))
        runs[name] = dict(loss=loss, step_ms=step_ms, peak_gib=peak, state_bytes=state_bytes,
                          launches={f.__name__: f.launches for f in kernels})
        if one is None:  # the reference, kept on the card
            one = ({k: v.clone() for k, v in params.items()}, {k: v.clone() for k, v in ema.items()})
        else:
            runs[name].update(params_vs_one=stats(params, one[0]), ema_vs_one=stats(ema, one[1]))
        del st, b, ema, params
        torch.cuda.empty_cache()
    result.update(runs=runs, tf32=[torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32])
    pm.destroy()
result["launches"] = {f.__name__: f.launches for f in kernels}
with open(out, "w") as f:
    json.dump(result, f)
"""


def phase_train_dp(smi, pipeline_dir):
    """The trainer over dp and fsdp on one card, from phase 12's
    SD-v1.5-width export at 512px, each run a process of its own. (a)
    ``finetune --mesh_dp 1`` under torchrun (--nproc_per_node 1), an NCCL
    group of one (the gradients through the bucketed all-reduce), and the
    plain finetune process on the same flags, loading together and stepping
    one after the other: bf16 autocast, EMA, batch 4 of 8 synthetic
    512x512 PNGs, 6 steps (5 warm ones to time), a checkpoint and an export
    each; the losses, the final parameters and the EMA bit-equal (two
    checksums of the bits of every tensor), 10 launches each of K4, K5 and
    K6 a step, the warm step ms of both, the group's all-reduce ms and the
    seconds of their set-up, checkpoint and export. (b) Two ranks of a gloo group
    on this card (NCCL refuses two ranks on one GPU), float32
    (--mixed_precision no), EMA, a global batch of 2 at 512px, one step
    four times from the same weights: twice without a mesh, over dp 2 (a
    rank's batch 1) and over dp 1 x fsdp 2 (the optimizer state and the
    EMA sharded). dp 2 is held to one process within 2·lr everywhere and
    1e-3·lr for 99% of the elements (the CPU tests' criterion); fsdp 2 is
    bit-equal to one process, or, where the two one-process runs already
    differ (the float32 backward does not repeat bit for bit on the card),
    held to the CPU criterion and to twice their spread (the share of
    elements beyond 1e-3·lr). Each rank's optimizer-state and EMA bytes and
    peak GiB of each run; the float32 K4-K6 launches (10 each a step)."""
    import numpy as np
    from PIL import Image

    work = os.path.join(ROOT, "build", "chip_smoke_train_dp")
    shutil.rmtree(work, ignore_errors=True)
    data = os.path.join(work, "ftt")
    rng = np.random.RandomState(SEED + 41)
    px, batch, n_steps, lr = 512, 4, 6, 1e-4
    for c in ("1930", "1990"):
        os.makedirs(os.path.join(data, c))
        for i in range(4):
            Image.fromarray(rng.randint(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(data, c, f"{c}_{i}.png"), compress_level=1)
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(TRAIN_DP_RANK)
    env = dict(os.environ, PYTHONPATH=ROOT)

    def run(tag, mode, args, launcher=()):
        out = os.path.join(work, f"{tag}.json")
        return subprocess.Popen([sys.executable, *launcher, script, out, mode, *args], cwd=ROOT, env=env), out

    def wait(procs):
        results = []
        try:
            for p, out in procs:
                p.wait(timeout=600)
                if p.returncode != 0:
                    raise AssertionError(f"train dp: {p.args[-12:]} exited {p.returncode}")
                with open(out) as f:
                    results.append(json.load(f))
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return results

    def finetune(tag, *extra, launcher=()):
        return run(tag, "cli", ["--which", "ftt", "--base_name_or_path", pipeline_dir, "--data_path", data,
                                "--output_dir", os.path.join(work, tag), "--train_batch_size", str(batch),
                                "--resolution", str(px), "--max_train_steps", str(n_steps), "--checkpointing_steps",
                                str(n_steps), "--mixed_precision", "bf16", "--use_ema", "--seed", str(SEED),
                                "--device", "cuda", *extra], launcher)

    # The processes share the card in turns: (a)'s plain process and NCCL
    # group of one start and load together; the plain process steps once
    # the group has loaded, the group once the plain process has stepped,
    # and both write their checkpoints and exports after that; (b)'s gloo
    # ranks start when the group has stepped and run their steps once both
    # of (a)'s processes have exited. So no process steps beside another's
    # loading, stepping or writing (a step beside the other's checkpoint
    # writes read 31% slower in one run).
    t0 = time.perf_counter()
    gates = {g: os.path.join(work, g) for g in ("plain_loaded", "group_loaded", "plain_stepped", "group_stepped",
                                                "a_exited")}

    def start(tag, points, *extra, **kw):
        for point, (say, wait_for) in points.items():
            env[f"TRAIN_DP_{point}_SAY"], env[f"TRAIN_DP_{point}_WAIT"] = say, wait_for
        proc = finetune(tag, *extra, **kw) if tag in ("plain", "nccl1") else run(tag, "gloo", list(extra))
        for point in points:
            del env[f"TRAIN_DP_{point}_SAY"], env[f"TRAIN_DP_{point}_WAIT"]
        return proc

    first = start("plain", {"STEPS": (gates["plain_loaded"], gates["group_loaded"]),
                            "SAVE": (gates["plain_stepped"], gates["group_stepped"])})
    second = start("nccl1", {"STEPS": (gates["group_loaded"], gates["plain_stepped"]),
                             "SAVE": (gates["group_stepped"], "")}, "--distributed", "--mesh_dp", "1",
                   launcher=("-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1"))
    while not os.path.exists(gates["group_stepped"]) and first[0].poll() is None and second[0].poll() is None:
        time.sleep(0.1)
    # (b) two gloo ranks, float32: one process (twice), dp 2, dp 1 x fsdp 2
    t1 = time.perf_counter()
    address = f"127.0.0.1:{free_port()}"
    gloo = [start(f"gloo_rank{r}", {"RUNS": ("", gates["a_exited"])}, json.dumps(dict(
        address=address, rank=r, pipe=pipeline_dir, lr=lr, seed=SEED, px=px, work=os.path.join(work, f"g{r}"))))
        for r in range(2)]
    try:
        plain, group = wait([first, second])
    except BaseException:
        for p, _ in gloo:
            p.kill()
            p.wait()
        raise
    finally:
        open(gates["a_exited"], "w").close()
    a_s = time.perf_counter() - t0
    ranks = wait(gloo)
    gloo_s = time.perf_counter() - t1
    for r, tag in ((plain, "plain"), (group, "nccl1")):
        r["written"] = sorted(os.listdir(os.path.join(work, tag)))
        shutil.rmtree(os.path.join(work, tag), ignore_errors=True)
    want = {"flash_fwd_lse": 10 * n_steps, "flash_bwd_dq": 10 * n_steps, "flash_bwd_dkv": 10 * n_steps}
    for r, tag in ((plain, "plain"), (group, "nccl1")):
        got = {k: r["launches"][k] for k in want}
        if got != want or any(v for k, v in r["launches"].items() if k not in want) or \
                r["written"] != [f"checkpoint-{n_steps}", "export", "logs", "trainer_args.json"]:
            raise AssertionError(f"train dp (a) {tag}: launches {r['launches']} (expected {want}), wrote {r['written']}")
    if plain["mesh"] is not None or group["mesh"] != [1, 1, 1]:
        raise AssertionError(f"train dp (a): meshes {plain['mesh']} and {group['mesh']}")
    equal = dict(losses=plain["losses"] == group["losses"], params=plain["params"] == group["params"],
                 ema=plain["ema"] == group["ema"])
    if not all(equal.values()):
        raise AssertionError(f"train dp (a): the NCCL group of one is not bit-equal to the plain process: {equal}; "
                             f"losses {plain['losses']} and {group['losses']}")
    warm = {tag: statistics.median(r["steps_ms"][1:]) for r, tag in ((plain, "plain"), (group, "nccl1"))}
    log(f"train dp (a): finetune, bf16, EMA, batch {batch} at {px}px, {n_steps} steps: the NCCL group of one under "
        f"torchrun bit-equal to the plain process (losses {', '.join(f'{x:.6f}' for x in plain['losses'])}, "
        f"{len(plain['params'])} parameter and {len(plain['ema'])} EMA tensors by checksum); K4, K5, K6 launched "
        f"{want['flash_fwd_lse']} times each in each; step ms plain {', '.join(f'{x:.1f}' for x in plain['steps_ms'])}, "
        f"group {', '.join(f'{x:.1f}' for x in group['steps_ms'])} (warm medians {warm['plain']:.1f} and "
        f"{warm['nccl1']:.1f}, "
        f"{warm['nccl1'] / warm['plain'] - 1:+.1%}); the group's bucketed gradient all-reduce "
        f"{', '.join(f'{x:.2f}' for x in group['reduce_ms'])} ms a step, warm median "
        f"{statistics.median(group['reduce_ms'][1:]):.2f} (synchronised on each side; the plain "
        f"process's call returns at once: {', '.join(f'{x:.3f}' for x in plain['reduce_ms'])} ms); peak "
        f"{plain['peak_gib']:.2f} and {group['peak_gib']:.2f} GiB; "
        f"both processes {a_s:.1f} s (in-process seconds "
        f"{json.dumps({k: round(v, 1) for k, v in plain['seconds'].items()})} and "
        f"{json.dumps({k: round(v, 1) for k, v in group['seconds'].items()})}), on {smi}")

    f32_want = {"flash_fwd_lse_f32": 10, "flash_bwd_dq_f32": 10, "flash_bwd_dkv_f32": 10}
    bad = []
    for i, r in enumerate(ranks):
        for name, run_ in r["runs"].items():
            got = {k: run_["launches"][k] for k in f32_want}
            if got != f32_want or any(v for k, v in run_["launches"].items() if k not in f32_want) or \
                    not math.isfinite(run_["loss"]):
                bad.append(f"rank {i} {name}: launches {run_['launches']}, loss {run_['loss']}")
        for name in ("dp2", "fsdp2"):
            for part in ("params", "ema"):
                s = r["runs"][name][f"{part}_vs_one"]
                if s["max_abs"] > 2 * lr + 1e-6 or s["beyond_share"] > 0.01:
                    bad.append(f"rank {i} {name} {part}: {s}")
        for part in ("params", "ema"):
            s, sp = r["runs"]["fsdp2"][f"{part}_vs_one"], r["runs"]["one again"][f"{part}_vs_one"]
            if sp["differ_share"] == 0 and s["differ_share"] > 0:
                bad.append(f"rank {i} fsdp2 {part}: not bit-equal to one process ({s}) where one process repeats")
            if s["beyond_share"] > 2 * sp["beyond_share"] + 1e-6:
                bad.append(f"rank {i} fsdp2 {part}: {s['beyond_share']:.3g} of the elements beyond 1e-3 lr, twice "
                           f"the two one-process runs' {sp['beyond_share']:.3g}")
        if r["tf32"] != [False, False]:
            bad.append(f"rank {i}: TF32 flags {r['tf32']}")
    if bad:
        raise AssertionError("train dp (b): " + "; ".join(bad))
    for i, r in enumerate(ranks):
        log(f"train dp (b) rank {i}: " + "; ".join(
            f"{name} loss {x['loss']:.6f}, step {x['step_ms']:.1f} ms, peak {x['peak_gib']:.2f} GiB, moments "
            f"{x['state_bytes']['moments'] / 1e9:.3f} GB, EMA {x['state_bytes']['ema'] / 1e9:.3f} GB"
            + ("" if name == "one" else f", params vs one: max |d| {x['params_vs_one']['max_abs']:.3g}, "
               f"{x['params_vs_one']['differ_share']:.3g} differ, {x['params_vs_one']['beyond_share']:.3g} beyond "
               f"1e-3 lr; EMA max |d| {x['ema_vs_one']['max_abs']:.3g}")
            for name, x in r["runs"].items()))
    log(f"train dp (b): the float32 K4, K5, K6 launched 10 times a run on each rank; two ranks {gloo_s:.1f} s, "
        f"on {smi}")
    shutil.rmtree(work, ignore_errors=True)
    per_rank = {name: dict(peak_gib=[r["runs"][name]["peak_gib"] for r in ranks],
                           step_ms=[r["runs"][name]["step_ms"] for r in ranks],
                           moments_bytes=[r["runs"][name]["state_bytes"]["moments"] for r in ranks],
                           ema_bytes=[r["runs"][name]["state_bytes"]["ema"] for r in ranks],
                           params_vs_one=[r["runs"][name].get("params_vs_one") for r in ranks],
                           ema_vs_one=[r["runs"][name].get("ema_vs_one") for r in ranks])
                for name in ranks[0]["runs"]}
    f32_launches = {k: sum(r["runs"][name]["launches"][k] for r in ranks for name in r["runs"]) for k in f32_want}
    return dict(nccl_group_of_one=dict(bit_equal=equal, losses=group["losses"], steps_ms=group["steps_ms"],
                                       plain_steps_ms=plain["steps_ms"], peak_gib=group["peak_gib"],
                                       plain_peak_gib=plain["peak_gib"], launches=group["launches"],
                                       plain_launches=plain["launches"], wall_s=a_s, seconds=group["seconds"],
                                       plain_seconds=plain["seconds"], reduce_ms=group["reduce_ms"]),
                gloo_fp32=dict(runs=per_rank, launches=f32_launches, wall_s=gloo_s),
                wall_s=time.perf_counter() - t0, card=smi)


# Phase 24's stand-in interpreter: the stand-in `python` (and `torchrun`, as
# `-m torch.distributed.run`) that phase 24 puts first on PATH runs this
# file first. argv: as python's (`[-u] -m MODULE ARGS` or `SCRIPT ARGS`).
# It runs the command as python would, with sys.executable pointing back at
# the stand-in so that torchrun's workers come through here too, and at exit
# writes to $SURFACE_COUNTS/{pid}.json the command, the launches each kernel
# wrapper counted in this process, the process groups it joined, whether
# torchrun started it and its start and end on the host's clock.
SURFACE_BOOT = r"""
import atexit, json, os, runpy, sys, time
started = time.time()
import torch.distributed as dist
argv = sys.argv[1:]
while argv and argv[0] == "-u":
    argv = argv[1:]
backends, init = [], dist.init_process_group


def init_process_group(*a, **k):
    out = init(*a, **k)
    backends.append(dist.get_backend())
    return out


def dump():
    fa = sys.modules.get("diffmining_tpu_torch.ops.flash_attention")
    fn = sys.modules.get("diffmining_tpu_torch.ops.fused_norm")
    launches = {n: getattr(fa, n).launches for n in ("flash_fwd_nomax", "flash_fwd_online", "flash_fwd_lse",
                                                     "flash_fwd_nomax_f32", "flash_fwd_online_f32",
                                                     "flash_fwd_nomax_cm", "flash_fwd_online_cm")} if fa else {}
    if fn is not None:
        launches["gn_act_proj"] = fn.gn_act_proj.launches
    out = os.path.join(os.environ["SURFACE_COUNTS"], f"{os.getpid()}.json")
    with open(out + ".tmp", "w") as f:
        json.dump(dict(argv=argv, launches=launches, backends=backends, torchrun="TORCHELASTIC_RUN_ID" in os.environ,
                       started=started, ended=time.time()), f)
    os.replace(out + ".tmp", out)  # whole when it appears: phase 24 polls for it


dist.init_process_group = init_process_group
atexit.register(dump)
sys.executable = os.environ["SURFACE_PYTHON"]
if argv[0] == "-m":
    sys.argv = argv[1:]
    runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
else:
    sys.argv = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(argv[0])))
    runpy.run_path(argv[0], run_name="__main__")
"""
CARS_SHAPES = [(256, 384, 8), (256, 448, 8), (256, 512, 8)]  # (H, W, images a decade)
CARS_DECADES = {"1950": 1954, "1980": 1986}


SWEEP_ARGV = ["-m", "diffmining_tpu_torch.typicality.compute"]


def count_files(path):
    out = []
    for name in sorted(os.listdir(path)):
        if name.endswith(".json"):
            with open(os.path.join(path, name)) as f:
                out.append(json.load(f))
    return out


def phase_surface(smi, pipeline_dir):
    """The last surface of the port, each part a process of its own, side by
    side on the card: (b) and (c) from the start; the direct command, (a)
    and (d) once the two scripts' sweeps are done, beside their mining
    stages. (a) examples/run_tiny_pipeline_torch.py: all
    nine stages of the tiny product line on CUDA tensors in one process
    (no attention reaches the kernels' gate at 32-128 px). (b) `bash
    scripts_gpu/typicality.sh cars PIPE DATA 4` on phase 12's SD-v1.5-width
    export over a synthetic cars set (a folder of PNGs beside DATA.json with
    a year each): 2 decades x 8 images at each of 256x384, 256x448 and
    256x512, so the level-0 self-attention runs at L 1536, 1792 and 2048,
    K3's lengths on a default path; every group is full (batch_images 8),
    and 24 images of 5 patches a decade give the figure stage (clusters of
    at least 5 of 32) clusters to draw. The script runs the sweep at its
    defaults (N 100, bf16), `cluster --cluster`, the figures and the HTML;
    the pt mode skips itself (no vanilla SD dir). Its artifacts are finite
    fp16 [100, 2, 4, 32, W/8] and bit-equal to the same typicality command
    run directly; the sweep launched K3 5 times a UNet pass and no other
    kernel; the cluster pickles, the figures and index.html are written.
    (c) The script again with MESH_DP=1: the sweep under torchrun, an NCCL
    group of one, bit-equal to (b). (d) `scripts_gpu/convert_models.py PIPE
    OUT`: verify_checkpoint PASS on the card. The scripts' python and
    torchrun are stand-ins that run SURFACE_BOOT, which reads each
    process's launch counts. (e) K3 bf16 at the sweep's batch shapes (B16
    H8 D40 at L 1536, 1792, 2048) against its plain version, with times,
    the bound and sdpa's time."""
    import numpy as np
    import torch
    from PIL import Image

    work = os.path.join(ROOT, "build", "chip_smoke_surface")
    shutil.rmtree(work, ignore_errors=True)
    bin_dir = os.path.join(work, "bin")
    os.makedirs(bin_dir)
    boot = os.path.join(work, "surface_boot.py")
    with open(boot, "w") as f:
        f.write(SURFACE_BOOT)
    for name, extra in (("python", ""), ("torchrun", " -m torch.distributed.run")):
        with open(os.path.join(bin_dir, name), "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "{boot}"{extra} "$@"\n')
        os.chmod(os.path.join(bin_dir, name), 0o755)
    data = os.path.join(work, "data", "cars")
    os.makedirs(data)
    rng = np.random.RandomState(SEED + 41)
    meta, widths = {}, {}
    for decade, year in CARS_DECADES.items():
        for h, w, n in CARS_SHAPES:
            for i in range(n):
                name = f"car_{decade}_{w}_{i}.png"  # unique: an image's draws key on its file name
                Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(os.path.join(data, name),
                                                                                    compress_level=1)
                meta[name], widths[name] = {"year": year + i % 3}, w
    with open(data + ".json", "w") as f:
        json.dump(meta, f)
    groups = sum(n // 8 for _h, _w, n in CARS_SHAPES) * len(CARS_DECADES)
    N = 100  # the CLI's default, which the script keeps

    def env_for(tag, **extra):
        counts = os.path.join(work, f"{tag}_counts")
        os.makedirs(counts)
        return dict(os.environ, PYTHONPATH=ROOT, PATH=f"{bin_dir}:{os.environ['PATH']}", SURFACE_COUNTS=counts,
                    SURFACE_PYTHON=os.path.join(bin_dir, "python"), **extra), counts

    procs = {}

    def start(tag, cmd, cwd, env):
        os.makedirs(cwd, exist_ok=True)
        log_path = os.path.join(work, f"{tag}.log")
        with open(log_path, "w") as out:
            procs[tag] = (subprocess.Popen(cmd, cwd=cwd, env=env, stdout=out, stderr=subprocess.STDOUT),
                          log_path, time.perf_counter())

    script = os.path.join(ROOT, "scripts_gpu", "typicality.sh")
    env_b, counts_b = env_for("script")
    env_c, counts_c = env_for("mesh", MESH_DP="1")
    env_d, counts_d = env_for("direct")
    direct_tree = os.path.join(work, "direct", "tree")

    def sweep_done(counts):
        return any(r["argv"][:2] == SWEEP_ARGV for r in count_files(counts))

    t0 = time.perf_counter()
    start("script", ["bash", script, "cars", pipeline_dir, data, "4"], os.path.join(work, "b"), env_b)
    start("mesh", ["bash", script, "cars", pipeline_dir, data, "4"], os.path.join(work, "c"), env_c)
    wall, failed, printed, later = {}, [], {}, True
    try:
        while len(wall) < len(procs):
            if later and sweep_done(counts_b) and sweep_done(counts_c):
                # the scripts' sweeps are done: the direct command's sweep, (a) and (d) beside their mining stages
                later = False
                start("direct", [os.path.join(bin_dir, "python"), *SWEEP_ARGV, "--typicality_path", direct_tree,
                                 "-i", data, "-m", pipeline_dir, "--submission_path",
                                 os.path.join(work, "direct", "subs"), "--make_submission", "--sub_split", "1",
                                 "--which", "cars", "--t_min", "0.1", "--t_max", "0.7", "--device", "cuda"],
                      os.path.join(work, "direct"), env_d)
                start("example", [sys.executable, os.path.join(ROOT, "examples", "run_tiny_pipeline_torch.py"),
                                  os.path.join(work, "example")], work, dict(os.environ, PYTHONPATH=ROOT))
                start("convert", [sys.executable, os.path.join(ROOT, "scripts_gpu", "convert_models.py"),
                                  pipeline_dir, os.path.join(work, "converted")], work, dict(os.environ, PYTHONPATH=ROOT))
            for tag, (p, log_path, t) in list(procs.items()):
                if tag not in wall and p.poll() is not None:
                    wall[tag] = time.perf_counter() - t
                    if p.returncode != 0:
                        failed.append(tag)
            if time.perf_counter() - t0 > 900:
                raise AssertionError(f"surface: {sorted(set(procs) - set(wall))} still running after 900 s")
            time.sleep(0.2)
    finally:
        for p, _, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for tag, (_, log_path, _) in procs.items():
        with open(log_path) as f:
            text = f.read()
        if tag in failed:
            raise AssertionError(f"surface {tag}: exited {procs[tag][0].returncode}: {text[-3000:]}")
        printed[tag] = text
    together_s = time.perf_counter() - t0

    # (a) the tiny example: every stage printed, its outputs on disk
    ex_out, ex_root = printed["example"], os.path.join(work, "example")
    stages = re.findall(r"^\[(\d)\] ", ex_out, re.M)
    ex_files = ["typicality/1930/img_1930_0.npy", "cache/clusters/1930.pkl", "html/index.html",
                "figures/ft/0.1-0.7/clusters/1930_ranked.png", "doersch/ftt/1930/top_42_50_6_hog_final.png",
                "translated/France/projected--France__a1_0.jpg", "pcache/clusters/all.pkl",
                "clip_cache/diff/figures/France.png", "clip_cache/diff/figures/Japan.png"]
    missing = [p for p in ex_files if not os.path.isfile(os.path.join(ex_root, p))]
    if stages != [str(i) for i in range(9)] or missing:
        raise AssertionError(f"surface (a): stages {stages}, missing {missing}")
    a = np.load(os.path.join(ex_root, ex_files[0]))
    if a.shape != (8, 2, 4, 16, 16) or a.dtype != np.float16 or not np.isfinite(a.astype(np.float32)).all():
        raise AssertionError(f"surface (a): artifact {a.shape} {a.dtype}")
    log(f"surface (a): examples/run_tiny_pipeline_torch.py on the card, all nine stages in one process, "
        f"{wall['example']:.1f} s; its files present")

    # (b) the script's tree against the direct command's, and its launches
    names = sorted(meta)

    def tree_of(root):
        out = {}
        for name in names:
            decade = str(meta[name]["year"] // 10 * 10)
            out[name] = np.load(os.path.join(root, decade, name.replace(".png", ".npy")))
        return out

    res_b = os.path.join(work, "b", "results", "cars")
    typ = os.path.join("typicality", "ft", "0.1-0.7")
    got_b, got_d = tree_of(os.path.join(res_b, typ)), tree_of(direct_tree)
    got_c = tree_of(os.path.join(work, "c", "results", "cars", typ))
    bad = [n for n, x in got_b.items() if x.shape != (N, 2, 4, 32, widths[n] // 8) or x.dtype != np.float16
           or not np.isfinite(x.astype(np.float32)).all()]
    differ_d = [n for n in names if not np.array_equal(got_b[n], got_d[n])]
    differ_c = [n for n in names if not np.array_equal(got_b[n], got_c[n])]
    outputs = [os.path.join(res_b, "cache", "ft", "0.1-0.7", "clusters", f"{d}.pkl") for d in CARS_DECADES] + [
        os.path.join(res_b, "figures", "ft", "0.1-0.7", "clusters", f"{d}_ranked.png") for d in CARS_DECADES] + [
        os.path.join(res_b, "html", "index.html")]
    absent = [p for p in outputs if not os.path.isfile(p)]
    ranked = os.path.join(res_b, "cache", "ft", "0.1-0.7", "images", "clusters", "ranked", "dift-161")
    sizes = {d: sorted(collections.Counter(f.split("-")[0] for f in os.listdir(os.path.join(ranked, d))).values(),
                       reverse=True) for d in CARS_DECADES if os.path.isdir(os.path.join(ranked, d))}
    if bad or differ_d or differ_c or absent or "skipping pt mode" not in printed["script"]:
        raise AssertionError(f"surface (b)/(c): artifacts not [100, 2, 4, 32, W/8] finite fp16: {bad[:4]}; not "
                             f"bit-equal to the direct command: {differ_d[:4]}; the MESH_DP=1 run not bit-equal: "
                             f"{differ_c[:4]}; missing {absent}")

    def sweep_of(counts, torchrun):
        runs = [r for r in count_files(counts) if r["argv"][:2] == SWEEP_ARGV]
        if len(runs) != 1 or runs[0]["torchrun"] != torchrun:
            raise AssertionError(f"surface: sweep processes {runs}")
        return runs[0]

    sweep_b, sweep_d, sweep_c = sweep_of(counts_b, False), sweep_of(counts_d, False), sweep_of(counts_c, True)
    passes = groups * N
    for tag, r in (("script", sweep_b), ("direct", sweep_d), ("MESH_DP=1", sweep_c)):
        others = {k: v for k, v in r["launches"].items() if k != "flash_fwd_online" and v}
        if r["launches"].get("flash_fwd_online") != 5 * passes or others:
            raise AssertionError(f"surface {tag}: launches {r['launches']}, expected 5 K3 x {passes} UNet passes")
    if sweep_c["backends"] != ["nccl"] or sweep_b["backends"] or sweep_d["backends"]:
        raise AssertionError(f"surface: process groups {sweep_b['backends']}, {sweep_d['backends']}, "
                             f"{sweep_c['backends']}")
    script_runs = count_files(counts_b)
    k3_script = sum(r["launches"].get("flash_fwd_online", 0) for r in script_runs)
    k3_dift = k3_script - sweep_b["launches"]["flash_fwd_online"]
    def stage(r):
        return r["argv"][1] + (" --cluster" if "--cluster" in r["argv"] else "") + (
            " --figure_path" if "--figure_path" in r["argv"] else "")

    by_module = {stage(r): r["launches"] for r in script_runs}
    stage_s = {tag: {stage(r): r["ended"] - r["started"] for r in count_files(c)}
               for tag, c in (("script", counts_b), ("mesh", counts_c), ("direct", counts_d))}
    rates = re.findall(r"typicality: (\d+)/(\d+) images \(([\d,.]+) imgs/hr\)", printed["script"])
    log(f"surface (b): scripts_gpu/typicality.sh cars over {len(names)} images ({groups} full groups of 8, N={N}): "
        f"{wall['script']:.1f} s of script beside (c), then the direct command, (a) and (d); artifacts "
        f"[100, 2, 4, 32, W/8] fp16 finite, bit-equal to the direct command's ({wall['direct']:.1f} s); K3 "
        f"launched {sweep_b['launches']['flash_fwd_online']} times in the sweep = 5 x {passes} UNet passes, "
        f"{k3_dift} more in the cluster stage's DIFT passes; launches by process {by_module}; cluster pickles, "
        f"figures and index.html written; members a cluster, by decade {sizes}")
    log(f"surface (b): seconds a process (script, MESH_DP=1, direct; side by side): {stage_s}; the script's "
        f"sweep's last progress line {rates[-1] if rates else None}")
    log(f"surface (c): MESH_DP=1, the sweep under torchrun (an NCCL group of one: {sweep_c['backends']}), "
        f"{wall['mesh']:.1f} s of script; every artifact bit-equal to (b)'s")

    # (d) the conversion
    conv = printed["convert"]
    if "verify_checkpoint: PASS" not in conv or re.search(r"\] FAIL", conv):
        raise AssertionError(f"surface (d): {conv[-2000:]}")
    log(f"surface (d): scripts_gpu/convert_models.py on phase 12's export: verify_checkpoint PASS on the card, "
        f"{wall['convert']:.1f} s")
    shutil.rmtree(os.path.join(work, "converted"), ignore_errors=True)

    # (e) K3 at the sweep's batch shapes
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 42)
    k3 = {f"cars L{32 * w // 8} D40": k3_case(g, f"cars L{32 * w // 8} D40", 16, 8, 32 * w // 8, 40)
          for _h, w, _n in CARS_SHAPES}
    log(f"surface: (a)-(d) and the direct command together {together_s:.1f} s, on {smi}")
    return dict(images=len(names), groups=groups, N=N, k3_sweep_launches=sweep_b["launches"]["flash_fwd_online"],
                k3_dift_launches=k3_dift, k3_script_launches=k3_script, launches_by_process=by_module,
                mesh_k3_launches=sweep_c["launches"]["flash_fwd_online"],
                direct_k3_launches=sweep_d["launches"]["flash_fwd_online"], bit_equal_direct=len(names),
                bit_equal_mesh=len(names), wall_s=wall, stage_s=stage_s, together_s=together_s, kernels=k3, card=smi)


TRAIN_KERNELS = {
    "K4": ("flash_fwd_lse", "diffmining_tpu_torch/csrc/flash_fwd_lse.cu",
           "diffmining_tpu/ops/flash_attention.py:37 (_flash_kernel, via _flash_forward(return_lse=True) :142)"),
    "K5": ("flash_bwd_dq", "diffmining_tpu_torch/csrc/flash_bwd_dq.cu",
           "diffmining_tpu/ops/flash_attention.py:573 (_bwd_dq_kernel, via _bwd_pallas :659)"),
    "K6": ("flash_bwd_dkv", "diffmining_tpu_torch/csrc/flash_bwd_dkv.cu",
           "diffmining_tpu/ops/flash_attention.py:609 (_bwd_dkv_kernel, via _bwd_pallas :659)"),
}
INFERENCE_KERNELS = {  # kind: (wrapper, source, the TPU kernel, the main shape)
    "K3": ("flash_fwd_online", "diffmining_tpu_torch/csrc/flash_fwd_online.cu",
           "diffmining_tpu/ops/flash_attention.py:199 (_flash_kernel_t, via _flash_forward_t :417; in "
           "flash_fwd_online_cm's layout via _flash_forward_cbl :517)", "L4096 D40"),
    "K7": ("gn_act_proj", "diffmining_tpu_torch/csrc/gn_act_proj.cu",
           "diffmining_tpu/ops/fused_norm.py:27 (_gn_act_matmul_kernel, via gn_act_proj :44)", "N4096 C320"),
}


CMAJOR_KERNELS = {  # kind: (wrapper, source, the TPU kernel, the main shape)
    "K1 cm": ("flash_fwd_nomax_cm", "flash_fwd_nomax",
              "diffmining_tpu/ops/flash_attention.py:290 (_flash_kernel_t_1shot, via _flash_forward_cbl :499)",
              "L4096 D40"),
    "K3 cm": ("flash_fwd_online_cm", "flash_fwd_online",
              "diffmining_tpu/ops/flash_attention.py:199 (_flash_kernel_t, via _flash_forward_cbl :517)",
              "L16384 D40"),
    "K1/K2 fp32 cm": ("flash_fwd_nomax_cm_f32", "flash_fwd_f32",
                      "diffmining_tpu/ops/flash_attention.py:290 (_flash_kernel_t_1shot at float32, via "
                      "_flash_forward_cbl :499)", "L4096 D40"),
    "K3 fp32 cm": ("flash_fwd_online_cm_f32", "flash_fwd_f32",
                   "diffmining_tpu/ops/flash_attention.py:199 (_flash_kernel_t at float32, via _flash_forward_cbl "
                   ":517)", "L16384 D40"),
}


F32_KERNELS = {  # mode: (wrapper, source, the TPU kernel, the main shape)
    "online": ("flash_fwd_online_f32", "flash_fwd_f32",
               "diffmining_tpu/ops/flash_attention.py:199 (_flash_kernel_t at float32, via _flash_forward_t :417; in "
               "flash_fwd_online_cm_f32's layout via _flash_forward_cbl :517)", "L1025 D64"),
    "nomax": ("flash_fwd_nomax_f32", "flash_fwd_f32",
              "diffmining_tpu/ops/flash_attention.py:250 (_flash_kernel_t_nomax at float32, via _flash_forward_t "
              ":417); diffmining_tpu/ops/flash_attention.py:290 (_flash_kernel_t_1shot at float32, via "
              "_flash_forward_t :382; in flash_fwd_nomax_cm_f32's layout via _flash_forward_cbl :499)", "L4096 D40"),
    "lse": ("flash_fwd_lse_f32", "flash_fwd_f32",
            "diffmining_tpu/ops/flash_attention.py:37 (_flash_kernel at float32, via _flash_forward(return_lse=True) "
            ":142)", "L4096 D40"),
    "K5": ("flash_bwd_dq_f32", "flash_bwd_dq_f32",
           "diffmining_tpu/ops/flash_attention.py:573 (_bwd_dq_kernel at float32, via _bwd_pallas :659)", "L4096 D40"),
    "K6": ("flash_bwd_dkv_f32", "flash_bwd_dkv_f32",
           "diffmining_tpu/ops/flash_attention.py:609 (_bwd_dkv_kernel at float32, via _bwd_pallas :659)", "L4096 D40"),
    "K7": ("gn_act_proj_f32", "gn_act_proj_f32",
           "diffmining_tpu/ops/fused_norm.py:27 (_gn_act_matmul_kernel at float32, via gn_act_proj :44)",
           "N4096 C320"),
}


# Phase 23's pass under DIFFMINING_ATTN_BACKEND=pallas, a process of its own
# (the variable is read when ops/attention.py is imported). argv: OUT. One
# 512px UNet pass at batch 2 in each world on phase 23's weights and inputs;
# writes to OUT each world's launches by wrapper and to OUT.eps{0,1}.pt its
# eps.
CMAJOR_PALLAS = r"""
import json, os, sys
import torch
import chip_smoke as s
from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as fa
out = sys.argv[1]
assert pattn.get_attention_backend() == "pallas", pattn.get_attention_backend()
unet = s.cmajor_unet(torch.bfloat16)
x, t, ctx = s.cmajor_inputs(2, 512, s.SEED + 231)
res = {}
for world in ("0", "1"):
    os.environ["DIFFMINING_TF_CMAJOR"] = world
    for k in s.CM_WRAPPERS + s.SEQ_WRAPPERS:
        setattr(getattr(fa, k), "launches", 0)
    copies = fa.flash_fwd_nomax_cm.copies
    with torch.inference_mode():
        eps = unet(x, t, ctx)
    torch.cuda.synchronize()
    res[world] = {k: getattr(fa, k).launches for k in s.CM_WRAPPERS + s.SEQ_WRAPPERS}
    res[world]["cm_copies"] = fa.flash_fwd_nomax_cm.copies - copies
    torch.save(eps.float().cpu(), f"{out}.eps{world}.pt")
with open(out, "w") as f:
    json.dump(res, f)
"""
# the channel-major wrappers and the sequence-major forwards they stand beside
CM_WRAPPERS = ["flash_fwd_nomax_cm", "flash_fwd_online_cm", "flash_fwd_nomax_cm_f32", "flash_fwd_online_cm_f32"]
SEQ_WRAPPERS = ["flash_fwd_nomax", "flash_fwd_online", "flash_fwd_lse", "flash_fwd_nomax_f32", "flash_fwd_online_f32",
                "flash_fwd_lse_f32", "flash_bwd_dq", "flash_bwd_dkv"]
# phase 23 (a): (kernel, shape name, (B, H, L, D), float32) at the channel-
# major world's shapes: the 512px pass (K1 at L4096 D40 and L1024 D80, batch
# 16), the 1024px pass (K1 at L4096 D80 and L1024 D160, K3 at L16384 D40,
# X-ray's batch 24; K3 at batch 2), the masked tails (L1000 routes to K1,
# L1100 to K3, whose bf16 length is no whole number of 16-byte chunks: a
# padded copy), and the float32 modes
CMAJOR_CASES = [
    ("K1 cm", "L4096 D40", (16, 8, 4096, 40), False),
    ("K1 cm", "L1024 D80", (16, 8, 1024, 80), False),
    ("K1 cm", "1024px L4096 D80", (24, 8, 4096, 80), False),
    ("K1 cm", "1024px L1024 D160", (24, 8, 1024, 160), False),
    ("K1 cm", "masked tail L1000 D40", (2, 8, 1000, 40), False),
    ("K1 cm", "misaligned tail L1100 D160", (2, 8, 1100, 160), False),
    ("K3 cm", "L16384 D40", (2, 8, 16384, 40), False),
    ("K3 cm", "1024px L16384 D40", (24, 8, 16384, 40), False),
    ("K3 cm", "masked tail L1000 D40", (2, 8, 1000, 40), False),
    ("K3 cm", "misaligned tail L1100 D160", (2, 8, 1100, 160), False),
    ("K1/K2 fp32 cm", "L4096 D40", (4, 8, 4096, 40), True),
    ("K1/K2 fp32 cm", "L1024 D80", (4, 8, 1024, 80), True),
    ("K3 fp32 cm", "L16384 D40", (1, 8, 16384, 40), True),
]
# the wrapper each kind goes through and its sequence-major twin
CMAJOR_KINDS = {
    "K1 cm": ("flash_fwd_nomax_cm", "flash_fwd_nomax"),
    "K3 cm": ("flash_fwd_online_cm", "flash_fwd_online"),
    "K1/K2 fp32 cm": ("flash_fwd_nomax_cm", "flash_fwd_nomax"),
    "K3 fp32 cm": ("flash_fwd_online_cm", "flash_fwd_online"),
}
# sdpa on the channel-major views takes PyTorch's math path (its fused
# kernels want the head dim contiguous), which holds B H L^2 float32 weights:
# above this many bytes of them the library is timed on head-dim-contiguous
# copies instead
SDPA_VIEW_BYTES = 9e9


def cmajor_unet(dtype):
    """Phase 23's SD-v1.5-width UNet: random weights drawn on the card from a
    generator seeded with SEED + 23, in ``dtype``; the same in every process
    on a card."""
    import torch

    from diffmining_tpu_torch.models.unet import SD15_UNET, UNet2DCondition
    from diffmining_tpu_torch.typicality.compute import init_random_

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 23)
    with torch.device("cuda"):
        unet = UNet2DCondition(SD15_UNET)
    init_random_(unet, g)
    return unet.to(dtype).eval()


def cmajor_inputs(b, px, seed):
    """Seeded x [b, 4, px/8, px/8], t [b] and a context [b, 77, 768]."""
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn(b, 4, px // 8, px // 8, generator=g, device="cuda")
    t = torch.randint(100, 900, (b,), generator=g, device="cuda")
    return x, t, torch.randn(b, 77, 768, generator=g, device="cuda")


def cm_operands(g, b, h, l, d, dtype, layout):
    """q, k, v as [B, H, L, D] views with L stride 1: of [B, H*D, L] tensors
    ("bcl", the port's channel-major world) or of [H*D, B, L] ones ("cbl",
    the JAX package's)."""
    import torch

    out = []
    for _ in range(3):
        if layout == "bcl":
            x = torch.randn(b, h * d, l, generator=g, device="cuda").to(dtype)
            out.append(x.unflatten(1, (h, d)).transpose(2, 3))
        else:
            x = torch.randn(h * d, b, l, generator=g, device="cuda").to(dtype)
            out.append(x.view(h, d, b, l).permute(2, 0, 3, 1))
    return out


@contextlib.contextmanager
def environ(**values):
    """os.environ with ``values`` set, restored on exit."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cm_case(kind, name, shape, f32, layout, g, timing):
    """One channel-major kernel case of phase 23 (a): the kernel against its
    plain version under the kernel's existing bound (K1 the p-flip rule, K3
    one bf16 ulp at its key tiles, float32 2^-14 |plain| + 2^-14 rms), and
    against its sequence-major twin on head-dim-contiguous copies; with
    ``timing``, the kernel's event ms, its and the twin's device ms (CUDA
    events around calls queued behind a spin kernel, ``queued_device_ms``:
    no profiler set-up a case), the plain version's ms, sdpa's event ms (on
    the views, or on copies where its math path would not fit) and the
    bound; without, the plain version on the first image only. Returns (the numbers, a failure or
    None). These launches are not the main path's."""
    import torch
    import torch.nn.functional as F

    from diffmining_tpu_torch.ops import flash_attention as fa

    wrapper, seq_name = CMAJOR_KINDS[kind]
    fn, seq = getattr(fa, wrapper), getattr(fa, seq_name)
    b, h, l, d = shape
    q, k, v = cm_operands(g, b, h, l, d, torch.float32 if f32 else torch.bfloat16, layout)
    copies = sum(getattr(fa, w).copies for w in CM_WRAPPERS)
    got = fn(q, k, v)
    copies = sum(getattr(fa, w).copies for w in CM_WRAPPERS) - copies
    online = kind.startswith("K3")
    if online:
        block = fa.F32_BLOCK_K if f32 else fa.ONLINE_BLOCK_K

        def plain(*ts):
            return fa.flash_fwd_online_plain(*ts, block_k=block)
    else:
        plain = fa.flash_attention_nomax_plain
    # at batch 24 and L 16384 (and in the second layout) the plain version
    # holds the first image's heads only
    part = 1 if b * l >= 24 * 16384 or not timing else b
    a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    want = plain_chunked(plain, q[:part], k[:part], v[:part])
    e.record()
    e.synchronize()
    plain_ms = a.elapsed_time(e) * b / part
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    seq_out = seq(qc, kc, vc)
    seq_diff = float((got.float() - seq_out.float()).abs().max())
    flip = None
    if f32:
        max_err, worst = f32_error(got[:part], want)
        check = worst
    else:
        max_err, worst = kernel_error(got[:part], want)
        check = worst
        if not online:
            flip = p_flip_ratio(got[:part], want, q[:part], k[:part], v[:part])
            check = flip
    failed = None
    if check > 1.0 or not torch.isfinite(got).all():
        failed = f"{kind} {name} ({layout}): {check:.3g} x its bound (max |err| {max_err:.3g})"
    out = dict(shape=list(shape), layout=layout, max_abs_err=max_err, err_over_tol=worst,
               max_abs_vs_sequence_major=seq_diff, bit_equal_to_sequence_major=seq_diff == 0.0, copies=copies,
               plain_heads=part * h)
    if flip is not None:
        out["err_over_p_flip_tol"] = flip
    del want, seq_out
    if timing:
        ms = cuda_time_ms(lambda: fn(q, k, v), reps=3, warmup=1)
        device_ms = queued_device_ms(lambda: fn(q, k, v))
        seq_device_ms = queued_device_ms(lambda: seq(qc, kc, vc))
        on_views = b * h * l * l * 4 <= SDPA_VIEW_BYTES
        lq, lk, lv = (q, k, v) if on_views else (qc, kc, vc)
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(lq, lk, lv), reps=3, warmup=1)
        if f32:
            bound, by = f32_attention_bound(b, h, l, l, d)
        elif online:
            bound, by, _ = training_bound("K3", b, h, l, d)
        else:
            bound, by, _ = attention_bound(b, h, l, l, d)
        out.update(ms=ms, device_ms=device_ms, sequence_major_device_ms=seq_device_ms, plain_ms=plain_ms,
                   library_ms=lib_ms, library="sdpa forward" + ("" if on_views else " on head-dim-contiguous copies")
                   + (" (float32, TF32 off)" if f32 else ""), bound_ms=bound, bound_by=by)
    log(f"cmajor (a) {kind} {name} B{b} H{h} {layout}: max|err| {max_err:.3g} = {worst:.3g} x tolerance"
        + ("" if flip is None else f" ({flip:.3g} x the p-flip one)")
        + f"; vs the sequence-major kernel " + ("bit-equal" if seq_diff == 0.0 else f"max |d| {seq_diff:.3g}")
        + f"; {copies} copies" + ("" if part == b else f"; plain on {part * h} of {b * h} heads")
        + (f"; ms {out['ms']:.4f} device {fmt(out['device_ms'])} (the sequence-major kernel "
           f"{fmt(out['sequence_major_device_ms'])}) plain {plain_ms:.2f} sdpa {out['library_ms']:.4f}"
           f"{'' if on_views else ' on copies'} bound {out['bound_ms']:.4f} ({out['bound_by']})" if timing else ""))
    del q, k, v, qc, kc, vc, got
    torch.cuda.empty_cache()
    return out, failed


def cmajor_sweep(pipeline_dir):
    """Phase 20's images and plain bf16 typicality tree, made alone, for
    phase 23 run without phase 20: ``p = s.sd15_pipeline_dir();
    s.phase_cmajor(smi, p, s.cmajor_sweep(p))``."""
    import numpy as np
    from PIL import Image

    labels, per_label, px, N, batch_images = ["1920", "1960"], 4, 512, 4, 4
    work = os.path.join(ROOT, "build", "chip_smoke_sweep_dp")
    shutil.rmtree(work, ignore_errors=True)
    data, tree = os.path.join(work, "ftt"), os.path.join(work, "plain_bf16")
    rng = np.random.RandomState(SEED + 31)
    for c in labels:
        os.makedirs(os.path.join(data, c))
        for i in range(per_label):
            Image.fromarray(rng.randint(0, 256, (px, px, 3), dtype=np.uint8)).save(
                os.path.join(data, c, f"{c}_{i}.png"), compress_level=1)
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(SWEEP_DP_RANK)
    subprocess.run([sys.executable, script, os.path.join(work, "plain_bf16.json"), "cli", "--which", "ftt", "-i", data,
                    "-c", tree, "-s", os.path.join(work, "plain_bf16_subs"), "-m", pipeline_dir, "--make_submission",
                    "--N", str(N), "--batch_images", str(batch_images), "--dtype", "bf16"],
                   cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), check=True, timeout=600)
    return dict(work=work, data=data, tree=tree, N=N, batch_images=batch_images)


def phase_cmajor(smi, pipeline_dir, sweep):
    """Phase 23, the channel-major transformer world (DIFFMINING_TF_CMAJOR=1)
    at SD-v1.5 widths, on phase 12's export and phase 20's images and plain
    bf16 tree (``sweep``). (a) Each channel-major kernel against its plain
    version and its sequence-major twin at the world's shapes, in both
    layouts; times on the [B, H*D, L] one. (b) One 512px UNet pass at batch
    16 in bf16 in the channel-major world against the normal world and a
    float32 normal-world pass through the plain attention, with its launches
    by route; the same in float32 at batch 8 (and under
    DIFFMINING_FLASH_ONESHOT=0, the float32 K3); the passes' times side by
    side. (c) One forward and backward at batch 2, bf16 autocast, in the
    channel-major world: K4, K5 and K6 10 times each, the level-0 attn1
    projections' gradients against the float32 normal world's. (d) The
    typicality CLI in bf16 under DIFFMINING_TF_CMAJOR=1 and under
    DIFFMINING_SWEEP_DEDUP=0 (two processes) against phase 20's plain run.
    (e) One 1024px pass at batch 2 in the channel-major world: 5 K3 cm and
    10 K1 cm launches. (f) One pass in each world under
    DIFFMINING_ATTN_BACKEND=pallas (a process) against the same pass under
    auto. The processes of (d) and (f) run beside (a)'s checks, (c) and (e);
    every time is read after they end."""
    from diffmining_tpu_torch.utils.device import exact_float32

    t0 = time.perf_counter()
    exact_float32()
    work = sweep["work"]
    env = dict(os.environ, PYTHONPATH=ROOT)
    names = sorted(os.path.relpath(p, sweep["tree"]) for p in glob.glob(os.path.join(sweep["tree"], "*", "*.npy")))
    procs = {}
    for tag, extra in (("cmajor_bf16", {"DIFFMINING_TF_CMAJOR": "1"}),
                       ("nodedup_bf16", {"DIFFMINING_SWEEP_DEDUP": "0"})):
        out = os.path.join(work, f"{tag}.json")
        args = ["--which", "ftt", "-i", sweep["data"], "-c", os.path.join(work, tag), "-s",
                os.path.join(work, f"{tag}_subs"), "-m", pipeline_dir, "--make_submission", "--N", str(sweep["N"]),
                "--batch_images", str(sweep["batch_images"]), "--dtype", "bf16"]
        procs[tag] = (subprocess.Popen([sys.executable, os.path.join(work, "rank.py"), out, "cli", *args], cwd=ROOT,
                                       env={**env, **extra}), out)
    script = os.path.join(work, "cmajor_pallas.py")
    with open(script, "w") as f:
        f.write(CMAJOR_PALLAS)
    out = os.path.join(work, "pallas.json")
    procs["pallas"] = (subprocess.Popen([sys.executable, script, out], cwd=ROOT,
                                        env={**env, "DIFFMINING_ATTN_BACKEND": "pallas"}), out)
    try:
        return _phase_cmajor(smi, procs, names, sweep, t0)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def _phase_cmajor(smi, procs, names, sweep, t0):
    import numpy as np
    import torch

    from diffmining_tpu_torch.ops import attention as pattn
    from diffmining_tpu_torch.ops import flash_attention as fa

    def counts():
        return {w: getattr(fa, w).launches for w in CM_WRAPPERS + SEQ_WRAPPERS}

    def zero():
        for w in CM_WRAPPERS + SEQ_WRAPPERS:
            getattr(fa, w).launches = 0

    def launched(c):
        return {w: n for w, n in c.items() if n}

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 23)
    failed, cases = [], {}
    # (a) correctness in the JAX package's layout now; both layouts' times later
    for kind, name, shape, f32 in CMAJOR_CASES:
        _, fail = cm_case(kind, name, shape, f32, "cbl", g, timing=False)
        failed += [fail] if fail else []
    log(f"[cmajor (a) in the JAX layout: {time.perf_counter() - t0:.1f} s]")

    unet16, unet32 = cmajor_unet(torch.bfloat16), cmajor_unet(torch.float32)
    x, t, ctx = cmajor_inputs(16, 512, SEED + 230)
    world = {"0": dict(DIFFMINING_TF_CMAJOR="0"), "1": dict(DIFFMINING_TF_CMAJOR="1")}
    res = {}
    with torch.inference_mode():
        # (b) the float32 reference: the normal world, the plain attention
        pattn.set_attention_backend("xla")
        try:
            with environ(**world["0"]):
                ref32 = unet32(x, t, ctx).float()
        finally:
            pattn.set_attention_backend("auto")
        copies = fa.flash_fwd_nomax_cm.copies
        zero()
        with environ(**world["1"]):
            eps_cm = unet16(x, t, ctx).float()
        torch.cuda.synchronize()
        pass_cm = counts()
        cm_copies = fa.flash_fwd_nomax_cm.copies - copies
        zero()
        with environ(**world["0"]):
            eps_n = unet16(x, t, ctx).float()
        pass_n = counts()
        rel_cm, rel_n, rel_cm_n = rel_l2(eps_cm, ref32), rel_l2(eps_n, ref32), rel_l2(eps_cm, eps_n)
        if launched(pass_cm) != {"flash_fwd_nomax_cm": 10} or cm_copies or launched(pass_n) != {
                "flash_fwd_nomax": 10} or not (torch.isfinite(eps_cm).all() and rel_cm < UNET_REL_L2):
            failed.append(f"cmajor (b): launches {launched(pass_cm)} ({cm_copies} copies), normal world "
                          f"{launched(pass_n)}, relative L2 {rel_cm} against the float32 plain pass")
        log(f"cmajor (b): 512px UNet pass, batch 16, bf16: channel-major world launches {launched(pass_cm)} "
            f"({cm_copies} copies), normal world {launched(pass_n)}; relative L2 against the float32 normal world "
            f"through the plain attention: channel-major {rel_cm:.4g}, normal {rel_n:.4g} (limit {UNET_REL_L2}); "
            f"the two worlds {rel_cm_n:.4g} apart")
        res["bf16_pass"] = dict(batch=16, launches=launched(pass_cm), normal_launches=launched(pass_n),
                                copies=cm_copies, rel_l2_vs_f32=rel_cm, normal_rel_l2_vs_f32=rel_n,
                                rel_l2_cm_vs_normal=rel_cm_n)
        del eps_cm, eps_n
        x8, t8, ctx8 = x[:8], t[:8], ctx[:8]
        ref8 = ref32[:8]
        res["f32_pass"] = {}
        for tag, oneshot, want in (("default", fa._ONESHOT, "flash_fwd_nomax_cm_f32"),
                                   ("DIFFMINING_FLASH_ONESHOT=0", "0", "flash_fwd_online_cm_f32")):
            saved = fa._ONESHOT
            fa._ONESHOT = oneshot
            try:
                zero()
                with environ(**world["1"]):
                    eps = unet32(x8, t8, ctx8)
                c = counts()
            finally:
                fa._ONESHOT = saved
            rel = rel_l2(eps, ref8)
            if launched(c) != {want: 10} or not rel < UNET_F32_REL_L2:
                failed.append(f"cmajor (b) float32 {tag}: launches {launched(c)}, relative L2 {rel}")
            log(f"cmajor (b): the same pass in float32 at batch 8 ({tag}): launches {launched(c)}; relative L2 "
                f"{rel:.3g} against the plain attention (limit {UNET_F32_REL_L2})")
            res["f32_pass"][tag] = dict(batch=8, launches=launched(c), rel_l2_vs_plain=rel)
        del ref32, ref8

    # (c) forward and backward at batch 2, bf16 autocast, in the channel-major world
    blk = unet32.down_blocks[0].attentions[0].transformer_blocks[0].attn1
    params = [blk.to_q.weight, blk.to_k.weight, blk.to_v.weight]
    unet32.requires_grad_(False)
    for p in params:
        p.requires_grad_(True)
    gt = torch.Generator(device="cuda")
    gt.manual_seed(SEED + 232)
    target = torch.randn(2, 4, 64, 64, generator=gt, device="cuda")

    def grads(autocast, backend):
        for p in params:
            p.grad = None
        pattn.set_attention_backend(backend)
        try:
            with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
                eps = unet32(x[:2], t[:2], ctx[:2])
            torch.nn.functional.mse_loss(eps.float(), target).backward()
        finally:
            pattn.set_attention_backend("auto")
        return torch.cat([p.grad.flatten() for p in params])

    with environ(**world["0"]):
        want = grads(False, "xla")
    zero()
    with environ(**world["1"]):
        got = grads(True, "auto")
    c = counts()
    unet32.requires_grad_(False)
    rel = rel_l2(got, want)
    if launched(c) != {"flash_fwd_lse": 10, "flash_bwd_dq": 10, "flash_bwd_dkv": 10} or not rel < GRAD_REL_L2:
        failed.append(f"cmajor (c): launches {launched(c)}, gradient relative L2 {rel}")
    log(f"cmajor (c): forward and backward at batch 2, 512px, bf16 autocast, channel-major world: launches "
        f"{launched(c)}; level-0 attn1 to_q/to_k/to_v gradients {rel:.4g} from the float32 normal world's (limit "
        f"{GRAD_REL_L2})")
    res["train_step"] = dict(batch=2, launches=launched(c), grad_rel_l2=rel)

    # (e) one 1024px pass at batch 2 in the channel-major world
    x2, t2, ctx2 = cmajor_inputs(2, 1024, SEED + 233)
    with torch.inference_mode():
        zero()
        with environ(**world["1"]):
            eps_cm = unet16(x2, t2, ctx2).float()
        c = counts()
        with environ(**world["0"]):
            eps_n = unet16(x2, t2, ctx2).float()
    rel = rel_l2(eps_cm, eps_n)
    if launched(c) != {"flash_fwd_online_cm": 5, "flash_fwd_nomax_cm": 10} or not (
            torch.isfinite(eps_cm).all() and rel < UNET_REL_L2):
        failed.append(f"cmajor (e): launches {launched(c)}, relative L2 {rel} against the normal world")
    log(f"cmajor (e): 1024px UNet pass, batch 2, channel-major world: launches {launched(c)}; relative L2 {rel:.4g} "
        f"against the normal world (its K2 at L16384)")
    res["pass_1024"] = dict(batch=2, launches=launched(c), rel_l2_vs_normal=rel)
    del eps_cm, eps_n

    # (d) and (f): the processes
    results = {}
    for tag, (p, out) in procs.items():
        p.wait(timeout=900)
        if p.returncode != 0:
            raise AssertionError(f"cmajor: the {tag} process exited {p.returncode}")
        with open(out) as f:
            results[tag] = json.load(f)
    log(f"[cmajor (b), (c), (e) and the processes of (d) and (f): {time.perf_counter() - t0:.1f} s]")
    passes = len({n.split(os.sep)[0] for n in names}) * sweep["N"]  # one group a label, N passes each
    want_tree = {n: np.load(os.path.join(sweep["tree"], n)) for n in names}
    res["cli"] = {}
    for tag, kernel in (("cmajor_bf16", "flash_fwd_nomax_cm"), ("nodedup_bf16", "flash_fwd_nomax")):
        r = results[tag]
        tree = os.path.join(sweep["work"], tag)
        written = sorted(os.path.relpath(p, tree) for p in r["written"])
        got_tree = {n: np.load(os.path.join(tree, n)) for n in names}
        num = sum(float(np.sum((got_tree[n].astype(np.float64) - want_tree[n].astype(np.float64)) ** 2))
                  for n in names)
        den = sum(float(np.sum(want_tree[n].astype(np.float64) ** 2)) for n in names)
        rel = math.sqrt(num / den)
        other = {k: v for k, v in r["launches"].items() if v and k != kernel}
        if written != names or r["launches"][kernel] != 10 * passes or other or not rel < UNET_REL_L2 or not all(
                np.isfinite(a).all() for a in got_tree.values()):
            failed.append(f"cmajor (d) {tag}: wrote {written}, launches {r['launches']}, relative L2 {rel}")
        log(f"cmajor (d): typicality CLI, bf16, {tag}: {len(written)} artifacts, each written once; {kernel} "
            f"launched {r['launches'][kernel]} times ({passes} UNet passes), no other kernel; the artifacts "
            f"{rel:.4g} (relative L2) from phase 20's plain run")
        res["cli"][tag] = dict(written=len(written), launches={k: v for k, v in r["launches"].items() if v},
                               rel_l2_vs_default=rel)

    pal = results["pallas"]
    xp, tp, cp = cmajor_inputs(2, 512, SEED + 231)
    with torch.inference_mode(), environ(**world["0"]):
        eps_auto = unet16(xp, tp, cp).float().cpu()
    res["pallas"] = {}
    want_launch = {"0": {"flash_fwd_nomax": 32}, "1": {"flash_fwd_nomax_cm": 32}}
    for w in ("0", "1"):
        eps = torch.load(os.path.join(sweep["work"], f"pallas.json.eps{w}.pt"))
        rel = rel_l2(eps, eps_auto)
        got = {k: v for k, v in pal[w].items() if v and k != "cm_copies"}
        if got != want_launch[w] or not rel < UNET_REL_L2:
            failed.append(f"cmajor (f) world {w}: launches {got}, relative L2 {rel} against auto")
        log(f"cmajor (f): DIFFMINING_ATTN_BACKEND=pallas, 512px batch 2, {'channel-major' if w == '1' else 'normal'} "
            f"world: launches {got} (16 self- and 16 cross-attentions: every attention of the pass; "
            f"{pal[w]['cm_copies']} padded copies of the 77-key context), relative L2 {rel:.4g} against the normal "
            f"world under auto")
        res["pallas"]["cmajor" if w == "1" else "normal"] = dict(launches=got, copies=pal[w]["cm_copies"],
                                                                  rel_l2_vs_auto=rel)
    for tag in ("cmajor_bf16", "nodedup_bf16"):
        shutil.rmtree(os.path.join(sweep["work"], tag), ignore_errors=True)
    if failed:
        raise AssertionError("; ".join(failed))

    # times, now that the processes have ended: (a) on the [B, H*D, L] layout
    for kind, name, shape, f32 in CMAJOR_CASES:
        r, fail = cm_case(kind, name, shape, f32, "bcl", g, timing=True)
        cases.setdefault(kind, {})[name] = r
        failed += [fail] if fail else []
    log(f"[cmajor (a) with times: {time.perf_counter() - t0:.1f} s]")
    # (b) the passes' times side by side
    passes_ms = {}
    with torch.inference_mode():
        for label, unet, b in (("bf16 batch 16", unet16, 16), ("float32 batch 8", unet32, 8)):
            for w in ("1", "0"):
                with environ(**world[w]):
                    fn = lambda: unet(x[:b], t[:b], ctx[:b])  # noqa: E731
                    ms = cuda_time_ms(fn, reps=3, warmup=1)
                    _, busy, top, part = device_busy(fn, calls=2, parts=("elementwise", "copy", "transpose"))
                passes_ms[f"{label}, {'channel-major' if w == '1' else 'normal'}"] = dict(ms=ms, busy_ms=busy,
                                                                                          top=top)
                log(f"cmajor (b) times: {label}, {'channel-major' if w == '1' else 'normal'} world: pass {ms:.2f} ms, "
                    f"device busy {fmt(busy, '.2f')} ms; top kernels "
                    + "; ".join(f"{n[:60]} {v:.2f} ms" for n, v in top))
    res["pass_ms"] = passes_ms
    del unet16, unet32
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))
    res.update(kernels=cases, wall_s=time.perf_counter() - t0, card=smi)
    log(f"cmajor: phase 23 {res['wall_s']:.1f} s on {smi}")
    return res


def apps_bundle():
    """The SD-v1.5 bundle of phases 9-11: random weights from SEED, bf16."""
    import torch

    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.typicality.compute import SD

    t0 = time.perf_counter()
    sd = SD.init_random("xray", [], SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED, dtype=torch.bfloat16,
                        device="cuda")
    torch.cuda.synchronize()
    log(f"apps: SD-v1.5 widths (UNet, VAE with its decoder, CLIP ViT-L text), random weights (seed {SEED}), bf16, "
        f"built in {time.perf_counter() - t0:.1f} s")
    return sd


def sd15_pipeline_dir():
    """A pipeline dir of SD-v1.5-width random weights from SEED, float32, in
    place of phase 12's export when phases 16, 20 and 21 run alone:
    ``d = s.sd15_pipeline_dir(); sweep = s.phase_sweep_dp(smi, d);
    s.phase_mining_dp(smi, d, sweep)``."""
    import torch

    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.typicality.compute import SD
    from diffmining_tpu_torch.utils.export import save_pipeline_dir

    out = os.path.join(ROOT, "build", "chip_smoke_export")
    shutil.rmtree(out, ignore_errors=True)
    sd = SD.init_random("ftt", [], SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED, dtype=torch.float32, device="cuda")
    save_pipeline_dir(out, sd.unet.config, sd.unet.state_dict(), sd.vae.config, sd.vae.state_dict(), sd.clip.config,
                      sd.clip.state_dict(), sd.schedule)
    del sd
    torch.cuda.empty_cache()
    return out


def geo_bundle():
    """The SD-v1.5 bundle of phases 13-14: random weights from SEED, bf16,
    the geo domain's France and Japan prompts."""
    import torch

    from diffmining_tpu_torch.models.clip import CLIP_VIT_L_TEXT
    from diffmining_tpu_torch.models.unet import SD15_UNET
    from diffmining_tpu_torch.models.vae import SD15_VAE
    from diffmining_tpu_torch.typicality.compute import SD

    return SD.init_random("geo", ["France", "Japan"], SD15_UNET, SD15_VAE, CLIP_VIT_L_TEXT, seed=SEED,
                          dtype=torch.bfloat16, device="cuda")


def kernel_entry(name, source, replaces, launches, cases, main_case):
    """One kernel's entry of the kernels line: the main shape's numbers and
    every shape's beside them."""
    m = cases[main_case]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in cases.values()), "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"], "device_ms": m.get("device_ms"),
            "library_device_ms": m.get("library_device_ms"), "library_ms": m["library_ms"],
            "library": m.get("library", "sdpa forward"), "main_shape": main_case, "shapes": cases}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    import diffmining_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_s, clock = {}, [time.perf_counter()]

    def done(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now
        log(f"[{name}: {phase_s[name]:.1f} s]")

    smi = phase_environment()
    phase_build()
    done("environment and build")
    kern = phase_kernels()
    done("kernels")
    launches, imgs_hr, imgs_hr_100, unet_pass = phase_slice(smi)
    torch.cuda.empty_cache()
    done("slice")
    sweep_f32 = phase_f32_sweep(smi)
    done("f32 sweep")
    train_kern = phase_train_kernels()
    done("training kernels")
    f32_unet = phase_f32_unet_kernels(smi)
    done("f32 UNet kernels")
    train = phase_train(smi)
    done("train")
    train_f32 = phase_train_f32(smi)
    done("train f32")
    infer_kern = phase_inference_kernels(smi)
    done("inference-mode kernels")
    mining = phase_mining(smi)
    mining_work = mining.pop("work")
    done("mining")
    sd = apps_bundle()
    xray = phase_xray(smi, sd)
    done("xray")
    sampling = phase_sampling(smi, sd)
    done("sampling")
    pnp = phase_pnp(smi, sd)
    pnp_work, pnp_out = pnp.pop("work"), pnp.pop("out")
    del sd
    torch.cuda.empty_cache()
    done("pnp")
    lora = phase_train_lora_8bit(smi, train)
    done("train_lora_8bit")
    sd = geo_bundle()
    parallel = phase_parallel(smi, pnp_out, sd)
    done("parallel")
    f32_kern = phase_f32_kernels()
    clip = phase_clip(smi, mining_work, sd)
    del sd
    torch.cuda.empty_cache()
    done("clip")
    doersch = phase_doersch(smi)
    done("doersch")
    export_dir = lora.pop("export_dir")
    verify = phase_verify_checkpoint(smi, export_dir)
    done("verify_checkpoint")
    sweep_dp = phase_sweep_dp(smi, export_dir)
    done("sweep dp")
    cmajor = phase_cmajor(smi, export_dir, sweep_dp)
    done("cmajor")
    mining_dp = phase_mining_dp(smi, export_dir, sweep_dp)
    for k in ("work", "data", "tree"):
        sweep_dp.pop(k)
    done("mining dp")
    train_dp = phase_train_dp(smi, export_dir)
    done("train dp")
    surface = phase_surface(smi, export_dir)
    shutil.rmtree(export_dir, ignore_errors=True)
    done("surface")
    shutil.rmtree(pnp_work, ignore_errors=True)
    shutil.rmtree(mining_work["root"], ignore_errors=True)

    by_path = {"sweep": launches, "xray": xray["launches"], "sampling": sampling["launches"],
               "train preview": train["preview_launches"], "pnp": pnp["launches"], "parallel": parallel["launches"],
               "clip+dift-161": clip["launches"]["flash_fwd_nomax"],
               "sweep dp": sweep_dp["nccl_group_of_one"]["k1_launches"]
               + sweep_dp["xray_nccl_group_of_one"]["launches"],
               "mining dp": mining_dp["nccl_group_of_one"]["k1_launches"]}
    # the sequence-major K1 on phase 23's paths: the sweep with the dedup off
    # and the pass under DIFFMINING_ATTN_BACKEND=pallas
    by_path["cmajor"] = (cmajor["cli"]["nodedup_bf16"]["launches"]["flash_fwd_nomax"]
                         + cmajor["pallas"]["normal"]["launches"]["flash_fwd_nomax"])
    nomax = kernel_entry(
        "flash_fwd_nomax", "diffmining_tpu_torch/csrc/flash_fwd_nomax.cu",
        "diffmining_tpu/ops/flash_attention.py:290 (_flash_kernel_t_1shot, via _flash_forward_t :382 and, in "
        "flash_fwd_nomax_cm's layout, _flash_forward_cbl :499); "
        "diffmining_tpu/ops/flash_attention.py:250 (_flash_kernel_t_nomax, via _flash_forward_t :417)",
        sum(by_path.values()), kern, "K1 L4096 D40")
    nomax["launches_by_path"] = by_path
    entries = [nomax]
    for kind, (name, source, replaces) in TRAIN_KERNELS.items():
        by_train = {"train": train["launches"][name], "train_lora_8bit": lora["launches"][name],
                    "train dp": train_dp["nccl_group_of_one"]["launches"][name]
                    + train_dp["nccl_group_of_one"]["plain_launches"][name]}
        entry = kernel_entry(name, source, replaces, sum(by_train.values()), train_kern[kind], "L4096 D40")
        entry["launches_by_path"] = by_train
        entries.append(entry)
    for kind, (name, source, replaces, main_case) in INFERENCE_KERNELS.items():
        paths = {"mining, modes on": mining["runs"]["modes"]["launches"][name]}
        cases = infer_kern[kind]
        if kind == "K3":  # K3 on a default path: the free-aspect cars sweep through typicality.sh (phase 24)
            paths["typicality.sh cars"] = surface["k3_script_launches"]
            cases = {**cases, **surface["kernels"]}
        entry = kernel_entry(name, source, replaces, sum(paths.values()), cases, main_case)
        entry["launches_by_path"] = paths
        entries.append(entry)
    # the channel-major kernels (phase 23): launches on the world's passes and CLI run
    cm_paths = {
        "flash_fwd_nomax_cm": {"cmajor 512px pass": cmajor["bf16_pass"]["launches"]["flash_fwd_nomax_cm"],
                               "cmajor CLI": cmajor["cli"]["cmajor_bf16"]["launches"]["flash_fwd_nomax_cm"],
                               "cmajor 1024px pass": cmajor["pass_1024"]["launches"]["flash_fwd_nomax_cm"],
                               "cmajor pallas pass": cmajor["pallas"]["cmajor"]["launches"]["flash_fwd_nomax_cm"]},
        "flash_fwd_online_cm": {"cmajor 1024px pass": cmajor["pass_1024"]["launches"]["flash_fwd_online_cm"]},
        "flash_fwd_nomax_cm_f32": {
            "cmajor float32 pass": cmajor["f32_pass"]["default"]["launches"]["flash_fwd_nomax_cm_f32"]},
        "flash_fwd_online_cm_f32": {
            "cmajor float32 pass, DIFFMINING_FLASH_ONESHOT=0":
                cmajor["f32_pass"]["DIFFMINING_FLASH_ONESHOT=0"]["launches"]["flash_fwd_online_cm_f32"]},
    }
    for kind, (name, source, replaces, main_case) in CMAJOR_KERNELS.items():
        entry = kernel_entry(name, f"diffmining_tpu_torch/csrc/{source}.cu", replaces, sum(cm_paths[name].values()),
                             cmajor["kernels"][kind], main_case)
        entry["launches_by_path"] = cm_paths[name]
        entries.append(entry)
    large = clip["large_crops"]
    f32_paths = {
        "online": {"clip crop 448": large["crop448"]["launches"]["flash_fwd_online_f32"]},
        "nomax": {"clip crop 896": large["crop896"]["launches"]["flash_fwd_nomax_f32"],
                  "f32 sweep": sweep_f32["launches"]["flash_fwd_nomax_f32"],
                  "sweep dp": sum(sweep_dp["gloo_dp2_fp32"]["nomax_f32_launches_per_rank"]),
                  "mining dp": sum(mining_dp["gloo_dp2_fp32"]["nomax_f32_launches_per_rank"])},
        "lse": {"train f32": train_f32["launches"]["flash_fwd_lse_f32"],
                "train dp": train_dp["gloo_fp32"]["launches"]["flash_fwd_lse_f32"]},
        "K5": {"train f32": train_f32["launches"]["flash_bwd_dq_f32"],
               "train dp": train_dp["gloo_fp32"]["launches"]["flash_bwd_dq_f32"]},
        "K6": {"train f32": train_f32["launches"]["flash_bwd_dkv_f32"],
               "train dp": train_dp["gloo_fp32"]["launches"]["flash_bwd_dkv_f32"]},
        "K7": {"f32 sweep, DIFFMINING_FUSED_NORM=1 pass": sweep_f32["fused_norm_launches"]},
    }
    for mode, (name, source, replaces, main_case) in F32_KERNELS.items():
        cases = {**f32_kern.get(mode, {}), **f32_unet[mode]}
        entry = kernel_entry(name, f"diffmining_tpu_torch/csrc/{source}.cu", replaces, sum(f32_paths[mode].values()),
                             cases, main_case)
        entry["launches_by_path"] = f32_paths[mode]
        entries.append(entry)
    print(json.dumps({"slice": {"imgs_per_hr_n4": imgs_hr, "imgs_per_hr_n100": imgs_hr_100, **unet_pass,
                                "card": smi}}))
    print(json.dumps({"f32_sweep": sweep_f32}))
    print(json.dumps({"train": train}))
    print(json.dumps({"train_f32": train_f32}))
    print(json.dumps({"mining": mining}))
    print(json.dumps({"xray": xray}))
    print(json.dumps({"sampling": sampling}))
    print(json.dumps({"pnp": pnp}))
    print(json.dumps({"train_lora_8bit": lora}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"clip": clip}))
    print(json.dumps({"doersch": doersch}))
    print(json.dumps({"verify_checkpoint": verify}))
    print(json.dumps({"sweep_dp": sweep_dp}))
    print(json.dumps({"mining_dp": mining_dp}))
    print(json.dumps({"train_dp": train_dp}))
    print(json.dumps({"cmajor": {k: v for k, v in cmajor.items() if k != "kernels"}}))
    print(json.dumps({"surface": {k: v for k, v in surface.items() if k != "kernels"}}))
    print(json.dumps({"phase_s": phase_s}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
