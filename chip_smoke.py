#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing falls
back to the CPU):
  1. environment: versions, the card's name and power limit; TF32 off for
     the float32 references;
  2. build: compile every kernel source in this checkout, one nvcc each, all
     started together; ptxas registers and spills of each instantiation;
  3. kernels: the no-max forward (typicality) against its plain PyTorch
     version at the sweep's shapes, a masked key tail and the underflow
     edge; CUDA-event times of the kernel, the plain version and one PyTorch
     library call (a yardstick only), and the least time the card could take;
  4. slice: SD-v1.5 widths (UNet, VAE, CLIP ViT-L text) with random weights
     from a seed, bf16; make_submission + compute_submission over 2 labels x
     8 synthetic 512x512 images; every artifact checked; kernel launches
     counted over that run; one UNet pass in bf16 with the kernel held
     against the same pass in float32 through the plain attention; imgs/hr
     of that run and of one warm group of 8 images at N=100;
  5. training kernels: K4 (flash forward with logsumexp), K5 (dq) and K6
     (dk/dv) against their plain versions at the trainer's shapes (B4 H8
     L4096 D40, B4 H8 L1024 D80) and masked tails at D=40 and D=160, with
     times, scaled_dot_product_attention's forward (K4) and backward (K5+K6)
     as yardsticks, and the bound;
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
     back; warm step ms, images/s and peak memory.
Then one JSON line each for the slice and the training run, one of
per-kernel numbers, and as the last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
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
# kernel vs plain, elementwise: |got - want| <= RTOL |want| + ATOL_RMS rms(want).
# Both round the same fp32 result to bf16, so they differ by at most one bf16
# ulp of the element (<= 2^-7 relative) where summation order or ex2.approx
# flips a rounding; the atol, one ulp at the output's own scale, is margin
# near zero. A kernel that drops one 64-key tile is off by over 200x this.
# K4 is held to the same bound against its plain version at the kernel's own
# 64-key tiles (so p is rounded relative to the same running max). K5 and K6
# round p and ds to bf16 inside their sums, at the same places as their
# plain versions; where ex2.approx or the summation order flips one of those
# roundings the fp32 sums differ before the final rounding, so they get two
# ulps of the element (a measured worst of 1.03 ulps at B4 H8 L1024 D80). A
# kernel that skips one 64-key tile (or 64 q rows) is over 50x either bound
# (tests/test_torch_port_flash_bwd.py).
KERNEL_RTOL = 2.0**-7
BWD_RTOL = 2.0**-6
KERNEL_ATOL_RMS = 2.0**-7
UNET_REL_L2 = 5e-2
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


def attention_bound(b, h, lq, lk, d):
    """Least time for one call: each input read and the output written once
    over the memory rate, against QK^T + PV on the bf16 tensor cores and the
    float32 per-logit work (exp2 and the denominator add) outside them."""
    nbytes = 2 * (2 * b * h * lq * d + 2 * b * h * lk * d)
    logits = b * h * lq * lk
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_tensor = 4.0 * logits * d / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    t_fp32 = 2.0 * logits / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_tensor, t_fp32)
    return bound, ("bytes" if bound == t_bytes else "operations"), logits


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
    """Least time of one training-kernel call: the bytes it must move (bf16
    [B,H,L,D] operands and fp32 [B,H,L] rows, each read or written once)
    over the memory rate, against its matmul work on the bf16 tensor cores
    (4, 6 and 8 L^2 D a head for K4, K5 and K6) and its 4 fp32 operations
    per logit outside them (K4: max, subtract, exp2, sum; K5/K6: subtract,
    exp2, subtract, multiply)."""
    n_bhld, n_rows, matmul = {"K4": (4, 1, 4), "K5": (5, 2, 6), "K6": (6, 2, 8)}[kind]
    nbytes = n_bhld * 2 * b * h * l * d + n_rows * 4 * b * h * l
    logits = b * h * l * l
    t_bytes = nbytes / (PEAK_HBM_TBS * 1e12) * 1e3
    t_tensor = matmul * logits * d / (PEAK_BF16_TFLOPS * 1e12) * 1e3
    t_fp32 = 4.0 * logits / (PEAK_FP32_TFLOPS * 1e12) * 1e3
    bound = max(t_bytes, t_tensor, t_fp32)
    return bound, ("bytes" if bound == t_bytes else "operations")


def kernel_error(got, want, rtol=KERNEL_RTOL):
    """(max |got - want|, worst ratio of the error to its tolerance)."""
    w = want.float()
    err = (got.float() - w).abs()
    tol = rtol * w.abs() + KERNEL_ATOL_RMS * w.pow(2).mean().sqrt()
    return float(err.max()), float((err / tol).max())


def phase_environment():
    import torch

    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for float32 matmuls and convolutions (the float32 references)")
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
        regs = [line.split("Used ")[1].split(" registers")[0] for line in lines if "registers" in line]
        spills = [line.strip() for line in lines if "spill" in line and "0 bytes spill stores" not in line]
        log(f"  ptxas {name}: registers per thread of the head-dim instantiations: {', '.join(regs)}; "
            f"spills: {spills or 'none'}")
        fa._library(name)


def phase_kernels():
    import torch

    from diffmining_tpu_torch.ops.flash_attention import flash_attention_nomax_plain, flash_fwd_nomax

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def qkv(b, h, l, d):
        # [B, L, H*D] projections viewed as [B, H, L, D], as the UNet hands them over
        return [torch.randn(b, l, h * d, generator=g, device=dev).to(torch.bfloat16)
                .view(b, l, h, d).transpose(1, 2) for _ in range(3)]

    cases = [
        ("K1 L4096 D40", (16, 8, 4096, 40)),
        ("K1 L1024 D80", (16, 8, 1024, 80)),
        ("K2 L16384 D40", (2, 8, 16384, 40)),
        ("masked tail L1000 D40", (2, 8, 1000, 40)),
        ("masked tail L1100 D160", (2, 8, 1100, 160)),
    ]
    results = {}
    for name, (b, h, l, d) in cases:
        q, k, v = qkv(b, h, l, d)
        got = flash_fwd_nomax(q, k, v)
        torch.cuda.synchronize()
        want = plain_chunked(flash_attention_nomax_plain, q, k, v)
        max_err, worst = kernel_error(got, want)
        if worst > 1.0 or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel disagrees with the plain version (max abs err {max_err}, "
                                 f"{worst:.3g} x the tolerance)")
        ms = cuda_time_ms(lambda: flash_fwd_nomax(q, k, v))
        plain_ms = cuda_time_ms(lambda: plain_chunked(flash_attention_nomax_plain, q, k, v), reps=3, warmup=1)
        lib_ms = cuda_time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v))
        bound, by, n_exp2 = attention_bound(b, h, l, l, d)
        results[name] = dict(shape=[b, h, l, d], max_abs_err=max_err, err_over_tol=worst, ms=ms,
                             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound, bound_by=by, exp2=n_exp2)
        log(f"kernel {name} B{b} H{h} L{l} D{d}: max|err| {max_err:.3g} = {worst:.3g} x tolerance "
            f"ms {ms:.4f}  plain {plain_ms:.3f}  sdpa {lib_ms:.4f}  bound {bound:.4f} ({by}; "
            f"{n_exp2:.3g} exp2)")
        del q, k, v, got, want
        torch.cuda.empty_cache()

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
        # the float32 reference: the kernel is bf16 only, so this pass (and
        # only this one) swaps the UNet's attention for the plain softmax
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
    log(f"slice: one UNet pass (batch {batch_images * 2}, dedup) {pass_ms:.2f} ms")

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
    return launches, imgs_hr, imgs_hr_100, pass_ms


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
        return fa.flash_fwd_lse_plain(q, k, v, block_k=64)  # the kernel's 64-key tiles

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
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
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
            "K5": (cuda_time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta)),
                   cuda_time_ms(lambda: plain_chunked(fa.flash_bwd_dq_plain, q, k, v, do, lse, delta),
                                reps=3, warmup=1), None),
            "K6": (cuda_time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta)),
                   cuda_time_ms(lambda: plain_chunked(fa.flash_bwd_dkv_plain, q, k, v, do, lse, delta),
                                reps=3, warmup=1), None),
        }
        # one library call computes dq, dk and dv together: sdpa's backward
        lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True))
        for kind, (ms, plain_ms, lib_ms) in times.items():
            bound, by = training_bound(kind, b, h, l, d)
            max_err = max(e for e, _ in errs[kind])
            worst = max(w for _, w in errs[kind])
            results[kind][name] = dict(
                shape=[b, h, l, d], max_abs_err=max_err, err_over_tol=worst, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms if lib_ms is not None else lib_bwd,
                library="sdpa forward" if kind == "K4" else "sdpa backward (dq, dk, dv together)",
                bound_ms=bound, bound_by=by)
            if kind == "K4":
                results[kind][name]["lse_max_abs_err"] = lse_err
            log(f"kernel {kind} {name} B{b} H{h}: max|err| {max_err:.3g} = {worst:.3g} x tolerance  "
                f"ms {ms:.4f}  plain {plain_ms:.3f}  {results[kind][name]['library']} "
                f"{results[kind][name]['library_ms']:.4f}  bound {bound:.4f} ({by})")
        del q, k, v, do, o, lse, delta, dq, dk, dv, qr, kr, vr, ref
        torch.cuda.empty_cache()
    return results


def places_trainer(work, batch, px, n_images, max_train_steps):
    """The places trainer at SD-v1.5 widths with random weights from SEED:
    float32 master weights, bf16 autocast, EMA, batches of ``batch`` out of
    ``n_images`` synthetic px x px images (numpy, seeded) handed in through
    BaseTrainer(load=...). Returns the trainer after training_init(), its
    args and the epoch's batches on the card."""
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
            "--max_train_steps", str(max_train_steps), "--device", "cuda"]
    args = parse_args(argv)
    tr = BaseTrainer("places", args, sd=sd, load=arrays.__getitem__)
    tr.training_init()
    return tr, args, [tr._batch(b) for b in tr.loader.epoch(0)]


STEP_CATEGORIES = (  # first match wins, on the lower-cased kernel name
    ("flash kernels (K4, K5, K6)", ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")),
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
    unet_mod.sdpa = sdpa_plain  # the kernels are bf16 only: this pass alone uses the plain softmax
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
    del tr, batches, p
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return dict(steps=n_steps, batch=batch, px=px, losses=losses, step_ms=[x * 1e3 for x in step_s],
                warm_step_ms=warm_ms, images_per_s=batch / warm_ms * 1e3, peak_gib=peak_gib,
                remat_step_ms=remat_ms[1], remat_peak_gib=remat_peak_gib, launches=launches,
                remat_launches=remat_launches, grad_rel_l2=rel, export_s=export_s, profile=profile, card=smi)


TRAIN_KERNELS = {
    "K4": ("flash_fwd_lse", "diffmining_tpu_torch/csrc/flash_fwd_lse.cu",
           "diffmining_tpu/ops/flash_attention.py:37 (_flash_kernel, via _flash_forward(return_lse=True) :142)"),
    "K5": ("flash_bwd_dq", "diffmining_tpu_torch/csrc/flash_bwd_dq.cu",
           "diffmining_tpu/ops/flash_attention.py:573 (_bwd_dq_kernel, via _bwd_pallas :659)"),
    "K6": ("flash_bwd_dkv", "diffmining_tpu_torch/csrc/flash_bwd_dkv.cu",
           "diffmining_tpu/ops/flash_attention.py:609 (_bwd_dkv_kernel, via _bwd_pallas :659)"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    import diffmining_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = phase_environment()
    phase_build()
    kern = phase_kernels()
    launches, imgs_hr, imgs_hr_100, pass_ms = phase_slice(smi)
    torch.cuda.empty_cache()
    train_kern = phase_train_kernels()
    train = phase_train(smi)

    main_case = kern["K1 L4096 D40"]
    entries = [{
        "name": "flash_fwd_nomax",
        "route": "cuda",
        "source": "diffmining_tpu_torch/csrc/flash_fwd_nomax.cu",
        "replaces": "diffmining_tpu/ops/flash_attention.py:290 (_flash_kernel_t_1shot); "
                    "diffmining_tpu/ops/flash_attention.py:250 (_flash_kernel_t_nomax)",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in kern.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
        "shapes": kern,
    }]
    for kind, (name, source, replaces) in TRAIN_KERNELS.items():
        cases = train_kern[kind]
        main_case = cases["L4096 D40"]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": train["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in cases.values()),
            "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"], "library": main_case["library"],
            "shapes": cases,
        })
    print(json.dumps({"slice": {"imgs_per_hr_n4": imgs_hr, "imgs_per_hr_n100": imgs_hr_100,
                                "unet_pass_ms": pass_ms, "card": smi}}))
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
