#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; nothing falls
back to the CPU):
  1. environment: versions, the card's name and power limit; TF32 off for
     the float32 references;
  2. build: compile every kernel of the typicality path from the sources in
     this checkout (one nvcc for the one source);
  3. kernels: each kernel against its plain PyTorch version on the card at
     the path's shapes, plus a masked key tail and the underflow edge; CUDA-
     event times of the kernel, the plain version and one PyTorch library
     call (a yardstick only), and the least time the card could take;
  4. slice: SD-v1.5 widths (UNet, VAE, CLIP ViT-L text) with random weights
     from a seed, bf16; make_submission + compute_submission over 2 labels x
     8 synthetic 512x512 images; every artifact checked; kernel launches
     counted over that run; one UNet pass in bf16 with the kernel held
     against the same pass in float32 through the plain attention; imgs/hr
     of that run and of one warm group of 8 images at N=100.
Then one JSON line of per-kernel numbers, and as the last line
{"ok": true, "device": {...}}.
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
KERNEL_RTOL = 2.0**-7
KERNEL_ATOL_RMS = 2.0**-7
UNET_REL_L2 = 5e-2


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


def plain_chunked(plain, q, k, v):
    """The plain version over all of B*H, in slices whose float32 logits
    stay near 2 GiB (the whole batch at once would not fit)."""
    import torch

    b, h, lq, _ = q.shape
    per = max(1, (1 << 29) // (lq * k.shape[2]))
    qf, kf, vf = (t.reshape(b * h, 1, t.shape[2], t.shape[3]) for t in (q, k, v))
    out = [plain(qf[i:i + per], kf[i:i + per], vf[i:i + per]) for i in range(0, b * h, per)]
    return torch.cat(out).reshape(b, h, lq, q.shape[3])


def kernel_error(got, want):
    """(max |got - want|, worst ratio of the error to its tolerance)."""
    w = want.float()
    err = (got.float() - w).abs()
    tol = KERNEL_RTOL * w.abs() + KERNEL_ATOL_RMS * w.pow(2).mean().sqrt()
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

    t0 = time.perf_counter()
    fa.build()
    log(f"build: flash_fwd_nomax.cu in {time.perf_counter() - t0:.1f} s (set-up)")
    regs = [line.split("Used ")[1].split(" registers")[0] for line in fa.build_log.splitlines() if "registers" in line]
    spills = [line.strip() for line in fa.build_log.splitlines() if "spill" in line and "0 bytes spill stores" not in line]
    log(f"  ptxas: registers per thread of the head-dim instantiations: {', '.join(regs)}; "
        f"spills: {spills or 'none'}")
    fa._library()


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

    main_case = kern["K1 L4096 D40"]
    entry = {
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
    }
    print(json.dumps({"slice": {"imgs_per_hr_n4": imgs_hr, "imgs_per_hr_n100": imgs_hr_100,
                                "unet_pass_ms": pass_ms, "card": smi}}))
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
