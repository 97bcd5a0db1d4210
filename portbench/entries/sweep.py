"""The typicality sweep through the ``typicality`` command's engine: the
SD bundle (``typicality/compute.py`` ``SD``), one ``D`` artifact store and
its ``compute_batch``, which groups same-shape images, encodes them, sweeps
N (eps, t) draws of cond and null through the UNet (``typicality/
engine.py``) and writes one ``[N, 2, 4, h/8, w/8]`` fp16 ``.npy`` an image
while the next group runs. The images come from memory through the
documented ``load`` hook (no file decode) and the draws through the
``draws`` hook, both from the seed.

The window feeds one stream of images, labels alternating, and stops
feeding at the first group boundary after ``--seconds``; the groups already
queued still run. The rate is every image whose artifact was written over
the host time from the first call to the last write.

The check draws images of the window and draws of each from the seed and
recomputes their loss grids with the float32 reference: VAE encoder, text
encoder, UNet, ``(eps_hat - eps)^2``; the number compared is the relative
L2 distance of the artifacts' grids from the reference's.
"""
from __future__ import annotations

import os
import random
import time
from typing import Dict

import numpy as np
import torch

from portbench import counts, traffic, weights
from portbench.entries.common import (DTYPES, attention_spans, free, halves, port_module, reference, ref_spec,
                                      rel_l2)
from portbench.harness import Window
from portbench.reference.clip import TextEncoder
from portbench.reference.common import Precision
from portbench.reference.unet import UNet as RefUNet
from portbench.reference.vae import VAEEncoder
from portbench.seeds import derive
from portbench.tracing import launches, patched, span


def alphas_cumprod(sched: Dict, device) -> torch.Tensor:
    """The training schedule's cumulative alphas (scaled_linear betas)."""
    if sched["beta_schedule"] != "scaled_linear":
        raise ValueError(sched["beta_schedule"])
    betas = torch.linspace(sched["beta_start"] ** 0.5, sched["beta_end"] ** 0.5, sched["num_train_timesteps"],
                           dtype=torch.float64) ** 2
    return torch.cumprod(1.0 - betas, 0).float().to(device)


def build_sd(run, labels):
    """The program's SD bundle with the benchmark's weights."""
    from diffmining_tpu_torch.models.clip import CLIPTextModel
    from diffmining_tpu_torch.models.unet import UNet2DCondition
    from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, AutoencoderKL
    from diffmining_tpu_torch.typicality.compute import SD
    from diffmining_tpu_torch.utils.weights import (clip_config_from_json, schedule_from_json,
                                                    unet_config_from_json, vae_config_from_json)

    cfg, dev, tr = run.config, run.device, run.traffic
    dtype = DTYPES[tr["dtype"]]
    unet = port_module(lambda: UNet2DCondition(unet_config_from_json(cfg["unet"])),
                       weights.make(ref_spec(lambda: RefUNet(cfg["unet"])), run.seed, "unet", dev, dtype), dev)
    vae = port_module(lambda: AutoencoderKL(vae_config_from_json(cfg["vae"])),
                      weights.make(ref_spec(lambda: VAEEncoder(cfg["vae"])), run.seed, "vae", dev, dtype), dev,
                      missing_ok=DECODER_PREFIXES)
    text = port_module(lambda: CLIPTextModel(clip_config_from_json(cfg["text_encoder"])),
                       weights.make(ref_spec(lambda: TextEncoder(cfg["text_encoder"])), run.seed, "text", dev,
                                    dtype), dev)
    tok = traffic.Tokenizer(cfg["text_encoder"]["vocab_size"])
    return SD(tr["which"], unet, vae, text, tok, schedule_from_json(cfg["scheduler"]), list(labels), dtype, dev)


def apply_fault(run, unet) -> None:
    """A fault planted under the timed path (the benchmark's own tests):
    "altered" scales every eps prediction where the UNet produces it;
    "half_batch" computes the first half of the rows and repeats it."""
    if run.fault is None:
        return
    orig = unet.forward

    def forward(sample, t, ctx, *a, **kw):
        if run.fault == "altered":
            return orig(sample, t, ctx, *a, **kw) * 1.25
        if run.fault == "half_batch":
            half = sample.shape[0] // 2
            out = orig(sample[:half], t[:half], ctx[:ctx.shape[0] // 2], *a, **kw)
            return torch.cat([out, out], dim=0)
        raise ValueError(run.fault)

    unet.forward = forward


class Stream:
    """The window's images: name k is image k % distinct of the pool with
    label k % len(labels); its draws come from its name's uid."""

    def __init__(self, run, root: str):
        tr = run.traffic
        self.labels = list(tr["labels"])
        self.distinct = int(tr["distinct_images"])
        self.pool = traffic.images(run.seed, "pool", self.distinct, tr["height"], tr["width"], run.device)
        self.root = root
        self.fed = []

    def path(self, k: int) -> str:
        return os.path.join(self.root, f"{k:07d}.png")

    def label(self, k: int) -> str:
        return self.labels[k % len(self.labels)]

    def load(self, path: str) -> np.ndarray:
        return self.pool[int(os.path.basename(path)[:7]) % self.distinct]

    def items(self, start: int, group: int, count: int | None = None, seconds: float | None = None):
        """(path, label) from name ``start`` on: ``count`` of them, or until
        ``seconds`` have passed at a multiple of ``group``."""
        t0 = time.perf_counter()
        k = start
        while True:
            n = k - start
            if count is not None and n >= count:
                return
            if seconds is not None and n % group == 0 and n and time.perf_counter() - t0 >= seconds:
                return
            self.fed.append(k)
            yield self.path(k), self.label(k)
            k += 1


def draws_hook(run, n: int):
    tr = run.traffic

    def draws(uid, latent_shape):
        return traffic.draws(run.seed, uid, n, latent_shape, tr["t_range"], run.device)

    return draws


def setup(run):
    from diffmining_tpu_torch.typicality.compute import D

    tr = run.traffic
    sd = build_sd(run, tr["labels"])
    apply_fault(run, sd.unet)
    stream = Stream(run, os.path.join(run.scratch, "in"))
    store = D(sd, os.path.join(run.scratch, "typicality"), which=tr["which"], seed=run.seed, N=tr["N"],
              chunk=tr["chunk"], batch_images=tr["batch_images"], draws=draws_hook(run, tr["N"]))
    B = tr["batch_images"]
    # the warm-up: one group through a store of ``chunk`` draws, which runs
    # the UNet at the window's batch and every other step of a group once
    warm = D(sd, os.path.join(run.scratch, "warm-up"), which=tr["which"], seed=run.seed, N=tr["chunk"],
             chunk=tr["chunk"], batch_images=B, draws=draws_hook(run, tr["chunk"]))
    warm.compute_batch(list(stream.items(10 ** 6, B, count=B)), load=stream.load)
    stream.fed.clear()
    return {"sd": sd, "store": store, "stream": stream}


def window(run, cell) -> Window:
    B = run.traffic["batch_images"]
    t0 = time.perf_counter()
    cell["store"].compute_batch(cell["stream"].items(0, B, seconds=run.seconds), load=cell["stream"].load)
    return Window(len(cell["stream"].fed), time.perf_counter() - t0)


def instrument(run, sd):
    """Spans and counters around the program's UNet, VAE encoder and
    attention entry (the metric readers' inputs)."""
    import diffmining_tpu_torch.models.unet as port_unet

    cfg, tr = run.config, run.traffic
    unet_json, vae_json = _key(cfg["unet"]), _key(cfg["vae"])

    def unet_factory(orig):
        def forward(sample, t, ctx, *a, ctx_tile=1, **kw):
            rows = sample.shape[0] * ctx_tile
            run.counters.add("unet_calls")
            run.counters.add("unet_rows", rows)
            run.work.append(("flops", counts.unet_flops("unet", unet_json, rows, sample.shape[2], sample.shape[3],
                                                        ctx.shape[1])))
            with span("pb.unet"):
                return orig(sample, t, ctx, *a, ctx_tile=ctx_tile, **kw)

        return forward

    def vae_factory(orig):
        def encode(x):
            run.work.append(("flops", counts.vae_encoder_flops("vae", vae_json, *x.shape[:1], *x.shape[2:])))
            with span("pb.vae"):
                return orig(x)

        return encode

    return [patched(sd.unet, "forward", unet_factory), patched(sd.vae, "encode", vae_factory),
            *attention_spans(run, [port_unet], "bf16" if tr["dtype"] == "bf16" else "fp32")]


def _key(d: Dict) -> str:
    import json

    return json.dumps(d, sort_keys=True)


def precount(run) -> None:
    """The FLOP counts of the traced shapes, made before the profiler starts
    (``counts`` caches them)."""
    cfg, tr = run.config, run.traffic
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    h, w = tr["height"] // f, tr["width"] // f
    counts.unet_flops("unet", _key(cfg["unet"]), tr["batch_images"] * tr["chunk"] * 2, h, w, 77)
    counts.vae_encoder_flops("vae", _key(cfg["vae"]), tr["batch_images"], tr["height"], tr["width"])


def traced(run, cell):
    import contextlib

    B = run.traffic["batch_images"]
    n = int(run.workload["trace"]["groups"]) * B
    precount(run)

    def work() -> Window:
        with contextlib.ExitStack() as stack:
            for p in instrument(run, cell["sd"]):
                stack.enter_context(p)
            before = launches()
            t0 = time.perf_counter()
            cell["store"].compute_batch(cell["stream"].items(0, B, count=n), load=cell["stream"].load)
            run.counters.add("launches", launches() - before)
            run.counters.add("images", len(cell["stream"].fed))
        return Window(len(cell["stream"].fed), time.perf_counter() - t0)

    return work


def metrics(run, win: Window) -> Dict[str, float]:
    return {"sweep_images_per_hr": win.units / win.seconds * 3600.0}


def release(run, cell):
    out = {"fed": list(cell["stream"].fed), "pool": cell["stream"].pool, "root": cell["stream"].root,
           "artifacts": cell["store"].typicality_path}
    cell.clear()
    free()
    return out


def sample(run, fed):
    chk = run.workload["check"]
    rng = random.Random(derive(run.seed, "check"))
    ks = halves(rng, sorted(fed), run.traffic["batch_images"], int(chk["images"]))
    idx = sorted(rng.sample(range(run.traffic["N"]), min(int(chk["draws"]), run.traffic["N"])))
    return ks, idx


def reference_losses(run, models, x: torch.Tensor, uid: int, label: str, idx, prec: Precision) -> torch.Tensor:
    """The reference's loss grids [len(idx), 2, C, h, w] of one image [1, 3,
    H, W] at the draws ``idx`` (cond, null)."""
    tr, cfg = run.traffic, run.config
    unet, vae, text, acp = models
    tok = traffic.Tokenizer(cfg["text_encoder"]["vocab_size"])
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    lat_shape = (cfg["unet"]["in_channels"], x.shape[2] // f, x.shape[3] // f)
    posterior, noise, t = traffic.draws(run.seed, uid, tr["N"], lat_shape, tr["t_range"], run.device)
    ids = torch.from_numpy(tok([tr["prompts"]["cond"].format(c=label), tr["prompts"]["null"]])).to(run.device)
    with prec.active(), torch.no_grad():
        ctx = text(ids)  # [2, 77, D]: cond, null
        latent = vae.latent(x, posterior[None])
        noise, t = noise[idx], t[idx]
        a = acp[t].view(-1, 1, 1, 1)
        noisy = a.sqrt() * latent + (1 - a).sqrt() * noise  # [m, C, h, w]
        rows = noisy.repeat_interleave(2, 0)
        tt = t.repeat_interleave(2, 0)
        cc = ctx.repeat(len(idx), 1, 1)
        step = int(run.workload["check"].get("ref_batch", 16))
        pred = torch.cat([unet(rows[i:i + step], tt[i:i + step], cc[i:i + step]) for i in range(0, len(rows), step)])
        return ((pred - noise.repeat_interleave(2, 0)) ** 2).view(len(idx), 2, *lat_shape)


def reference_models(run, precision: str):
    cfg, dev = run.config, run.device
    dtype = DTYPES[run.traffic["dtype"]]
    return (reference(lambda: RefUNet(cfg["unet"]), run.seed, "unet", dev, dtype, precision),
            reference(lambda: VAEEncoder(cfg["vae"]), run.seed, "vae", dev, dtype, precision),
            reference(lambda: TextEncoder(cfg["text_encoder"]), run.seed, "text", dev, dtype, precision),
            alphas_cumprod(cfg["scheduler"], dev))


def check(run, outputs, precision: str = "fp32", control: str | None = None) -> Dict[str, float]:
    """``artifact_rel_l2`` of the sampled grids; with ``control`` the
    reference computed in that precision stands in the program's place."""
    ks, idx = sample(run, outputs["fed"])
    models = reference_models(run, precision)
    stand_in = reference_models(run, control) if control else None
    got, want = [], []
    for k in ks:
        path = os.path.join(outputs["root"], f"{k:07d}.png")
        label = run.traffic["labels"][k % len(run.traffic["labels"])]
        x = torch.from_numpy(outputs["pool"][k % len(outputs["pool"])]).permute(2, 0, 1)[None].to(run.device)
        ref = reference_losses(run, models, x, traffic.uid(path), label, idx, Precision(precision))
        if stand_in is not None:
            got.append(reference_losses(run, stand_in, x, traffic.uid(path), label, idx, Precision(control)).cpu())
        else:
            art = os.path.join(outputs["artifacts"], f"{k:07d}.npy")
            if not os.path.isfile(art):
                return {"artifact_rel_l2": float("inf")}
            got.append(torch.from_numpy(np.load(art)[idx]).float())
        want.append(ref.cpu())
    del models, stand_in
    free()
    return {"artifact_rel_l2": rel_l2(torch.stack(got), torch.stack(want))}
