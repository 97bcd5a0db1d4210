"""The ftt finetuning trainer: ``finetuning/base.py`` ``BaseTrainer("ftt")``
over ``finetuning/train.py`` (bf16 autocast around float32 master weights,
clip_by_global_norm, AdamW, EMA), fed by its own ``FTT`` dataset and
``BatchIterator`` (crop, prompt dropout, tokenising in a loader thread).
The images come from memory through the documented ``load`` hook; the
dataset listing is a tree of empty files under the run's scratch
directory; the step's (posterior eps, noise, t) come through the step's
``draws`` argument, from the seed. Checkpoints, previews and the export lie
outside the window, as between a user's logging steps.

Set-up builds the trainer once and drives it through its first
``checked_steps`` steps, which are the warm-up and what the check reads:
each step's loss, the per-leaf norms of the first gradient as the
optimizer got it (its first moment after one step over 1 - beta1), and the
per-leaf norms of the weights' and the EMA's change after the last of them.
The same trainer then runs the window, a step after another, until
``--seconds`` have passed; the rate is images over the host time.

The reference (float32, TF32 off) follows the same steps from the same
weights, batches and draws: VAE encoder, text encoder, UNet forward and
backward (in blocks of rows), the global-norm clip, optax's AdamW, the EMA.
"""
from __future__ import annotations

import contextlib
import os
import time
import types
from typing import Dict, List

import torch

from portbench import counts, traffic, weights
from portbench.entries.common import attention_spans, free, port_module, ref_spec, reference
from portbench.entries.sweep import alphas_cumprod
from portbench.harness import Window
from portbench.reference.clip import TextEncoder
from portbench.reference.common import Precision, materialize
from portbench.reference.unet import UNet as RefUNet
from portbench.reference.vae import VAEEncoder
from portbench.seeds import derive
from portbench.tracing import launches, patched, span


def trainer_args(run, data_path: str):
    from diffmining_tpu_torch.finetuning.args import parse_args

    tr = run.traffic
    argv = ["--data_path", data_path, "--output_dir", os.path.join(run.scratch, "out"),
            "--resolution", str(tr["resolution"]), "--train_batch_size", str(tr["train_batch_size"]),
            "--learning_rate", str(tr["learning_rate"]), "--lr_scheduler", "constant",
            "--mixed_precision", tr["mixed_precision"], "--seed", str(run.seed % (2 ** 31)),
            "--device", run.device.type]
    if tr["use_ema"]:
        argv.append("--use_ema")
    return parse_args(argv)


def dataset(run) -> str:
    """The FTT tree {root}/train/{label}/{k}.png of empty files: the names
    the loader lists; their pixels come from the ``load`` hook."""
    tr = run.traffic
    root = os.path.join(run.scratch, "ftt")
    for k in range(int(tr["distinct_images"])):
        label = tr["labels"][k % len(tr["labels"])]
        os.makedirs(os.path.join(root, "train", label), exist_ok=True)
        open(os.path.join(root, "train", label, f"{k:07d}.png"), "w").close()
    return root


def step_draws(run, step: int, rows: int, latent_shape):
    g = torch.Generator(device=run.device)
    g.manual_seed(derive(run.seed, "train-draws", step))
    eps = torch.randn((rows, *latent_shape), generator=g, device=run.device)
    noise = torch.randn((rows, *latent_shape), generator=g, device=run.device)
    t = torch.randint(0, run.config["scheduler"]["num_train_timesteps"], (rows,), generator=g, device=run.device)
    return eps, noise, t


def latent_shape(run):
    f = 2 ** (len(run.config["vae"]["block_out_channels"]) - 1)
    r = run.traffic["resolution"] // f
    return (run.config["unet"]["in_channels"], r, r)


def apply_fault(run, builder) -> None:
    """"unchanged": the step returns its state unchanged (no update);
    "half_batch": the loss is the mean over the first half of the rows."""
    if run.fault is None:
        return
    if run.fault == "unchanged":
        builder._apply_and_ema = lambda state, grads, inner: None
        return
    if run.fault == "half_batch":
        orig = builder.loss

        def loss(images, tokens, seed=0, step=0, draws=None):
            half = images.shape[0] // 2
            return orig(images[:half], tokens[:half], seed, step, tuple(d[:half] for d in draws))

        builder.loss = loss
        return
    raise ValueError(run.fault)


def setup(run):
    from diffmining_tpu_torch.finetuning.base import BaseTrainer
    from diffmining_tpu_torch.models.clip import CLIPTextModel
    from diffmining_tpu_torch.models.unet import UNet2DCondition
    from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, AutoencoderKL
    from diffmining_tpu_torch.utils.weights import (clip_config_from_json, schedule_from_json,
                                                    unet_config_from_json, vae_config_from_json)

    cfg, dev, tr = run.config, run.device, run.traffic
    bundle = types.SimpleNamespace(
        unet=port_module(lambda: UNet2DCondition(unet_config_from_json(cfg["unet"])),
                         weights.make(ref_spec(lambda: RefUNet(cfg["unet"])), run.seed, "unet", dev), dev),
        vae=port_module(lambda: AutoencoderKL(vae_config_from_json(cfg["vae"])),
                        weights.make(ref_spec(lambda: VAEEncoder(cfg["vae"])), run.seed, "vae", dev), dev,
                        missing_ok=DECODER_PREFIXES),
        clip=port_module(lambda: CLIPTextModel(clip_config_from_json(cfg["text_encoder"])),
                         weights.make(ref_spec(lambda: TextEncoder(cfg["text_encoder"])), run.seed, "text", dev),
                         dev),
        tokenizer=traffic.Tokenizer(cfg["text_encoder"]["vocab_size"]),
        schedule=schedule_from_json(cfg["scheduler"]),
    )
    pool = traffic.images(run.seed, "pool", int(tr["distinct_images"]), tr["height"], tr["width"], dev)
    load = lambda path: pool[int(os.path.basename(path)[:7])]  # noqa: E731
    trainer = BaseTrainer(tr["which"], trainer_args(run, dataset(run)), sd=bundle, load=load)
    trainer.training_init()
    apply_fault(run, trainer.builder)
    cell = {"trainer": trainer, "pool": pool, "epoch": 0, "batches": None, "step": 0, "seen": []}
    # the first steps: the warm-up, and what the check reads
    state = trainer.state
    params = list(state.params.values())
    losses = []
    for i in range(int(tr["checked_steps"])):
        images, tokens = next_batch(run, cell)
        cell["seen"].append((images.cpu(), tokens.cpu()))
        losses.append(train_step(run, cell, images, tokens))
        if i == 0:
            b1 = trainer.args.adam_beta1
            mu = getattr(trainer._inner(), "mu", None)
            cell["grad_norms"] = (torch.stack([m.float().norm() for m in mu]) / (1 - b1)).cpu() if mu else None
            cell["grads"] = {n: (m.float() / (1 - b1)).cpu() for n, m in zip(state.params, mu)} if mu else None
    cell["losses"] = [float(x) for x in losses]
    p0 = weights.make(ref_spec(lambda: RefUNet(cfg["unet"])), run.seed, "unet", dev)
    names = list(state.params)
    cell["change_norms"] = torch.stack([(p.detach() - p0[n]).norm() for n, p in zip(names, params)]).cpu()
    if state.ema_params is not None:
        cell["ema_norms"] = torch.stack([(state.ema_params[n] - p0[n]).norm() for n in names]).cpu()
    cell["names"] = names
    del p0
    return cell


def next_batch(run, cell):
    trainer = cell["trainer"]
    while True:
        if cell["batches"] is None:
            cell["batches"] = trainer.loader.epoch(cell["epoch"])
            cell["epoch"] += 1
        batch = next(cell["batches"], None)
        if batch is not None:
            return trainer._batch(batch)
        cell["batches"] = None


def train_step(run, cell, images, tokens):
    trainer = cell["trainer"]
    draws = step_draws(run, cell["step"], images.shape[0], latent_shape(run))
    trainer.state, loss = trainer.train_step(trainer.state, images, tokens, trainer.args.seed, draws=draws)
    cell["step"] += 1
    return loss


def window(run, cell) -> Window:
    t0 = time.perf_counter()
    steps = 0
    loss = None
    while steps == 0 or time.perf_counter() - t0 < run.seconds:
        images, tokens = next_batch(run, cell)
        loss = train_step(run, cell, images, tokens)
        steps += 1
    float(loss)  # the last step's result on the host
    return Window(steps * run.traffic["train_batch_size"], time.perf_counter() - t0)


def traced(run, cell):
    import diffmining_tpu_torch.models.unet as port_unet

    cfg, tr = run.config, run.traffic
    builder = cell["trainer"].builder
    rows, res = tr["train_batch_size"], tr["resolution"]
    f = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    step_flops = (3 * counts.unet_flops("unet", _key(cfg["unet"]), rows, res // f, res // f, 77)
                  + counts.vae_encoder_flops("vae", _key(cfg["vae"]), rows, res, res)
                  + counts.text_flops("text", _key(cfg["text_encoder"]), rows, 77))

    def opt_factory(orig):
        def apply(state, grads, inner):
            with span("pb.optimizer"):
                return orig(state, grads, inner)

        return apply

    def work() -> Window:
        t0 = time.perf_counter()
        steps = int(run.workload["trace"]["steps"])
        with contextlib.ExitStack() as stack:
            stack.enter_context(patched(builder, "_apply_and_ema", opt_factory))
            for p in attention_spans(run, [port_unet], "bf16" if tr["mixed_precision"] == "bf16" else "fp32"):
                stack.enter_context(p)
            before = launches()
            loss = None
            for _ in range(steps):
                images, tokens = next_batch(run, cell)
                with span("pb.step"):
                    loss = train_step(run, cell, images, tokens)
                run.work.append(("flops", step_flops))
            float(loss)
            run.counters.add("launches", launches() - before)
        run.counters.add("steps", steps)
        return Window(steps * rows, time.perf_counter() - t0)

    return work


def _key(d) -> str:
    import json

    return json.dumps(d, sort_keys=True)


def metrics(run, win: Window) -> Dict[str, float]:
    return {"train_images_per_s": win.units / win.seconds}


def release(run, cell):
    out = {k: cell.get(k) for k in ("losses", "grad_norms", "grads", "change_norms", "ema_norms", "names", "seen")}
    cell.clear()
    free()
    return out


def reference_steps(run, seen, precision: str, other_grads=None, keep_grads: bool = False):
    """The reference's losses, first-gradient leaf norms and the change of
    the weights and of the EMA after ``len(seen)`` steps; with
    ``other_grads`` ({name: first gradient} on the host) each leaf's
    distance from them ("grad_diff"); with ``keep_grads`` its own first
    gradients on the host ("grads")."""
    cfg, dev, tr = run.config, run.device, run.traffic
    prec = Precision(precision)
    vae = reference(lambda: VAEEncoder(cfg["vae"]), run.seed, "vae", dev, torch.float32, precision)
    text = reference(lambda: TextEncoder(cfg["text_encoder"]), run.seed, "text", dev, torch.float32, precision)
    with torch.device("meta"):
        model = RefUNet(cfg["unet"])
    p0 = weights.make(weights.spec(model), run.seed, "unet", dev)
    unet = materialize(model, p0, dev).set_precision(prec).requires_grad_(True)
    params = list(unet.parameters())
    names = [n for n, _ in unet.named_parameters()]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    ema = [p.detach().clone() for p in params]
    acp = alphas_cumprod(cfg["scheduler"], dev)
    b1, b2, eps_adam, wd, lr = 0.9, 0.999, 1e-8, 1e-2, float(tr["learning_rate"])
    block = int(run.workload["check"].get("ref_batch", 16))
    losses, grad_norms, extra = [], None, {}
    with prec.active():
        for step, (images, tokens) in enumerate(seen):
            images, tokens = images.to(dev), tokens.to(dev)
            eps, noise, t = step_draws(run, step, images.shape[0], latent_shape(run))
            with torch.no_grad():
                latents = vae.latent(images, eps)
                a = acp[t].view(-1, 1, 1, 1)
                noisy = a.sqrt() * latents + (1 - a).sqrt() * noise
                ctx = text(tokens)
            total = noise.numel()
            loss_sum = 0.0
            for i in range(0, images.shape[0], block):
                pred = unet(noisy[i:i + block], t[i:i + block], ctx[i:i + block])
                part = ((pred - noise[i:i + block]) ** 2).sum() / total
                part.backward()
                loss_sum += float(part.detach())
            losses.append(loss_sum)
            with torch.no_grad():
                grads = [p.grad for p in params]
                norm = float(torch.stack([g.pow(2).sum() for g in grads]).sum().sqrt())
                if not norm < 1.0:
                    for g in grads:
                        g.mul_(1.0 / norm)
                if step == 0:
                    grad_norms = torch.stack([g.norm() for g in grads]).cpu()
                    if other_grads is not None:
                        grad_diff = torch.stack([(g - other_grads[k].to(dev)).norm() for k, g in zip(names, grads)])
                        extra["grad_diff"] = grad_diff.cpu()
                    if keep_grads:
                        extra["grads"] = {k: g.cpu() for k, g in zip(names, grads)}
                n = step + 1
                for p, g, m, v in zip(params, grads, mu, nu):
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m / (1 - b1 ** n)) / ((v / (1 - b2 ** n)).sqrt() + eps_adam) + wd * p
                    p.add_(upd, alpha=-lr)
                    p.grad = None
                d = min(0.9999, (1 + step) / (10 + step))
                for e, p in zip(ema, params):
                    e.mul_(d).add_(p, alpha=1 - d)
    with torch.no_grad():
        change = torch.stack([(p - p0[k]).norm() for k, p in zip(names, params)]).cpu()
        ema_change = torch.stack([(e - p0[k]).norm() for k, e in zip(names, ema)]).cpu()
    out = {"losses": losses, "grad_norms": grad_norms, "change_norms": change, "ema_norms": ema_change,
           "names": names, **extra}
    del unet, vae, text, params, mu, nu, ema, p0
    free()
    return out


def aligned(side, names: List[str]):
    """``side``'s per-leaf norms in the order of ``names``."""
    order = {n: i for i, n in enumerate(side["names"])}
    if set(order) != set(names):
        raise KeyError("the program's UNet parameters are not the reference's")
    idx = torch.tensor([order[n] for n in names])
    out = dict(side)
    for k in ("grad_norms", "change_norms", "ema_norms"):
        if side.get(k) is not None:
            out[k] = side[k][idx]
    return out


def leaf_gap(got: torch.Tensor, want: torch.Tensor, keep: torch.Tensor) -> float:
    """The worst leaf's gap of norms, |got - want| over the larger of its
    reference norm and the median leaf's, over the leaves kept."""
    got, want = got.double()[keep], want.double()[keep]
    floor = want.median()
    return float(((got - want).abs() / torch.maximum(want, floor)).max())


def check(run, outputs, precision: str = "fp32", control: str | None = None) -> Dict[str, float]:
    """The numbers read: each gap of norms at the worst leaf kept
    (``leaf_gap``); the first gradient's distance from the reference's, over
    all of it (``grad_rel_l2``) and at the worst leaf (``grad_leaf_rel``,
    over the larger of the leaf's norm and the median leaf's)."""
    got = reference_steps(run, outputs["seen"], control, keep_grads=True) if control else outputs
    want = reference_steps(run, outputs["seen"], precision, other_grads=got.get("grads"))
    got = aligned(got, want["names"])
    # leaves whose reference gradient is nought to rounding move by round-off alone
    keep = want["grad_norms"] > 1e-3 * want["grad_norms"].median()
    out = {"loss_rel": max(abs(a - b) / b for a, b in zip(got["losses"], want["losses"])),
           "grad_gap": leaf_gap(got["grad_norms"], want["grad_norms"], keep) if got["grad_norms"] is not None
           else float("inf"),
           "change_gap": leaf_gap(got["change_norms"], want["change_norms"], keep)}
    if got.get("ema_norms") is not None:
        out["ema_gap"] = leaf_gap(got["ema_norms"], want["ema_norms"], keep)
    if "grad_diff" in want:
        diff, ref = want["grad_diff"].double()[keep], want["grad_norms"].double()[keep]
        out["grad_rel_l2"] = float(diff.pow(2).sum().sqrt() / ref.pow(2).sum().sqrt())
        out["grad_leaf_rel"] = float((diff / torch.maximum(ref, ref.median())).max())
    else:
        out["grad_rel_l2"] = out["grad_leaf_rel"] = float("inf")
    return out
