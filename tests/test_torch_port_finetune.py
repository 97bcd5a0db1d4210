"""The port's finetuning slice on the CPU at tiny widths in float32, held to
the JAX package: one train step against the JAX TrainStepBuilder on the same
parameters, images, tokens and random draws (loss, gradients, parameters
after the AdamW step, EMA); accumulation; the LR schedules against optax;
gradient checkpointing; and ``train()`` end to end with checkpoints, resume,
pruning, ``--export-only`` and an export that the JAX package loads.

Tolerances. Loss and gradients: the two frameworks sum convolutions and
matmuls in different orders, so rtol 1e-3 with an atol of 1e-4 of the
largest gradient (the forward passes agree to 1e-6 relative). After one
AdamW step each parameter moves by about lr·sign(g); where |g| is near 0
the sign may differ between the frameworks, so the parameters are held at
an atol of 2·lr (a flipped sign), and 99% of them to 1e-3·lr.
"""
import json
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.diffusion.schedule import add_noise as jadd_noise
from diffmining_tpu.diffusion.schedule import get_velocity as jget_velocity
from diffmining_tpu.diffusion.schedule import make_schedule as jmake_schedule
from diffmining_tpu.finetuning.train import ema_decay_schedule as jema_decay_schedule
from diffmining_tpu.finetuning.train import TrainStepBuilder as JTrainStepBuilder
from diffmining_tpu.finetuning.train import make_lr_schedule as jmake_lr_schedule
from diffmining_tpu.finetuning.train import make_optimizer as jmake_optimizer
from diffmining_tpu.models.unet import UNet2DCondition as JUNet
from diffmining_tpu.models.vae import sample_latent as jsample_latent
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.utils.export import save_pipeline_dir as jsave_pipeline_dir
from diffmining_tpu.utils.weights import load_pipeline_dir as jload_pipeline_dir

from diffmining_tpu_torch.diffusion.schedule import get_velocity, make_schedule
from diffmining_tpu_torch.finetuning.args import parse_args
from diffmining_tpu_torch.finetuning.base import BaseTrainer
from diffmining_tpu_torch.finetuning.export import export_model
from diffmining_tpu_torch.finetuning.train import (
    TrainStepBuilder,
    ema_decay_schedule,
    make_lr_schedule,
    make_optimizer,
)
from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT, CLIPTextModel
from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, TINY_VAE, AutoencoderKL
from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)
DECADES = ["1930", "1990"]
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# one train step against the JAX TrainStepBuilder
# ---------------------------------------------------------------------------


def _jax_reference(px: int):
    """The JAX step on TINY widths at px x px images (TINY_VAE halves the
    size: 64 px -> 32x32 latents -> L = 1024 at the UNet's level 0), plus the
    same step's loss and gradients and its draws in the port's layout."""
    jsd = JSD.init_tiny("ftt", DECADES)
    rng = np.random.RandomState(px)
    images = rng.uniform(-1, 1, (2, px, px, 3)).astype(np.float32)
    tokens = rng.randint(0, 1000, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    # train.py:277-289 with the step's keys, so the draws can go to the port
    k_lat, k_noise, k_t = jax.random.split(jax.random.fold_in(key, 0), 3)
    mean, logvar = jsd.vae.apply(jsd.vae_params, jnp.asarray(images))
    latents = jsample_latent(mean, logvar, k_lat, jsd.vae.config.scaling_factor)
    eps = jax.random.normal(k_lat, mean.shape, dtype=jnp.float32)
    noise = jax.random.normal(k_noise, latents.shape, dtype=jnp.float32)
    t = jax.random.randint(k_t, (2,), 0, jsd.schedule.num_train_timesteps, dtype=jnp.int32)
    noisy = jadd_noise(jsd.schedule, latents, noise, t)
    ctx = jsd.clip.apply(jsd.clip_params, jnp.asarray(tokens))

    def loss_fn(p):
        return jnp.mean((jsd.unet.apply(p, noisy, t, ctx).astype(jnp.float32) - noise) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jsd.unet_params)
    builder = JTrainStepBuilder(
        unet=jsd.unet, vae=jsd.vae, clip=jsd.clip, schedule=jsd.schedule,
        optimizer=jmake_optimizer(jmake_lr_schedule("constant", LR, 0)),
        vae_params=jsd.vae_params, clip_params=jsd.clip_params, use_ema=True,
    )
    state = builder.init_state(jsd.unet_params)
    state, step_loss = builder.build()(state, jnp.asarray(images), jnp.asarray(tokens), key)
    nchw = lambda a: _t(np.asarray(a).transpose(0, 3, 1, 2))  # noqa: E731
    return dict(
        jsd=jsd, images=nchw(images), tokens=_t(tokens), draws=(nchw(eps), nchw(noise), _t(np.asarray(t))),
        loss=float(loss), step_loss=float(step_loss),
        grads=params_from_jax(_np(grads), "unet"),
        params=params_from_jax(_np(state.params), "unet"),
        ema=params_from_jax(_np(state.ema_params), "unet"),
    )


@pytest.fixture(scope="module")
def jax_ref():
    cache = {}

    def get(px):
        if px not in cache:
            cache[px] = _jax_reference(px)
        return cache[px]

    return get


def _port_models(jsd):
    unet = UNet2DCondition(TINY_UNET)
    load_state(unet, params_from_jax(_np(jsd.unet_params), "unet"))
    vae = AutoencoderKL(TINY_VAE)
    load_state(vae, params_from_jax(_np(jsd.vae_params), "vae"), ignore_prefixes=DECODER_PREFIXES)
    clip = CLIPTextModel(TINY_CLIP_TEXT)
    load_state(clip, params_from_jax(_np(jsd.clip_params), "clip_text"))
    return unet, vae, clip


def _builder(jsd, **kw):
    unet, vae, clip = _port_models(jsd)
    opt = make_optimizer(make_lr_schedule("constant", LR, 0), **kw)
    return TrainStepBuilder(unet=unet, vae=vae, clip=clip, schedule=make_schedule(), optimizer=opt,
                            use_ema=True)


def _gate_open_on_cpu(q_shape, k_shape, masked, device):
    """The CUDA gate's shape rule without its device clause: sends the CPU
    UNet's L >= 1024 self-attention through the autograd Function."""
    return not masked and q_shape[2] >= 1024 and q_shape[2] == k_shape[2] and q_shape[3] <= 160


def _assert_grads_close(got, want):
    scale = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-3, atol=1e-4 * scale, msg=k)


def _assert_step_close(got, want):
    """Parameters after one AdamW step: within 2·lr everywhere (a flipped
    sign of a near-zero gradient), within 1e-3·lr for 99% of them."""
    diffs = torch.cat([(got[k].detach() - w.detach()).abs().flatten() for k, w in want.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6
    assert float((diffs <= 1e-3 * LR).float().mean()) >= 0.99


@pytest.mark.parametrize("px,route", [(32, "plain"), (64, "plain"), (64, "function")])
def test_train_step_matches_jax(jax_ref, monkeypatch, px, route):
    """Loss, gradients, parameters and EMA after one step equal the JAX
    step's. At 64 px the UNet's level-0 self-attention has L = 1024, the
    gated length: on the CPU the gate's plain route runs it, and with the
    gate opened ("function") the autograd Function runs it through the plain
    K4 forward and K5/K6 backward."""
    ref = jax_ref(px)
    if route == "function":
        monkeypatch.setattr(pattn, "use_kernel", _gate_open_on_cpu)
    calls = {"n": 0}
    fwd = pfa.flash_fwd_lse

    def counted(*a, **kw):
        calls["n"] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(pfa, "flash_fwd_lse", counted)
    b = _builder(ref["jsd"])
    state = b.init_state()
    before = {k: v.detach().clone() for k, v in state.params.items()}
    loss = b.loss(ref["images"], ref["tokens"], draws=ref["draws"])
    loss.backward()
    grads = {k: p.grad.clone() for k, p in state.params.items()}
    for p in state.params.values():
        p.grad = None
    # TINY_UNET at 64 px: three L=1024 self-attentions (down 0, and up 0's two layers)
    assert calls["n"] == (3 if route == "function" else 0)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    _assert_grads_close(grads, ref["grads"])

    state, step_loss = b.build()(state, ref["images"], ref["tokens"], draws=ref["draws"])
    assert state.step == 1
    np.testing.assert_allclose(float(step_loss), ref["step_loss"], rtol=1e-5)
    assert max(float((state.params[k].detach() - before[k]).abs().max()) for k in before) > 0.5 * LR
    _assert_step_close(state.params, ref["params"])
    _assert_step_close(state.ema_params, ref["ema"])


def test_accumulation_equals_whole_batch(jax_ref):
    """Two micro-steps of one image each with accum 2 equal one step on both
    images (the same draws): the mid-window call leaves parameters and EMA
    untouched, the boundary call applies the mean gradient (held at the
    lr-level bound of the JAX comparison); so does the bf16 accumulator."""
    ref = jax_ref(32)
    images, tokens, (eps, noise, t) = ref["images"], ref["tokens"], ref["draws"]
    whole = _builder(ref["jsd"])
    ws = whole.init_state()
    ws, _ = whole.build()(ws, images, tokens, draws=(eps, noise, t))

    finals = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        acc = _builder(ref["jsd"], accum_steps=2, accum_dtype=dtype)
        st = acc.init_state()
        step = acc.build()
        start = {k: v.detach().clone() for k, v in st.params.items()}
        st, _ = step(st, images[:1], tokens[:1], draws=(eps[:1], noise[:1], t[:1]))
        for k in start:
            assert torch.equal(st.params[k], start[k]) and torch.equal(st.ema_params[k], start[k])
        assert st.opt_state.gradient_step == 0 and st.opt_state.mini_step == 1
        st, _ = step(st, images[1:], tokens[1:], draws=(eps[1:], noise[1:], t[1:]))
        assert st.opt_state.gradient_step == 1 and st.opt_state.mini_step == 0 and st.step == 2
        assert all(float(a.abs().max()) == 0 for a in st.opt_state.acc)
        finals[name] = st
    # the two gradients agree to float32 summation order; through Adam's
    # first step that is the lr-level bound of the JAX comparison
    _assert_step_close(finals["f32"].params, ws.params)
    _assert_step_close(finals["f32"].ema_params, ws.ema_params)
    _assert_step_close(finals["bf16"].params, ws.params)


@pytest.mark.parametrize(
    "name,warmup,total",
    [("constant", 0, None), ("constant_with_warmup", 10, None), ("linear", 10, 100),
     ("cosine", 10, 100), ("cosine_with_restarts", 10, 100), ("polynomial", 7, 50), ("linear", 0, 20)],
)
def test_lr_schedules_match_optax(name, warmup, total):
    want = jmake_lr_schedule(name, 3e-4, warmup, total)
    got = make_lr_schedule(name, 3e-4, warmup, total)
    for step in sorted({0, 1, 3, warmup, warmup + 1, 17, 33, 49, 50, 63, 99, 100, 120}):
        w = float(want(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(float(got(step)), w, rtol=1e-6, atol=1e-12, err_msg=f"{name} step {step}")
    if warmup:
        assert float(got(0)) == 0.0


def test_get_velocity_and_ema_ramp_match_jax():
    """The v-prediction target (train.py:289) and the EMA decay ramp over
    optimizer steps (train.py:188)."""
    rng = np.random.RandomState(4)
    x0, noise = rng.randn(3, 4, 6, 5).astype(np.float32), rng.randn(3, 4, 6, 5).astype(np.float32)
    t = np.array([0, 517, 999], np.int32)
    want = np.asarray(jget_velocity(jmake_schedule(), jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t)))
    np.testing.assert_allclose(get_velocity(make_schedule(), _t(x0), _t(noise), _t(t)).numpy(), want,
                               rtol=1e-6, atol=1e-7)
    for step in (0, 1, 7, 100, 10**6):
        assert ema_decay_schedule(step) == float(jema_decay_schedule(jnp.asarray(step)))
        assert ema_decay_schedule(step, 0.99) == float(jema_decay_schedule(jnp.asarray(step), 0.99))


@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_gradient_checkpointing_keeps_the_gradients(jax_ref, monkeypatch, policy):
    """Each remat policy gives the gradients of the plain pass; with the gate
    opened on the CPU, "full" and "attn" run the attention forward (K4) a
    second time in the backward, and "dots" does too (attention outputs are
    not matmul outputs, so they are recomputed)."""
    ref = jax_ref(64)
    monkeypatch.setattr(pattn, "use_kernel", _gate_open_on_cpu)
    calls = {"n": 0}
    fwd = pfa.flash_fwd_lse

    def counted(*a, **kw):
        calls["n"] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(pfa, "flash_fwd_lse", counted)
    b = _builder(ref["jsd"])
    state = b.init_state()
    b.loss(ref["images"], ref["tokens"], draws=ref["draws"]).backward()
    plain = {k: p.grad.clone() for k, p in state.params.items()}
    for p in state.params.values():
        p.grad = None
    calls["n"] = 0
    b.unet.set_gradient_checkpointing(policy)
    b.loss(ref["images"], ref["tokens"], draws=ref["draws"]).backward()
    assert calls["n"] == 2 * 3  # each of the three L=1024 attentions forward, then again in the backward
    for k, p in state.params.items():
        torch.testing.assert_close(p.grad, plain[k], rtol=1e-5, atol=1e-7, msg=k)


@pytest.mark.parametrize("flag", [["--lora"], ["--use_8bit_adam"], ["--log_previews"], ["--distributed"],
                                  ["--mesh_dp", "2"]])
def test_unported_flags_raise_with_their_roadmap_item(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        parse_args(["--device", "cpu", *flag])


# ---------------------------------------------------------------------------
# train() end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    """A tiny pipeline dir written by the JAX package (the trainer's base)."""
    out = str(tmp_path_factory.mktemp("base"))
    jsd = JSD.init_tiny("ftt", DECADES)
    jsave_pipeline_dir(out, jsd.unet.config, _np(jsd.unet_params), jsd.vae.config, _np(jsd.vae_params),
                       jsd.clip.config, _np(jsd.clip_params), jsd.schedule)
    return out


@pytest.fixture(scope="module")
def ftt_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftt_train")
    rng = np.random.RandomState(0)
    for dec in DECADES:
        os.makedirs(join(root, dec))
        for i in range(4):
            Image.fromarray(rng.randint(0, 255, (36, 36, 3), dtype=np.uint8)).save(join(root, dec, f"f{dec}_{i}.png"))
    return str(root)


def _args(base, data, out, *extra):
    return parse_args([
        "--base_name_or_path", base, "--data_path", data, "--output_dir", out,
        "--train_batch_size", "2", "--max_train_steps", "3", "--resolution", "32",
        "--mixed_precision", "no", "--use_ema", "--device", "cpu", *extra,
    ])


def _checkpoints(out):
    return sorted(d for d in os.listdir(out) if d.startswith("checkpoint-"))


def test_train_checkpoints_resume_prune_and_export(base_dir, ftt_data, tmp_path):
    out = str(tmp_path / "run")
    tr = BaseTrainer("ftt", _args(base_dir, ftt_data, out, "--checkpointing_steps", "1",
                                  "--checkpoints_total_limit", "2"))
    export_dir = tr.train()
    assert _checkpoints(out) == ["checkpoint-2", "checkpoint-3"]
    assert tr.state.step == 3 and tr.global_step == 3
    with open(join(out, "logs", "metrics.jsonl")) as f:
        rec = [json.loads(line) for line in f]
    assert rec and all(np.isfinite(r["train_loss"]) for r in rec)
    prompts = {tr.train_dataset.__getitem__(i, 0)["prompt"] for i in range(8)}
    assert any("A face portrait of the" in p for p in prompts)

    # the export carries the EMA weights and loads in the port and in JAX
    exported = SD.from_pipeline_dir("ftt", export_dir, DECADES, dtype=torch.float32, device="cpu")
    for k, v in exported.unet.state_dict().items():
        torch.testing.assert_close(v, tr.state.ema_params[k].detach(), rtol=0, atol=0)
    jp = jload_pipeline_dir(export_dir)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32)
    t = np.array([10, 900], np.int32)
    want = np.asarray(JUNet(jp["unet"]["config"], dtype=jnp.float32).apply(
        {"params": jp["unet"]["params"]}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = exported.unet(_t(x.transpose(0, 3, 1, 2)), _t(t), _t(ctx)).numpy()
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=1e-3, atol=2e-4)
    assert set(jp["vae"]["params"]) >= {"encoder", "decoder"}  # the base's decoder is passed through

    # resume latest: counters and optimizer state come back
    tr2 = BaseTrainer("ftt", _args(base_dir, ftt_data, out, "--resume_from_checkpoint", "latest"))
    tr2.training_init()
    tr2.resume_training()
    assert tr2.state.step == 3 and tr2.global_step == 3
    assert tr2.first_epoch == 0 and tr2.resume_step == 3  # 8 images / batch 2 = 4 micro-batches an epoch
    assert tr2.state.opt_state.count == 3
    for a, b_ in zip(tr.state.opt_state.nu, tr2.state.opt_state.nu):
        assert torch.equal(a, b_)

    # export_model writes checkpoint-2-export beside the checkpoints (the
    # sweep's -m OUT/checkpoint-N does the same)
    ckpt = export_model("ftt", join(out, "checkpoint-2"), device="cpu")
    assert ckpt == join(out, "checkpoint-2-export") and os.path.isfile(join(ckpt, "model_index.json"))

    # the resumed run's next save collects leftovers of interrupted writes
    # and holds the limit, and keeps the export although its checkpoint goes
    os.makedirs(join(out, "checkpoint-9.tmp-123"))
    os.makedirs(join(out, "checkpoint-8"))  # no state.pt: never complete
    tr2.args.checkpoints_total_limit = 2
    tr2.save_checkpoint(4)
    assert _checkpoints(out) == ["checkpoint-2-export", "checkpoint-3", "checkpoint-4"]
    assert os.path.isfile(join(ckpt, "model_index.json"))

    # --export-only from the latest checkpoint
    exp = str(tmp_path / "exp")
    tr3 = BaseTrainer("ftt", _args(base_dir, ftt_data, out, "--export-only", "--resume_from_checkpoint", "latest",
                                   "--export-dir", exp))
    assert tr3.train() == exp and os.path.isfile(join(exp, "unet", "diffusion_pytorch_model.safetensors"))


def test_train_with_accumulation_counts_optimizer_steps(base_dir, ftt_data, tmp_path):
    """gradient_accumulation_steps=2: max_train_steps and checkpoint names
    count optimizer steps, state.step counts calls, and resume recovers both
    (base.py:469-506)."""
    out = str(tmp_path / "accum")
    extra = ("--gradient_accumulation_steps", "2", "--max_train_steps", "2", "--checkpointing_steps", "1")
    tr = BaseTrainer("ftt", _args(base_dir, ftt_data, out, *extra))
    tr.train()
    assert tr.state.step == 4 and tr.global_step == 2 and tr.state.opt_state.gradient_step == 2
    assert _checkpoints(out) == ["checkpoint-1", "checkpoint-2"]
    tr2 = BaseTrainer("ftt", _args(base_dir, ftt_data, out, *extra, "--resume_from_checkpoint", "latest"))
    tr2.training_init()
    tr2.resume_training()
    assert tr2.global_step == 2 and tr2.micro_step == 4
    assert tr2.first_epoch == 1 and tr2.resume_step == 0
    assert tr2.state.opt_state.gradient_step == 2


def test_finetune_cli_then_typicality_from_the_checkpoint(base_dir, ftt_data, tmp_path):
    """python -m diffmining_tpu_torch finetune ... then typicality with -m
    pointing at the run's checkpoint: the port exports it and sweeps."""
    from diffmining_tpu_torch.__main__ import main as cli

    out = str(tmp_path / "cli")
    cli(["finetune", "--which", "ftt", "--base_name_or_path", base_dir, "--data_path", ftt_data,
         "--output_dir", out, "--train_batch_size", "2", "--max_train_steps", "1", "--resolution", "32",
         "--mixed_precision", "no", "--device", "cpu"])
    assert _checkpoints(out) == ["checkpoint-1"]
    tree, subs = str(tmp_path / "tree"), str(tmp_path / "subs")
    cli(["typicality", "--which", "ftt", "-i", ftt_data, "-c", tree, "-s", subs,
         "-m", join(out, "checkpoint-1"), "--make_submission", "--N", "2", "--batch_images", "2",
         "--dtype", "fp32", "--device", "cpu"])
    assert os.path.isfile(join(out, "checkpoint-1-export", "model_index.json"))
    a = np.load(join(tree, "1930", "f1930_0.npy"))
    assert a.shape == (2, 2, 4, 18, 18) and a.dtype == np.float16 and np.isfinite(a).all()
