"""The port's LoRA finetuning (finetuning/lora.py and the trainer's --lora)
held to the JAX package on the CPU at tiny widths in float32: the sites and
their order, the merge, one LoRA train step with EMA against JAX's
``TrainStepBuilder(lora_rank=...)``, ``dense_params`` and the export, the
factors' gradients under gradient checkpointing, the flash gate under a
frozen base, and ``train()`` end to end with --lora --use_8bit_adam.

The factor ``b`` is drawn nonzero for every comparison: at init b = 0 and
``a``'s gradient is zero, which would hide a wrong gradient. Tolerances are
the dense step's (tests/test_torch_port_finetune.py): loss rtol 1e-5,
parameters after one Adam step within 2·lr everywhere and 1e-3·lr for 99%;
merges rtol 1e-6; gradients with and without checkpointing rtol 1e-5, atol
1e-7.
"""
import contextlib
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.finetuning import lora as jlora
from diffmining_tpu.finetuning.train import TrainStepBuilder as JTrainStepBuilder
from diffmining_tpu.finetuning.train import make_lr_schedule as jmake_lr_schedule
from diffmining_tpu.finetuning.train import make_optimizer as jmake_optimizer
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.utils.export import save_pipeline_dir as jsave_pipeline_dir

from diffmining_tpu_torch.diffusion.schedule import make_schedule
from diffmining_tpu_torch.finetuning import lora
from diffmining_tpu_torch.finetuning.args import parse_args
from diffmining_tpu_torch.finetuning.base import BaseTrainer
from diffmining_tpu_torch.finetuning.train import TrainStepBuilder, make_lr_schedule, make_optimizer
from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT, CLIPTextModel
from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, TINY_VAE, AutoencoderKL
from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa
from diffmining_tpu_torch.ops.optim8bit import Adam8bitState
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.utils.weights import _rename_unet, load_state, params_from_jax

torch.set_num_threads(1)
DECADES = ["1930", "1990"]
LR = 1e-3
RANK = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


def _nonzero_b(tree, seed):
    """The JAX factor tree with b drawn N(0, 0.1²) from a numpy seed."""
    rng = np.random.RandomState(seed)

    def walk(node):
        if "a" in node and "b" in node:
            return {"a": np.asarray(node["a"]), "b": (0.1 * rng.randn(*node["b"].shape)).astype(np.float32)}
        return {k: walk(v) for k, v in node.items()}

    return walk(_np(tree))


@pytest.fixture(scope="module")
def jax_lora():
    """JAX's LoRA step at 32 px (TINY widths) from carried factors with b
    nonzero, its draws in the port's layout, and JAX's dense_params of the
    carried state (EMA = the carried factors)."""
    jsd = JSD.init_tiny("ftt", DECADES)
    rng = np.random.RandomState(3)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tokens = rng.randint(0, 1000, (2, 77)).astype(np.int32)
    key = jax.random.PRNGKey(7)
    k_lat, k_noise, k_t = jax.random.split(jax.random.fold_in(key, 0), 3)
    mean, _ = jsd.vae.apply(jsd.vae_params, jnp.asarray(images))
    eps = jax.random.normal(k_lat, mean.shape, dtype=jnp.float32)
    noise = jax.random.normal(k_noise, mean.shape, dtype=jnp.float32)
    t = jax.random.randint(k_t, (2,), 0, jsd.schedule.num_train_timesteps, dtype=jnp.int32)
    builder = JTrainStepBuilder(
        unet=jsd.unet, vae=jsd.vae, clip=jsd.clip, schedule=jsd.schedule,
        optimizer=jmake_optimizer(jmake_lr_schedule("constant", LR, 0)),
        vae_params=jsd.vae_params, clip_params=jsd.clip_params, use_ema=True, lora_rank=RANK,
    )
    state = builder.init_state(jsd.unet_params, jax.random.PRNGKey(0))
    init_factors = _np(state.params)
    carried = {"params": _nonzero_b(state.params["params"], 11)}
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, carried),
                          ema_params=jax.tree_util.tree_map(jnp.asarray, carried))
    dense = _np(builder.dense_params(state, use_ema=True))
    state, step_loss = builder.build()(state, jnp.asarray(images), jnp.asarray(tokens), key)
    nchw = lambda a: _t(np.asarray(a).transpose(0, 3, 1, 2))  # noqa: E731
    return dict(
        jsd=jsd, images=nchw(images), tokens=_t(tokens), draws=(nchw(eps), nchw(noise), _t(np.asarray(t))),
        init_factors=init_factors, carried=carried, dense=params_from_jax(dense, "unet"),
        step_loss=float(step_loss), params=params_from_jax(_np(state.params), "lora"),
        ema=params_from_jax(_np(state.ema_params), "lora"),
    )


def _port_models(jsd):
    unet = UNet2DCondition(TINY_UNET)
    load_state(unet, params_from_jax(_np(jsd.unet_params), "unet"))
    vae = AutoencoderKL(TINY_VAE)
    load_state(vae, params_from_jax(_np(jsd.vae_params), "vae"), ignore_prefixes=DECODER_PREFIXES)
    clip = CLIPTextModel(TINY_CLIP_TEXT)
    load_state(clip, params_from_jax(_np(jsd.clip_params), "clip_text"))
    return unet, vae, clip


def _lora_builder(jsd, carried=None, **kw):
    """The port's LoRA builder; its factors (and EMA) set to ``carried``."""
    unet, vae, clip = _port_models(jsd)
    b = TrainStepBuilder(unet=unet, vae=vae, clip=clip, schedule=make_schedule(),
                         optimizer=make_optimizer(make_lr_schedule("constant", LR, 0), **kw),
                         use_ema=True, lora_rank=RANK)
    state = b.init_state()
    if carried is not None:
        flat = params_from_jax(carried, "lora")
        assert set(flat) == set(state.params)
        with torch.no_grad():
            for k, v in flat.items():
                state.params[k].copy_(v)
                state.ema_params[k].copy_(v)
    return b, state


def _assert_step_close(got, want):
    diffs = torch.cat([(got[k].detach() - w.detach()).abs().flatten() for k, w in want.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6
    assert float((diffs <= 1e-3 * LR).float().mean()) >= 0.99


def test_sites_are_jax_walk_sites_in_its_order(jax_lora):
    """The port's sites are JAX's ``_walk`` sites, renamed, in the same
    order; the init draws have JAX's shapes, a ~ N(0,1)/rank, b = 0, and
    count_lora_params counts as JAX's does."""
    jsd = jax_lora["jsd"]
    # the walk over the freshly initialised tree, as init_state walks it (a
    # tree_map would sort the keys)
    want = [_rename_unet(".".join(path) + ".")[:-1] for path, _ in jlora._walk(jsd.unet_params["params"])]
    unet = _port_models(jsd)[0]
    got = [n for n, _ in lora.lora_sites(unet)]
    assert got == want and len(got) == 4 * 2 * 4  # 4 transformers (down, mid, 2 up) x attn1/2 x q,k,v,out
    g = torch.Generator()
    g.manual_seed(5)
    f = lora.init_lora_params(unet, RANK, g)
    jf = params_from_jax(jax_lora["init_factors"], "lora")
    assert {k: tuple(v.shape) for k, v in lora.flatten(f).items()} == {k: tuple(v.shape) for k, v in jf.items()}
    assert all(float(v["b"].abs().max()) == 0 for v in f.values())
    a = torch.cat([v["a"].flatten() for v in f.values()]) * RANK
    assert abs(float(a.mean())) < 0.05 and abs(float(a.std()) - 1) < 0.05
    assert lora.count_lora_params(f) == jlora.count_lora_params(jax_lora["init_factors"])
    g2 = torch.Generator()
    g2.manual_seed(5)
    assert all(torch.equal(x, y) for x, y in zip(lora.flatten(f).values(),
                                                 lora.flatten(lora.init_lora_params(unet, RANK, g2)).values()))


def test_merge_equals_jax(jax_lora):
    """merge_lora of carried nonzero factors equals JAX's merge (rtol
    1e-6), and only the sites' weights change."""
    jsd, carried = jax_lora["jsd"], jax_lora["carried"]
    jm = _np(jlora.merge_lora(jsd.unet_params, jax.tree_util.tree_map(jnp.asarray, carried), scale=0.5))
    base = params_from_jax(_np(jsd.unet_params), "unet")
    got = lora.merge_lora(base, lora.unflatten(params_from_jax(carried, "lora")), scale=0.5)
    want = params_from_jax(jm, "unet")
    assert set(got) == set(want)
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-6, atol=1e-7, msg=k)
    moved = {k for k in base if not torch.equal(got[k], base[k])}
    assert moved == {f"{s}.weight" for s in lora.unflatten(params_from_jax(carried, "lora"))}


def test_lora_step_matches_jax(jax_lora):
    """One LoRA step with EMA from the same carried factors and draws: loss,
    factors and EMA factors as JAX's; the base UNet bit for bit unchanged and
    never given a gradient."""
    ref = jax_lora
    b, state = _lora_builder(ref["jsd"], ref["carried"])
    base = {k: v.detach().clone() for k, v in b.unet.named_parameters()}
    assert not any(p.requires_grad for p in b.unet.parameters())
    before = {k: v.detach().clone() for k, v in state.params.items()}
    state, loss = b.build()(state, ref["images"], ref["tokens"], draws=ref["draws"])
    np.testing.assert_allclose(float(loss), ref["step_loss"], rtol=1e-5)
    assert max(float((state.params[k].detach() - before[k]).abs().max()) for k in before) > 0.5 * LR
    _assert_step_close(state.params, ref["params"])
    _assert_step_close(state.ema_params, ref["ema"])
    for k, p in b.unet.named_parameters():
        assert p.grad is None and torch.equal(p.detach(), base[k]), k


@contextlib.contextmanager
def _ema_moved(state):
    """The EMA factors moved away from the live ones for the block, so a
    preview that used the live factors would show."""
    for v in state.ema_params.values():
        v.mul_(1.5)
    try:
        yield
    finally:
        for v in state.ema_params.values():
            v.div_(1.5)


def test_dense_params_and_previews_equal_jax(jax_lora):
    """dense_params(use_ema) merges the EMA factors into the base as JAX's
    does; eval_unet (the previews' UNet) gives the pass of those merged
    weights."""
    ref = jax_lora
    b, state = _lora_builder(ref["jsd"], ref["carried"])
    dense = b.dense_params(state, use_ema=True)
    assert set(dense) == set(ref["dense"])
    for k, w in ref["dense"].items():
        torch.testing.assert_close(dense[k], w, rtol=1e-6, atol=1e-7, msg=k)
    rng = np.random.RandomState(2)
    x, ctx = _t(rng.randn(2, 4, 8, 8).astype(np.float32)), _t(rng.randn(2, 77, 32).astype(np.float32))
    t = torch.tensor([10, 700])
    with torch.no_grad():
        with _ema_moved(state):
            with b.eval_unet(state, use_ema=True) as eps_fn:
                got = eps_fn(x, t, ctx)
            plain = UNet2DCondition(TINY_UNET)
            load_state(plain, b.dense_params(state, use_ema=True))
            want = plain(x, t, ctx)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # the live factors are attached again afterwards
    attn = b.unet.get_submodule("down_blocks.0.attentions.0.transformer_blocks.0.attn1")
    assert attn.lora["to_q"][0] is state.params["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.a"]


def _gate_open_on_cpu(q_shape, k_shape, masked, device):
    return not masked and q_shape[2] >= 1024 and q_shape[2] == k_shape[2] and q_shape[3] <= 160


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_checkpointing_keeps_the_factor_gradients(jax_lora, monkeypatch, policy):
    """At 64 px (L = 1024 at level 0) with the gate opened on the CPU: the
    frozen base's q/k/v still require grad through the factors, so the
    self-attentions take the autograd Function (K4 forward, K5/K6
    backward), again when the remat policy recomputes them; the factors'
    gradients equal those without checkpointing (b nonzero)."""
    monkeypatch.setattr(pattn, "use_kernel", _gate_open_on_cpu)
    calls = {"n": 0}
    fwd = pfa.flash_fwd_lse

    def counted(*a, **kw):
        calls["n"] += 1
        return fwd(*a, **kw)

    monkeypatch.setattr(pfa, "flash_fwd_lse", counted)
    b, state = _lora_builder(jax_lora["jsd"], jax_lora["carried"])
    rng = np.random.RandomState(9)
    images = _t(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32))
    tokens = _t(rng.randint(0, 1000, (2, 77)))
    draws = (_t(rng.randn(2, 4, 32, 32).astype(np.float32)), _t(rng.randn(2, 4, 32, 32).astype(np.float32)),
             torch.tensor([100, 800]))
    b.loss(images, tokens, draws=draws).backward()
    assert calls["n"] == 3
    plain = {k: p.grad.clone() for k, p in state.params.items()}
    for p in state.params.values():
        p.grad = None
    assert all(float(g.abs().max()) > 0 for k, g in plain.items() if k.endswith(".a"))
    calls["n"] = 0
    b.unet.set_gradient_checkpointing(policy)
    b.loss(images, tokens, draws=draws).backward()
    assert calls["n"] == 2 * 3
    for k, p in state.params.items():
        torch.testing.assert_close(p.grad, plain[k], rtol=1e-5, atol=1e-7, msg=k)


# ---------------------------------------------------------------------------
# train() end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("base"))
    jsd = JSD.init_tiny("ftt", DECADES)
    jsave_pipeline_dir(out, jsd.unet.config, _np(jsd.unet_params), jsd.vae.config, _np(jsd.vae_params),
                       jsd.clip.config, _np(jsd.clip_params), jsd.schedule)
    return out


@pytest.fixture(scope="module")
def ftt_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftt_lora")
    rng = np.random.RandomState(1)
    for dec in DECADES:
        os.makedirs(join(root, dec))
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (36, 36, 3), dtype=np.uint8)).save(join(root, dec, f"l{dec}_{i}.png"))
    return str(root)


def _args(base, data, out, *extra):
    return parse_args([
        "--base_name_or_path", base, "--data_path", data, "--output_dir", out,
        "--train_batch_size", "2", "--max_train_steps", "2", "--resolution", "32",
        "--mixed_precision", "no", "--use_ema", "--lora", "--lora_rank", "2", "--use_8bit_adam",
        "--device", "cpu", *extra,
    ])


def test_train_lora_8bit_checkpoint_resume_and_export(base_dir, ftt_data, tmp_path):
    """--lora --use_8bit_adam: only the factors are trained and saved with
    int8 moments; the export is the base with the EMA factors merged; resume
    restores the factors, the EMA and the 8-bit state; --export-only from the
    checkpoint writes the same pipeline."""
    out = str(tmp_path / "run")
    tr = BaseTrainer("ftt", _args(base_dir, ftt_data, out, "--checkpointing_steps", "1"))
    export_dir = tr.train()
    st = tr.state
    assert isinstance(st.opt_state, Adam8bitState) and st.opt_state.count == 2
    assert all(q.dtype == torch.int8 for q in st.opt_state.mu_q + st.opt_state.nu_q)
    assert all(k.endswith((".a", ".b")) for k in st.params)
    exported = SD.from_pipeline_dir("ftt", export_dir, DECADES, dtype=torch.float32, device="cpu")
    base = SD.from_pipeline_dir("ftt", base_dir, DECADES, dtype=torch.float32, device="cpu")
    want = lora.merge_lora(dict(base.unet.state_dict()), lora.unflatten(st.ema_params))
    for k, v in exported.unet.state_dict().items():
        torch.testing.assert_close(v, want[k].detach(), rtol=0, atol=0, msg=k)
    assert sorted(d for d in os.listdir(out) if d.startswith("checkpoint-")) == ["checkpoint-1", "checkpoint-2"]

    tr2 = BaseTrainer("ftt", _args(base_dir, ftt_data, out, "--resume_from_checkpoint", "latest"))
    tr2.training_init()
    tr2.resume_training()
    s2 = tr2.state
    assert s2.step == 2 and s2.opt_state.count == 2
    for name in ("mu_q", "mu_s", "nu_q", "nu_s"):
        assert all(torch.equal(a, b_) for a, b_ in zip(getattr(st.opt_state, name), getattr(s2.opt_state, name)))
    for k in st.params:
        assert torch.equal(st.params[k].detach(), s2.params[k].detach())
        assert torch.equal(st.ema_params[k], s2.ema_params[k])

    exp = str(tmp_path / "exp")
    tr3 = BaseTrainer("ftt", _args(base_dir, ftt_data, out, "--export-only", "--resume_from_checkpoint", "latest",
                                   "--export-dir", exp))
    tr3.train()
    again = SD.from_pipeline_dir("ftt", exp, DECADES, dtype=torch.float32, device="cpu")
    for k, v in again.unet.state_dict().items():
        assert torch.equal(v, exported.unet.state_dict()[k]), k
