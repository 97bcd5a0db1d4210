"""The port's 8-bit AdamW (ops/optim8bit.py, the trainer's --use_8bit_adam)
held to the JAX package's ops/optim8bit.py on the CPU: the quantizer and
dequantizer (int8 values and scales equal, sizes that are and are not
multiples of the 256-element block, an all-zero block, ties at .5 of a
quantum), three ``scale_by_adam_8bit`` updates (steps to rtol 1e-6, atol
1e-8; states equal), the grouping of tensors into flat buffers (results
independent of it), one train step against JAX's
``make_optimizer(use_8bit=True)`` with and without accumulation (the dense
step's bounds, tests/test_torch_port_finetune.py), and a checkpoint that
resumes into the same run.
"""
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.finetuning.train import TrainStepBuilder as JTrainStepBuilder
from diffmining_tpu.finetuning.train import make_lr_schedule as jmake_lr_schedule
from diffmining_tpu.finetuning.train import make_optimizer as jmake_optimizer
from diffmining_tpu.ops import optim8bit as J
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.utils.export import save_pipeline_dir as jsave_pipeline_dir

from diffmining_tpu_torch.diffusion.schedule import make_schedule
from diffmining_tpu_torch.finetuning.args import parse_args
from diffmining_tpu_torch.finetuning.base import BaseTrainer
from diffmining_tpu_torch.finetuning.train import TrainStepBuilder, make_lr_schedule, make_optimizer
from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT, CLIPTextModel
from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.models.vae import DECODER_PREFIXES, TINY_VAE, AutoencoderKL
from diffmining_tpu_torch.ops import optim8bit as P
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)
DECADES = ["1930", "1990"]
LR = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the quantizer and the update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 1000, 12295])
def test_quantize_and_dequantize_equal_jax(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) * rng.choice([1e-3, 1.0, 100.0], size=n)).astype(np.float32)
    if n > 600:
        x[256:512] = 0  # an all-zero block: scale 0, q 0
    # ties: a block whose largest |value| is 127, so the quantum is 1 and
    # half-quanta round half to even
    x[:8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]
    x[8:256] = rng.uniform(-120, 120, 248).astype(np.float32)
    qj, sj = J._quantize(jnp.asarray(x))
    qp, sp = P.quantize(_t(x))
    assert qp.dtype == torch.int8 and sp.dtype == torch.float32
    assert qp.shape == (-(-n // 256), 256) and sp.shape == (qp.shape[0], 1)
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    assert list(qp[0, :8]) == [127, 0, 2, 2, 0, -2, -2, 126]
    np.testing.assert_array_equal(P.dequantize(qp, sp, (n,)).numpy(), np.asarray(J._dequantize(qj, sj, (n,))))


SHAPES = [(37, 5), (300,), (16, 16, 3, 3), (4,)]


@pytest.mark.parametrize("group_elems", [1024, P.GROUP_ELEMS])
def test_three_updates_equal_jax(group_elems):
    """Three scale_by_adam_8bit updates of gradients over six orders of
    magnitude: steps to rtol 1e-6, atol 1e-8, every int8 value and scale
    equal, the count as JAX's; the same with four groups or one."""
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = J.scale_by_adam_8bit()
    st = tx.init([jnp.asarray(p) for p in params])
    ps = P.init_state([_t(p) for p in params], group_elems=group_elems)
    assert len(ps.groups) == (3 if group_elems == 1024 else 1)
    for _ in range(3):
        gs = [(rng.randn(*s) * 10 ** rng.uniform(-5, 1)).astype(np.float32) for s in SHAPES]
        uj, st = tx.update([jnp.asarray(g) for g in gs], st)
        up = P.scale_by_adam_8bit_([_t(g) for g in gs], ps)
        for i in range(len(SHAPES)):
            assert up[i].shape == SHAPES[i]
            np.testing.assert_allclose(up[i].numpy(), np.asarray(uj[i]), rtol=1e-6, atol=1e-8)
            for got, want in zip(ps.tensor(i), (st.mu_q[i], st.mu_s[i], st.nu_q[i], st.nu_s[i])):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ps.count == int(st.count) == 3
    assert ps.nbytes() == sum(int(a.size) * a.dtype.itemsize
                              for a in jax.tree_util.tree_leaves((st.mu_q, st.mu_s, st.nu_q, st.nu_s)))


def test_groups_hold_whole_tensors():
    groups = P.plan_groups([300, 256, 5000, 10, 10], group_elems=1024)
    assert [(g.start, g.end) for g in groups] == [(0, 2), (2, 3), (3, 5)]
    assert groups[0].offsets == (0, 2, 3) and groups[1].offsets == (0, 20) and groups[2].offsets == (0, 1, 2)


# ---------------------------------------------------------------------------
# one train step against JAX's make_optimizer(use_8bit=True)
# ---------------------------------------------------------------------------


def _jax_steps(jsd, images, tokens, key, accum):
    """JAX's 8-bit builder over ``accum`` micro-steps (one image each when
    accumulating), its draws for each in the port's layout, and the state
    after the last."""
    builder = JTrainStepBuilder(
        unet=jsd.unet, vae=jsd.vae, clip=jsd.clip, schedule=jsd.schedule,
        optimizer=jmake_optimizer(jmake_lr_schedule("constant", LR, 0), accum_steps=accum, use_8bit=True),
        vae_params=jsd.vae_params, clip_params=jsd.clip_params, use_ema=True, accum_steps=accum,
    )
    state = builder.init_state(jsd.unet_params)
    step = builder.build()
    n = images.shape[0] // accum
    nchw = lambda a: _t(np.asarray(a).transpose(0, 3, 1, 2))  # noqa: E731
    micro, losses = [], []
    for i in range(accum):
        im, tok = images[i * n:(i + 1) * n], tokens[i * n:(i + 1) * n]
        k_lat, k_noise, k_t = jax.random.split(jax.random.fold_in(key, i), 3)
        mean, _ = jsd.vae.apply(jsd.vae_params, jnp.asarray(im))
        draws = (nchw(jax.random.normal(k_lat, mean.shape, dtype=jnp.float32)),
                 nchw(jax.random.normal(k_noise, mean.shape, dtype=jnp.float32)),
                 _t(np.asarray(jax.random.randint(k_t, (n,), 0, jsd.schedule.num_train_timesteps, dtype=jnp.int32))))
        micro.append((nchw(im), _t(tok), draws))
        state, loss = step(state, jnp.asarray(im), jnp.asarray(tok), key)
        losses.append(float(loss))
    return micro, losses, params_from_jax(_np(state.params), "unet"), params_from_jax(_np(state.ema_params), "unet")


def _assert_step_close(got, want):
    diffs = torch.cat([(got[k].detach() - w.detach()).abs().flatten() for k, w in want.items()])
    assert float(diffs.max()) <= 2 * LR + 1e-6
    assert float((diffs <= 1e-3 * LR).float().mean()) >= 0.99


@pytest.fixture(scope="module")
def jsd():
    return JSD.init_tiny("ftt", DECADES)


@pytest.mark.parametrize("accum", [1, 2])
def test_8bit_train_step_matches_jax(jsd, accum):
    """A step of the port's trainer with use_8bit (accumulated over two
    micro-steps or not) against JAX's on the same draws: losses rtol 1e-5,
    parameters and EMA at the dense step's bounds, int8 moments."""
    rng = np.random.RandomState(21)
    images = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tokens = rng.randint(0, 1000, (2, 77)).astype(np.int32)
    micro, losses, want_p, want_ema = _jax_steps(jsd, images, tokens, jax.random.PRNGKey(5), accum)
    unet = UNet2DCondition(TINY_UNET)
    load_state(unet, params_from_jax(_np(jsd.unet_params), "unet"))
    vae = AutoencoderKL(TINY_VAE)
    load_state(vae, params_from_jax(_np(jsd.vae_params), "vae"), ignore_prefixes=DECODER_PREFIXES)
    clip = CLIPTextModel(TINY_CLIP_TEXT)
    load_state(clip, params_from_jax(_np(jsd.clip_params), "clip_text"))
    b = TrainStepBuilder(unet=unet, vae=vae, clip=clip, schedule=make_schedule(), use_ema=True,
                         optimizer=make_optimizer(make_lr_schedule("constant", LR, 0), accum_steps=accum,
                                                  use_8bit=True))
    state = b.init_state()
    step = b.build()
    for (im, tok, draws), want_loss in zip(micro, losses):
        state, loss = step(state, im, tok, draws=draws)
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    inner = state.opt_state.inner_state if accum > 1 else state.opt_state
    assert isinstance(inner, P.Adam8bitState) and inner.count == 1
    assert all(q.dtype == torch.int8 for q in inner.mu_q + inner.nu_q)
    _assert_step_close(state.params, want_p)
    _assert_step_close(state.ema_params, want_ema)


# ---------------------------------------------------------------------------
# the checkpoint
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def base_dir(jsd, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("base8"))
    jsave_pipeline_dir(out, jsd.unet.config, _np(jsd.unet_params), jsd.vae.config, _np(jsd.vae_params),
                       jsd.clip.config, _np(jsd.clip_params), jsd.schedule)
    return out


@pytest.fixture(scope="module")
def ftt_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftt8")
    rng = np.random.RandomState(2)
    for dec in DECADES:
        os.makedirs(join(root, dec))
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (36, 36, 3), dtype=np.uint8)).save(join(root, dec, f"q{dec}_{i}.png"))
    return str(root)


def _args(base, data, out, steps, *extra):
    return parse_args([
        "--base_name_or_path", base, "--data_path", data, "--output_dir", out,
        "--train_batch_size", "2", "--max_train_steps", str(steps), "--resolution", "32",
        "--mixed_precision", "no", "--use_ema", "--use_8bit_adam", "--checkpointing_steps", "1",
        "--device", "cpu", *extra,
    ])


def test_checkpoint_resumes_the_same_run(base_dir, ftt_data, tmp_path):
    """Three steps straight against two steps, then a resume from
    checkpoint-2 and a third: the int8 moments, scales, count, parameters and
    EMA come out bit for bit the same; a dense-Adam run cannot resume it."""
    straight = BaseTrainer("ftt", _args(base_dir, ftt_data, str(tmp_path / "a"), 3))
    straight.train()
    out = str(tmp_path / "b")
    BaseTrainer("ftt", _args(base_dir, ftt_data, out, 2)).train()
    resumed = BaseTrainer("ftt", _args(base_dir, ftt_data, out, 3, "--resume_from_checkpoint", "latest"))
    resumed.train()
    a, b = straight.state, resumed.state
    assert a.step == b.step == 3 and a.opt_state.count == b.opt_state.count == 3
    for name in ("mu_q", "mu_s", "nu_q", "nu_s"):
        for x, y in zip(getattr(a.opt_state, name), getattr(b.opt_state, name)):
            assert torch.equal(x, y), name
    for k in a.params:
        assert torch.equal(a.params[k].detach(), b.params[k].detach()), k
        assert torch.equal(a.ema_params[k], b.ema_params[k]), k
    dense = BaseTrainer("ftt", parse_args([
        "--base_name_or_path", base_dir, "--data_path", ftt_data, "--output_dir", out, "--resolution", "32",
        "--mixed_precision", "no", "--resume_from_checkpoint", "latest", "--device", "cpu"]))
    dense.training_init()
    with pytest.raises(ValueError, match="adam optimizer state"):
        dense.resume_training()
