"""The port's sampling slice on the CPU at tiny widths in float32, held to the
JAX package: the DDIM/DDPM schedule steps, the VAE decoder, one DDIM step
through the UNet, ``sample_ddim`` and ``ddim_inversion`` chains, and the
trainer's ``--log_previews`` (``sample`` and ``save_logs``).

Tolerances. Schedule steps: the same float32 operations in the same order,
rtol 1e-6. The decoder and one step through the UNet: rtol 1e-3 and atol
2e-4, the UNet tests' bound (the frameworks sum convolutions in other
orders). Chains: rtol 2e-3 and atol 1e-4, the sweep pipeline's bound.
Preview images are uint8: at most one level apart.
"""
import os
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffmining_tpu.diffusion import sampling as jsampling
from diffmining_tpu.diffusion import schedule as jsched
from diffmining_tpu.finetuning.args import parse_args as jparse_args
from diffmining_tpu.finetuning.base import BaseTrainer as JBaseTrainer
from diffmining_tpu.models.vae import TINY_VAE as J_TINY_VAE
from diffmining_tpu.models.vae import AutoencoderKL as JVAE
from diffmining_tpu.typicality.compute import SD as JSD
from diffmining_tpu.utils.export import save_pipeline_dir as jsave_pipeline_dir

from diffmining_tpu_torch.__main__ import main as port_cli
from diffmining_tpu_torch.diffusion import sampling as psampling
from diffmining_tpu_torch.diffusion import schedule as psched
from diffmining_tpu_torch.finetuning.args import parse_args
from diffmining_tpu_torch.finetuning.base import BaseTrainer
from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.models.vae import TINY_VAE, AutoencoderKL
from diffmining_tpu_torch.typicality.compute import SD
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)
STEP = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-3, atol=2e-4)
CHAIN = dict(rtol=2e-3, atol=1e-4)
DECADES = ["1930", "1990"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return np.asarray(t.detach()).transpose(0, 2, 3, 1)


def schedules(prediction_type):
    return (jsched.make_schedule(prediction_type=prediction_type),
            psched.make_schedule(prediction_type=prediction_type))


@pytest.mark.parametrize("n", [1, 4, 7, 50, 999])
def test_ddim_timesteps_match_jax(n):
    np.testing.assert_array_equal(psched.ddim_timesteps(n), jsched.ddim_timesteps(n))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
@pytest.mark.parametrize("per_row", [False, True])
def test_schedule_steps_match_jax(prediction_type, per_row):
    js, ps = schedules(prediction_type)
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 5, 6).astype(np.float32)
    eps = rng.randn(3, 4, 5, 6).astype(np.float32)
    noise = rng.randn(3, 4, 5, 6).astype(np.float32)
    xj, ej, nj = (jnp.asarray(a.transpose(0, 2, 3, 1)) for a in (x, eps, noise))
    xp, ep, npt = (torch.from_numpy(a) for a in (x, eps, noise))
    pairs = [(981, 961), (21, 1), (1, -1)]
    for t, t_prev in pairs:
        tj = jnp.full((3,), t, jnp.int32) if per_row else jnp.asarray(t, jnp.int32)
        tpj = jnp.full((3,), t_prev, jnp.int32) if per_row else jnp.asarray(t_prev, jnp.int32)
        tp = torch.full((3,), t) if per_row else t
        tpp = torch.full((3,), t_prev) if per_row else t_prev
        tb_j, tb_p = jnp.full((3,), t, jnp.int32), torch.full((3,), t)
        np.testing.assert_allclose(nhwc(psched.pred_x0_from_eps(ps, xp, ep, tb_p)),
                                   np.asarray(jsched.pred_x0_from_eps(js, xj, ej, tb_j)), **STEP)
        np.testing.assert_allclose(nhwc(psched.eps_from_pred(ps, ep, xp, tb_p)),
                                   np.asarray(jsched.eps_from_pred(js, ej, xj, tb_j)), **STEP)
        np.testing.assert_allclose(nhwc(psched.ddim_step(ps, xp, ep, tp, tpp)),
                                   np.asarray(jsched.ddim_step(js, xj, ej, tj, tpj)), **STEP)
        np.testing.assert_allclose(nhwc(psched.ddim_step(ps, xp, ep, tp, tpp, eta=0.6, noise=npt)),
                                   np.asarray(jsched.ddim_step(js, xj, ej, tj, tpj, eta=0.6, noise=nj)), **STEP)
        # inversion runs the pair upwards: t_prev -> t (t_prev = -1 is the
        # clean boundary); the JAX step takes scalar levels only
        np.testing.assert_allclose(
            nhwc(psched.ddim_inverse_step(ps, xp, ep, t_prev, t)),
            np.asarray(jsched.ddim_inverse_step(js, xj, ej, jnp.asarray(t_prev), jnp.asarray(t))), **STEP)
    for t in (999, 500, 1, 0):
        for clip in (True, False):
            np.testing.assert_allclose(
                nhwc(psched.ddpm_step(ps, xp, ep, t, npt, clip_sample=clip)),
                np.asarray(jsched.ddpm_step(js, xj, ej, jnp.asarray(t, jnp.int32), nj, clip_sample=clip)), **STEP)
    with pytest.raises(ValueError):
        psched.ddim_step(ps, xp, ep, 981, 961, eta=0.5)


@pytest.fixture(scope="module")
def vae_pair():
    jvae = JVAE(J_TINY_VAE, dtype=jnp.float32)
    params = jvae.init(jax.random.PRNGKey(4), jnp.zeros((1, 16, 16, 3)), method=JVAE.encode_decode)
    pvae = AutoencoderKL(TINY_VAE).eval()
    load_state(pvae, params_from_jax(_np(params), "vae"))  # every tensor, the decoder's too
    return jvae, params, pvae


@pytest.mark.parametrize("hw", [(4, 4), (5, 7)])
def test_decoder_matches_jax(vae_pair, hw):
    jvae, params, pvae = vae_pair
    z = np.random.RandomState(6).randn(2, *hw, 4).astype(np.float32)
    want = np.asarray(jvae.apply(params, jnp.asarray(z), method=JVAE.decode))
    with torch.no_grad():
        got = pvae.decode(nchw(z))
    assert got.shape == (2, 3, 2 * hw[0], 2 * hw[1])  # TINY_VAE: one x2 level
    np.testing.assert_allclose(nhwc(got), want, **TOL)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny bundle, and a port UNet carrying its weights."""
    jsd = JSD.init_tiny("ftt", DECADES)
    punet = UNet2DCondition(TINY_UNET).eval()
    load_state(punet, params_from_jax(_np(jsd.unet_params), "unet"))
    rng = np.random.RandomState(2)
    lat = rng.randn(2, 8, 8, 4).astype(np.float32)
    cond = rng.randn(2, 77, 32).astype(np.float32)
    uncond = rng.randn(2, 77, 32).astype(np.float32)
    return jsd, punet, lat, cond, uncond


def _jeps(jsd):
    return lambda p, x, t, c: jsd.unet.apply(p, x, t, c)


def test_one_ddim_step_through_the_unet(tiny):
    jsd, punet, lat, cond, _ = tiny
    js, ps = jsd.schedule, psched.make_schedule()
    t = jnp.full((2,), 961, jnp.int32)
    eps = jsd.unet.apply(jsd.unet_params, jnp.asarray(lat), t, jnp.asarray(cond))
    want = jsched.ddim_step(js, jnp.asarray(lat), eps, jnp.asarray(961), jnp.asarray(941))
    with torch.no_grad():
        peps = punet(nchw(lat), torch.full((2,), 961), torch.from_numpy(cond))
    got = psched.ddim_step(ps, nchw(lat), peps, 961, 941)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_sample_ddim_matches_jax(tiny, prediction_type):
    jsd, punet, lat, cond, uncond = tiny
    js, ps = schedules(prediction_type)
    want = jsampling.sample_ddim(_jeps(jsd), jsd.unet_params, js, jnp.asarray(lat), jnp.asarray(cond),
                                 jnp.asarray(uncond), num_inference_steps=4, guidance_scale=7.5)
    got = psampling.sample_ddim(punet, ps, nchw(lat), torch.from_numpy(cond), torch.from_numpy(uncond),
                                num_inference_steps=4, guidance_scale=7.5)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **CHAIN)


@pytest.mark.parametrize("save_every", [1, 2])
def test_ddim_inversion_matches_jax(tiny, save_every):
    jsd, punet, lat, cond, _ = tiny
    jx, jtraj = jsampling.ddim_inversion(_jeps(jsd), jsd.unet_params, jsd.schedule, jnp.asarray(lat),
                                         jnp.asarray(cond), num_steps=6, save_every=save_every)
    px, ptraj = psampling.ddim_inversion(punet, psched.make_schedule(), nchw(lat), torch.from_numpy(cond),
                                         num_steps=6, save_every=save_every)
    assert tuple(ptraj.shape) == (6 // save_every, 2, 4, 8, 8)
    np.testing.assert_allclose(nhwc(px), np.asarray(jx), **CHAIN)
    np.testing.assert_allclose(np.asarray(ptraj).transpose(0, 1, 3, 4, 2), np.asarray(jtraj), **CHAIN)


def test_eta_noise_comes_from_the_generator(tiny):
    _, punet, lat, cond, uncond = tiny
    ps = psched.make_schedule()
    args = (punet, ps, nchw(lat), torch.from_numpy(cond), torch.from_numpy(uncond), 3)

    def run(seed, eta=1.0):
        g = torch.Generator()
        g.manual_seed(seed)
        return psampling.sample_ddim(*args, eta=eta, generator=g)

    torch.testing.assert_close(run(5), run(5), rtol=0, atol=0)
    assert float((run(5) - run(6)).abs().max()) > 1e-6
    torch.testing.assert_close(run(5, eta=0.0), run(6, eta=0.0), rtol=0, atol=0)


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    """A tiny pipeline dir written by the JAX package, and its bundle."""
    out = str(tmp_path_factory.mktemp("base"))
    jsd = JSD.init_tiny("ftt", DECADES)
    jsave_pipeline_dir(out, jsd.unet.config, _np(jsd.unet_params), jsd.vae.config, _np(jsd.vae_params),
                       jsd.clip.config, _np(jsd.clip_params), jsd.schedule)
    return out, jsd


@pytest.fixture(scope="module")
def ftt_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftt_train")
    rng = np.random.RandomState(0)
    for dec in DECADES:
        os.makedirs(join(root, dec))
        for i in range(2):
            Image.fromarray(rng.randint(0, 255, (36, 36, 3), dtype=np.uint8)).save(join(root, dec, f"f{dec}_{i}.png"))
    return str(root)


def test_trainer_previews_match_jax(base_dir, tmp_path):
    """BaseTrainer.sample on the EMA weights with the domain's prompts, the
    JAX trainer's starting latents injected."""
    pipe, jsd = base_dir
    common = ["--output_dir", str(tmp_path), "--resolution", "32", "--mixed_precision", "no", "--use_ema",
              "--num_inference_steps", "3", "--guidance_scale", "5.0"]
    jtr = JBaseTrainer("ftt", jparse_args(common), sd=jsd)
    jtr.export_init()
    want = jtr.sample(categories=["1930", "1990"], num_samples=2, seed=42)
    lat = nchw(jax.random.normal(jax.random.PRNGKey(42), (2, 4, 4, 4), dtype=jnp.float32))
    psd = SD.from_pipeline_dir("ftt", pipe, [], dtype=torch.float32, device="cpu")
    tr = BaseTrainer("ftt", parse_args(common + ["--device", "cpu"]), sd=psd)
    tr.export_init()
    got = tr.sample(categories=["1930", "1990"], num_samples=2, latents=lat)
    assert set(got) == set(want) == {"1930", "1990"}
    for c in want:
        for a, b in zip(got[c], want[c]):
            assert a.size == b.size == (8, 8)  # 32 px -> 4x4 latents -> TINY_VAE's x2
            assert np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16)).max() <= 1
    tr.global_step = 7
    tr.save_logs(got)
    grid = Image.open(join(str(tmp_path), "plots", "7", "1930.png"))
    assert grid.size == (16, 8)


def test_log_previews_through_the_cli(base_dir, ftt_data, tmp_path):
    pipe, _ = base_dir
    out = str(tmp_path / "run")
    port_cli(["finetune", "--which", "ftt", "--base_name_or_path", pipe, "--data_path", ftt_data,
              "--output_dir", out, "--train_batch_size", "2", "--max_train_steps", "2", "--logging_steps", "1",
              "--resolution", "32", "--mixed_precision", "no", "--log_previews", "--num_inference_steps", "2",
              "--num_samples_log", "1", "--device", "cpu"])
    for step in ("1", "2"):
        grids = sorted(os.listdir(join(out, "plots", step)))
        assert grids == [f"{c}.png" for c in sorted(("1880", "1920", "1940", "1960", "1980", "2000"))]
        assert Image.open(join(out, "plots", step, "1880.png")).size == (8, 8)
