"""The float32 typicality slice as a whole, held to the JAX package on the
CPU: a TINY_UNET float32 sweep (``--dtype fp32``) of 64 px images (latents
32 x 32, so the level-0 self-attention has the gated L = 1024) with the
gate opened on the CPU, so the gated calls go through the flash wrappers
(whose CPU paths are the plain versions of the float32 kernels), against
the JAX package's float32 sweep of the same checkpoint on the same draws
with its attention forced to the Pallas kernels in interpret mode.
TINY_UNET's head dim there is 32, which no kernel takes on the card: the
route at SD-v1.5's head dims is held to JAX in
tests/test_torch_port_f32_unet.py. Artifacts are fp16: rtol 2e-3, atol
1e-4, the bound of tests/test_torch_port_pipeline.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

import diffmining_tpu.ops.attention as jattn
import diffmining_tpu.ops.flash_attention as jfa
from diffmining_tpu.typicality.compute import Typicality as JTypicality
from diffmining_tpu.typicality.engine import sample_noise_and_t

from diffmining_tpu_torch.models.clip import TINY_CLIP_TEXT
from diffmining_tpu_torch.models.unet import TINY_UNET
from diffmining_tpu_torch.models.vae import TINY_VAE
from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.typicality.compute import SD, Typicality
from diffmining_tpu_torch.utils.export import save_pipeline_dir

torch.set_num_threads(1)
JAX_KERNELS = {"_flash_kernel_t_1shot": "K1", "_flash_kernel_t_nomax": "K2", "_flash_kernel_t": "K3",
               "_flash_kernel": "K4"}


def _spy_jax_kernels(monkeypatch):
    hits = []
    for name in JAX_KERNELS:
        orig = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, _n=name, _o=orig, **kw: hits.append(_n) or _o(*a, **kw))
    monkeypatch.setattr(jattn, "_DEFAULT_BACKEND", "pallas")
    return hits


SEED, N, T_MIN, T_MAX = 42, 2, 0.1, 0.7


def _jax_draws(uid, latent_shape):
    """The JAX sweep's draws for one image in the port's NCHW layout (as
    tests/test_torch_port_pipeline.py builds them)."""
    c, h, w = latent_shape
    vae_key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED), 7), uid)
    post = np.asarray(jax.random.normal(vae_key, (h, w, c), dtype=jnp.float32)).transpose(2, 0, 1)
    noise, t = sample_noise_and_t(jax.random.fold_in(jax.random.PRNGKey(SEED), uid), N, (h, w, c), T_MIN, T_MAX)
    return (torch.from_numpy(np.ascontiguousarray(post)),
            torch.from_numpy(np.ascontiguousarray(np.asarray(noise).transpose(0, 3, 1, 2))),
            torch.from_numpy(np.array(t)).long())


def _gate_open_on_cpu(q_shape, k_shape, masked, device):
    """The CUDA gate's shape rule without its device clause."""
    return not masked and q_shape[2] >= 1024 and q_shape[2] == k_shape[2] and q_shape[3] <= 160


def test_f32_sweep_through_the_kernel_route_matches_jax(monkeypatch, tmp_path):
    """The float32 sweep of two 64 px images with the gate opened on the CPU:
    every gated call (L = 1024) goes through the wrapper of the forward the
    route names (K1, whose float32 CUDA call is the no-max mode; its CPU
    path the plain version), and the artifacts equal the JAX package's
    float32 sweep with its attention on the Pallas kernels in interpret mode
    (K1 traced)."""
    out = str(tmp_path / "pipe")  # one checkpoint for both packages: random tiny weights, written by the port
    sd = SD.init_random("ftt", ["1960"], TINY_UNET, TINY_VAE, TINY_CLIP_TEXT, seed=3, dtype=torch.float32,
                        device="cpu")
    save_pipeline_dir(out, sd.unet.config, sd.unet.state_dict(), sd.vae.config, sd.vae.state_dict(),
                      sd.clip.config, sd.clip.state_dict(), sd.schedule)
    del sd
    data = tmp_path / "ftt"
    os.makedirs(data / "1960")
    rng = np.random.RandomState(5)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8)).save(data / "1960" / f"f{i}.png")

    hits = _spy_jax_kernels(monkeypatch)
    jax_tree, port_tree, subs = str(tmp_path / "jax"), str(tmp_path / "port"), str(tmp_path / "subs")
    jtyp = JTypicality("ftt", out, str(data), jax_tree, N=N, t_min=T_MIN, t_max=T_MAX, batch_images=2,
                       dtype=jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        for c in jtyp.categories():
            jtyp.D[c].compute_batch([(s, c) for s in jtyp.get_seeds_(c)])
    assert {JAX_KERNELS[h] for h in hits} == {"K1"}

    monkeypatch.setattr(pattn, "use_kernel", _gate_open_on_cpu)
    seen = []
    for kind, fn in list(pattn.FORWARD.items()):
        def spy(q, k, v, scale=None, _k=kind, _f=fn):
            seen.append((_k, q.dtype, q.shape[2], k.shape[2]))
            return _f(q, k, v, scale)
        monkeypatch.setitem(pattn.FORWARD, kind, spy)
    ptyp = Typicality("ftt", out, str(data), port_tree, N=N, t_min=T_MIN, t_max=T_MAX, batch_images=2,
                      dtype=torch.float32, device="cpu", draws=_jax_draws)
    ptyp.make_submission(str(data), subs, sub_split=1)
    ptyp.compute_submission(os.path.join(subs, "0.txt"))
    assert seen and all(kind == "K1" and dtype == torch.float32 and lq == lk == 1024 for kind, dtype, lq, lk in seen)
    for i in range(2):
        want = np.load(os.path.join(jax_tree, "1960", f"f{i}.npy"))
        got = np.load(os.path.join(port_tree, "1960", f"f{i}.npy"))
        assert got.shape == want.shape == (N, 2, 4, 32, 32) and got.dtype == np.float16
        np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3, atol=1e-4)
