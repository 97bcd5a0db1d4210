"""The settings that travel with the channel-major world, held to the JAX
package on the CPU.

``forward_route_cbl`` and ``kernel_route_cbl`` against the Pallas kernel
the JAX ``sdpa_cbl`` traces, under every DIFFMINING_FLASH_ONESHOT setting
(K1 or K3, never K2); DIFFMINING_ATTN_BACKEND (xla, pallas, auto) on CUDA
metadata, cross-attention included, and its ValueError; the sweep under
DIFFMINING_SWEEP_DEDUP=0 against the JAX engine under the same setting on
the same draws; and ``get_non_overlapping`` through the C++ host op
against the JAX package's and the numpy loop.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffmining_tpu.ops.attention as jattn
import diffmining_tpu.ops.flash_attention as jfa
from diffmining_tpu.diffusion.schedule import make_schedule as jmake_schedule
from diffmining_tpu.models.unet import TINY_UNET as J_TINY_UNET
from diffmining_tpu.models.unet import UNet2DCondition as JUNet
from diffmining_tpu.ops import pool as jpool
from diffmining_tpu.typicality.engine import TypicalityEngine as JEngine
from diffmining_tpu.typicality.engine import sample_noise_and_t

from diffmining_tpu_torch.diffusion.schedule import make_schedule
from diffmining_tpu_torch.models.unet import TINY_UNET, UNet2DCondition
from diffmining_tpu_torch.native import boxops
from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa
from diffmining_tpu_torch.ops import pool as ppool
from diffmining_tpu_torch.typicality.engine import TypicalityEngine
from diffmining_tpu_torch.utils.weights import load_state, params_from_jax

torch.set_num_threads(1)
CUDA = torch.device("cuda")
JAX_KERNELS = {"_flash_kernel_t_1shot": "K1", "_flash_kernel_t_nomax": "K2", "_flash_kernel_t": "K3",
               "_flash_kernel": "K4"}


def _jax_route(monkeypatch, fn, shapes):
    """The Pallas kernel the JAX ``fn`` traces on arguments of ``shapes``
    under the pallas backend (abstract evaluation: nothing runs)."""
    hits = []
    for name in JAX_KERNELS:
        orig = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, _n=name, _o=orig, **k: hits.append(_n) or _o(*a, **k))
    monkeypatch.setattr(jattn, "_DEFAULT_BACKEND", "pallas")
    jax.eval_shape(fn, *(jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in shapes))
    assert len(set(hits)) == 1, hits
    return JAX_KERNELS[hits[0]]


@pytest.mark.parametrize("lq,d", [(1000, 40), (1024, 80), (1100, 160), (4096, 40), (16384, 40)])
@pytest.mark.parametrize("oneshot", ["all", "1", "0"])
def test_cbl_route_matches_jax(monkeypatch, oneshot, lq, d):
    """The kernel _flash_forward_cbl launches for a channel-major self-
    attention, seen by tracing the JAX sdpa_cbl, is the one the port's
    route names; the bf16 and float32 wrappers follow it; K2 never runs."""
    for mod in (jfa, pfa):
        monkeypatch.setattr(mod, "_ONESHOT", oneshot)
    h = 8
    want = _jax_route(monkeypatch, lambda q, k, v: jattn.sdpa_cbl(q, k, v, h), [(h * d, 1, lq)] * 3)
    assert want in ("K1", "K3")
    assert pfa.forward_route_cbl(lq, lq) == want
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        route = pattn.kernel_route_cbl(dtype, d, lq, lq, False)
        assert route.kinds == (want,)
        assert route.wrappers == (("flash_fwd_nomax_cm" if want == "K1" else "flash_fwd_online_cm") + suffix,)
        assert getattr(pfa, route.wrappers[0]).launches >= 0
        assert pattn.kernel_route_cbl(dtype, d, lq, lq, True).wrappers == tuple(
            w + suffix for w in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"))
    assert pattn.FORWARD_CBL[want] is pfa.FORWARD_CM[want]


# ---------------------------------------------------------- the backend switch

GATED = ((16, 8, 4096, 40), (16, 8, 4096, 40))
CROSS = ((16, 8, 4096, 40), (16, 8, 77, 40))
SHORT = ((16, 8, 256, 160), (16, 8, 256, 160))


def test_backend_auto_is_the_gate(monkeypatch):
    assert pattn.get_attention_backend() == "auto"  # the default, DIFFMINING_ATTN_BACKEND unset
    assert pattn.use_kernel(*GATED, False, CUDA)
    assert not pattn.use_kernel(*CROSS, False, CUDA) and not pattn.use_kernel(*SHORT, False, CUDA)
    assert pattn.kernels_take(torch.float16, 512)  # auto leaves unknown dtypes to the wrappers, which raise


def test_backend_xla_takes_the_plain_path(monkeypatch):
    monkeypatch.setattr(pattn, "_BACKEND", "xla")
    for shapes in (GATED, CROSS, SHORT):
        assert not pattn.use_kernel(*shapes, False, CUDA)


def test_backend_pallas_sends_every_call_the_kernels_take(monkeypatch):
    """Under pallas every unmasked CUDA call goes to the kernels at its own
    lengths, cross-attention (Lk = 77) and short levels included, where a
    kernel computes its dtype and head dim; the VAE's D = 512, float16 and a
    masked call take the plain path, decided on metadata before any launch.
    The route of a cross-attention is the one the JAX sdpa traces under
    pallas (K1: the 77 keys are one block)."""
    monkeypatch.setattr(pattn, "_BACKEND", "pallas")
    for shapes in (GATED, CROSS, SHORT):
        assert pattn.use_kernel(*shapes, False, CUDA)
    assert not pattn.use_kernel(*CROSS, True, CUDA)
    assert not pattn.use_kernel(*GATED, False, torch.device("cpu"))
    assert pattn.kernels_take(torch.bfloat16, 40) and pattn.kernels_take(torch.float32, 64)
    assert not pattn.kernels_take(torch.bfloat16, 64) and not pattn.kernels_take(torch.bfloat16, 512)
    assert not pattn.kernels_take(torch.float16, 40)
    want = _jax_route(monkeypatch, lambda q, k, v: jattn.sdpa(q, k, v), [(1, 8, 4096, 40), (1, 8, 77, 40),
                                                                          (1, 8, 77, 40)])
    assert pfa.forward_route(4096, 77) == want == "K1"
    assert pattn.kernel_route(torch.bfloat16, 40, 4096, 77, False).wrappers == ("flash_fwd_nomax",)
    want = _jax_route(monkeypatch, lambda q, k, v: jattn.sdpa_cbl(q, k, v, 8), [(320, 1, 4096), (320, 1, 77),
                                                                                (320, 1, 77)])
    assert pfa.forward_route_cbl(4096, 77) == want == "K1"


def test_backend_pallas_keeps_cpu_tensors_plain(monkeypatch):
    monkeypatch.setattr(pattn, "_BACKEND", "pallas")

    def no_kernel(*a, **k):
        raise AssertionError("a CPU tensor reached a kernel wrapper")

    for table in (pattn.FORWARD, pattn.FORWARD_CBL):
        for key in list(table):
            monkeypatch.setitem(table, key, no_kernel)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, n, 8).astype(np.float32)) for n in (64, 77, 77))
    torch.testing.assert_close(pattn.sdpa(q, k, v), pattn.sdpa_plain(q, k, v))
    qc, kc, vc = (pattn.merge_cm(t) for t in (q, k, v))
    torch.testing.assert_close(pattn.sdpa_cbl(qc, kc, vc, 2), pattn.sdpa_cbl_plain(qc, kc, vc, 2))


def test_set_backend_and_the_environment(monkeypatch):
    monkeypatch.setattr(pattn, "_BACKEND", "auto")
    for name in ("xla", "pallas", "auto"):
        pattn.set_attention_backend(name)
        assert pattn.get_attention_backend() == name
    with pytest.raises(ValueError, match="expected xla|pallas|auto"):
        pattn.set_attention_backend("triton")
    code = "import diffmining_tpu_torch.ops.attention as a; print(a.get_attention_backend())"
    env = {**os.environ, "DIFFMINING_ATTN_BACKEND": "pallas"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "pallas", out.stderr
    env["DIFFMINING_ATTN_BACKEND"] = "cuda"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "ValueError: DIFFMINING_ATTN_BACKEND='cuda': expected xla|pallas|auto" in out.stderr


# ---------------------------------------------------- DIFFMINING_SWEEP_DEDUP=0

SEED, N, CHUNK, T_MIN, T_MAX = 7, 4, 2, 0.1, 0.9


def test_sweep_without_dedup_matches_jax(monkeypatch):
    """DIFFMINING_SWEEP_DEDUP=0: the engine tiles the noisy latents and the
    timesteps over the conditions up front and the UNet runs at
    B*chunk*n_cond with ctx_tile 1 (a spy on its calls), and the losses
    equal the JAX engine's under the same setting on its own draws (fp16:
    rtol 2e-3, atol 1e-4, the bound of tests/test_torch_port_pipeline.py);
    on the dedup path they are the same losses."""
    monkeypatch.setenv("DIFFMINING_SWEEP_DEDUP", "0")
    junet = JUNet(J_TINY_UNET, dtype=jnp.float32)
    params = jax.jit(junet.init)(jax.random.PRNGKey(1), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
                                 jnp.zeros((1, 7, 32)))
    punet = UNet2DCondition(TINY_UNET).eval()
    load_state(punet, params_from_jax(jax.tree_util.tree_map(np.asarray, params), "unet"))
    rng = np.random.RandomState(3)
    b, c, h, w, n_cond = 2, 4, 8, 8, 2
    latents = rng.randn(b, h, w, c).astype(np.float32)
    ctx = rng.randn(b, n_cond, 77, 32).astype(np.float32)
    uids = [11, 29]
    jeng = JEngine(unet=junet, unet_params=params, schedule=jmake_schedule(), seed=SEED, n_samples=N, chunk=CHUNK,
                   t_min=T_MIN, t_max=T_MAX, dtype=jnp.float32, cast_params=False)
    assert jeng.dedup_prefix is False
    want = np.asarray(jeng.compute(jnp.asarray(latents), jnp.asarray(ctx), uids)).transpose(0, 1, 2, 5, 3, 4)

    draws = [sample_noise_and_t(jeng.image_key(u), N, (h, w, c), T_MIN, T_MAX) for u in uids]
    noises = torch.from_numpy(np.stack([np.asarray(d[0]).transpose(0, 3, 1, 2) for d in draws]))
    ts = torch.from_numpy(np.stack([np.asarray(d[1]) for d in draws])).long()
    calls = []
    forward = punet.forward
    monkeypatch.setattr(punet, "forward", lambda x, t, e, ctx_tile=1, **k: calls.append((x.shape[0], ctx_tile))
                        or forward(x, t, e, ctx_tile=ctx_tile, **k))
    eng = TypicalityEngine(unet=punet, schedule=make_schedule(), n_samples=N, chunk=CHUNK)
    assert eng.dedup_prefix is False
    lat = torch.from_numpy(np.ascontiguousarray(latents.transpose(0, 3, 1, 2)))
    got = eng.compute(lat, torch.from_numpy(ctx), noises, ts).numpy()
    assert calls == [(b * CHUNK * n_cond, 1)] * (N // CHUNK)
    assert got.shape == want.shape == (b, N, n_cond, c, h, w) and got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), rtol=2e-3, atol=1e-4)
    calls.clear()
    dedup = TypicalityEngine(unet=punet, schedule=make_schedule(), n_samples=N, chunk=CHUNK, dedup_prefix=True)
    again = dedup.compute(lat, torch.from_numpy(ctx), noises, ts).numpy()
    assert calls == [(b * CHUNK, n_cond)] * (N // CHUNK)
    np.testing.assert_allclose(again.astype(np.float32), got.astype(np.float32), rtol=2e-3, atol=1e-4)
    monkeypatch.delenv("DIFFMINING_SWEEP_DEDUP")
    assert TypicalityEngine(unet=punet, schedule=make_schedule()).dedup_prefix is True


# ------------------------------------------------------------------- boxops


def _boxes(rng, n, span, size):
    xs = rng.randint(0, span, (n, 2))
    return np.concatenate([xs, xs + size], axis=1).astype(np.int64)


@pytest.mark.parametrize("tied", [False, True])
def test_boxops_matches_jax_and_the_numpy_loop(tied):
    """The C++ suppression returns the JAX package's indices (its native
    path) and the numpy loop's, on random scores and on scores with many
    ties (ties keep the input order), and through top_patches."""
    rng = np.random.RandomState(8 + tied)
    for n, k in ((500, 12), (64, 64), (1, 3), (0, 4)):
        boxes = _boxes(rng, n, 60, 9)
        scores = rng.rand(n).astype(np.float32)
        if tied:
            scores = np.round(scores * 3) / 3
        got = ppool.get_non_overlapping(boxes, scores, k)
        assert got.dtype == np.int64 and len(got) <= k
        np.testing.assert_array_equal(got, np.asarray(jpool.get_non_overlapping(boxes, scores, k)))
        np.testing.assert_array_equal(got, ppool.get_non_overlapping_plain(boxes, scores, k))
    score = rng.rand(40, 50).astype(np.float32)
    for a, b in zip(ppool.top_patches(score, 8, 8, 6), jpool.top_patches(score, 8, 8, 6)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_boxops_builds_under_build_and_a_failed_build_names_the_compiler(monkeypatch, tmp_path):
    path = boxops.build()
    assert path.is_file() and path.parent == boxops.BUILD_DIR and path.parent.parts[-2:] == ("build", "native")
    assert not any(p.suffix == ".so" for p in boxops.SRC.parent.iterdir())  # nothing next to the source
    monkeypatch.setattr(boxops, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="false failed to build boxops.cpp"):
        boxops.build()
