"""Float32 through the UNet on the card: the float32 kernels' routes and
plain versions, held to the JAX package on the CPU.

The JAX kernels compute in their operands' dtype, so a float32 UNet
(``--dtype fp32``, ``finetune --mixed_precision no``) runs them in float32
throughout; the port runs the float32 kernels (``flash_fwd_f32`` in its
no-max, online and lse modes, ``flash_bwd_dq_f32``, ``flash_bwd_dkv_f32``,
``gn_act_proj_f32``), which the card tests and chip_smoke.py hold to the
plain versions below. Here:

* the route: at every float32 self-attention shape of a 512 px and a 1024
  px UNet, with and without grad, the JAX ``sdpa`` (abstract evaluation, a
  spy on each Pallas kernel) traces the TPU kernels that
  ``attention.kernel_route`` names, and it names their float32 wrappers;
* the dispatch on metadata: float32 at head dims 40/80/160 (and the CLIP
  towers' 64) to the float32 wrappers, bf16 to its own, anything else
  raising; K7's by the dtypes;
* the plain versions at the float32 kernels' 64-key tile (``F32_BLOCK_K``)
  against the Pallas kernels run at that tile in interpret mode, float32,
  head dims 40/80/160, q and key tails: K3, K4 with its lse, K1/K2 and
  K5/K6 through ``_bwd_pallas``; K7's plain version against the Pallas K7
  at float32. rtol 1e-5 / atol 2e-6 (1e-4 / 1e-5 for the backward, as in
  tests/test_torch_port_flash_bwd.py): summation order only.

tests/test_torch_port_f32_sweep.py holds the slice as a whole.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.attention as jattn
import diffmining_tpu.ops.flash_attention as jfa
from diffmining_tpu.ops.fused_norm import gn_act_proj as j_gn_act_proj

from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa
from diffmining_tpu_torch.ops import fused_norm as pfn

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_KERNELS = {"_flash_kernel_t_1shot": "K1", "_flash_kernel_t_nomax": "K2", "_flash_kernel_t": "K3",
               "_flash_kernel": "K4", "_bwd_dq_kernel": "K5", "_bwd_dkv_kernel": "K6"}
# SD-v1.5's gated self-attentions, (L, head dim): 8 heads at widths 320, 640, 1280
UNET_SHAPES = [(512, 4096, 40), (512, 1024, 80), (1024, 16384, 40), (1024, 4096, 80), (1024, 1024, 160)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _spy_jax_kernels(monkeypatch):
    hits = []
    for name in JAX_KERNELS:
        orig = getattr(jfa, name)
        monkeypatch.setattr(jfa, name, lambda *a, _n=name, _o=orig, **kw: hits.append(_n) or _o(*a, **kw))
    monkeypatch.setattr(jattn, "_DEFAULT_BACKEND", "pallas")
    monkeypatch.setenv("DIFFMINING_FLASH_BWD", "pallas")  # the Pallas backward off the TPU, as the JAX tests run it
    return hits


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("px,l,d", UNET_SHAPES)
def test_f32_unet_route_matches_jax(monkeypatch, px, l, d, grad):
    """A float32 UNet self-attention at 512 px and 1024 px: the JAX sdpa
    traces the kernels the port's route names (K1 at L <= 4096, K2 at L
    16384; K4, K5 and K6 under grad), and the route names the float32
    wrappers."""
    hits = _spy_jax_kernels(monkeypatch)
    s = jax.ShapeDtypeStruct((1, 8, l, d), jnp.float32)
    if grad:
        jax.eval_shape(jax.grad(lambda q, k, v: jattn.sdpa(q, k, v).sum(), argnums=(0, 1, 2)), s, s, s)
    else:
        jax.eval_shape(lambda q, k, v: jattn.sdpa(q, k, v), s, s, s)
    route = pattn.kernel_route(torch.float32, d, l, l, grad)
    assert {JAX_KERNELS[h] for h in hits} == set(route.kinds)
    assert route.kinds == (("K4", "K5", "K6") if grad else ("K2",) if l == 16384 else ("K1",))
    assert all(w.endswith("_f32") and callable(getattr(pfa, w)) for w in route.wrappers)
    assert pattn.use_kernel((1, 8, l, d), (1, 8, l, d), False, torch.device("cuda"))


@pytest.mark.parametrize("d", [40, 80, 160])
def test_kernel_route_on_metadata(monkeypatch, d):
    """Float32 at SD-v1.5's head dims names the float32 forward modes (the
    route's K1/K2 no-max, K3 online, K4 lse) and under grad the lse mode, K5
    and K6 in float32; bf16 keeps its kernels; a float32 head dim outside
    F32_HEAD_DIMS, a bf16 one outside HEAD_DIMS and float16 raise."""
    f32 = pattn.kernel_route(torch.float32, d, 4096, 4096, False)
    assert f32.wrappers == ("flash_fwd_nomax_f32",)
    assert pattn.kernel_route(torch.float32, d, 1024, 1024, True).wrappers == (
        "flash_fwd_lse_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
    assert pattn.kernel_route(torch.bfloat16, d, 1024, 1024, True).wrappers == (
        "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    assert pattn.kernel_route(torch.bfloat16, d, 16384, 16384, False).wrappers == ("flash_fwd_nomax",)
    monkeypatch.setattr(pfa, "_ONESHOT", "0")
    monkeypatch.setattr(pfa, "_NOMAX", "0")
    assert pattn.kernel_route(torch.float32, d, 4096, 4096, False).wrappers == ("flash_fwd_online_f32",)
    monkeypatch.setenv("DIFFMINING_ATTN_TLAYOUT", "0")
    assert pattn.kernel_route(torch.float32, d, 4096, 4096, False).wrappers == ("flash_fwd_lse_f32",)
    assert pfa.variant(torch.float32, d) == "_f32" and pfa.variant(torch.bfloat16, d) == ""
    for dtype, dim in ((torch.float32, 72), (torch.bfloat16, 64), (torch.float16, d)):
        with pytest.raises(ValueError, match="head dim 72|head dim 64|float16"):
            pattn.kernel_route(dtype, dim, 4096, 4096, False)
    assert pfn.gn_kernel(torch.float32, torch.float32) == "gn_act_proj_f32"
    assert pfn.gn_kernel(torch.bfloat16, torch.bfloat16) == "gn_act_proj"
    with pytest.raises(ValueError, match="both bf16 or both float32"):
        pfn.gn_kernel(torch.float32, torch.bfloat16)


def test_f32_kernels_are_built_from_their_sources():
    """Each float32 wrapper's source is in the build table with its C entry
    point, and the tile the plain versions use is the kernels' own."""
    for name in ("flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32", "gn_act_proj_f32"):
        assert name in pfa.SOURCES and name in pfa.F32_SOURCES
        assert f'extern "C" int {name}(' in (pfa.CSRC / f"{name}.cu").read_text()
    header = (pfa.CSRC / "flash_f32.cuh").read_text()
    assert int(re.search(r"constexpr int TILE = (\d+);", header).group(1)) == pfa.F32_BLOCK_K
    assert pfa.F32_HEAD_DIMS == (40, 64, 80, 160)
    for fn in (pfa.flash_fwd_lse_f32, pfa.flash_bwd_dq_f32, pfa.flash_bwd_dkv_f32, pfn.gn_act_proj_f32):
        assert isinstance(fn.launches, int)


# Lq 200: three full 64-row q tiles and a tail of 8; Lk 300: four full
# 64-key tiles and a tail of 44 keys
LQ, LK = 200, 300


def _qkvg(d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, 2, n, d).astype(np.float32) for n in (LQ, LK, LK, LQ))


@pytest.mark.parametrize("d", [40, 80, 160])
def test_f32_forward_plain_at_the_kernel_tile_matches_jax(d):
    """K4 (o and lse) and K3 at 64-key blocks, and the no-max K2 over 64-key
    blocks, in interpret mode at float32, against the plain versions at the
    float32 kernels' tile."""
    q, k, v, _ = _qkvg(d, seed=d)
    tr = lambda a: jnp.asarray(a.transpose(0, 1, 3, 2))  # noqa: E731  [B,H,D,L], the TPU layout
    blocks = dict(block_q=64, block_k=pfa.F32_BLOCK_K)
    with pltpu.force_tpu_interpret_mode():
        o4, lse4 = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True, **blocks)
        o3 = jfa._flash_forward_t(tr(q), tr(k), tr(v), oneshot=False, nomax=False, **blocks)
        o2 = jfa._flash_forward_t(tr(q), tr(k), tr(v), oneshot=False, nomax=True, **blocks)
    got_o, got_lse = pfa.flash_fwd_lse_plain(_t(q), _t(k), _t(v), block_k=pfa.F32_BLOCK_K)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o4), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse4), **TOL)
    got3 = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v), block_k=pfa.F32_BLOCK_K)
    np.testing.assert_allclose(got3.numpy(), np.asarray(o3).transpose(0, 1, 3, 2), **TOL)
    got2 = pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v))
    assert got2.dtype == torch.float32
    np.testing.assert_allclose(got2.numpy(), np.asarray(o2).transpose(0, 1, 3, 2), **TOL)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_f32_backward_plain_at_the_kernel_tile_matches_jax(d):
    """K5 and K6 through _bwd_pallas at 64-row and 64-key blocks, float32,
    with q and key tails, against the plain versions (and delta)."""
    q, k, v, g = _qkvg(d, seed=d + 1)
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True)
        jdq, jdk, jdv = jfa._bwd_pallas(None, (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse),
                                        jnp.asarray(g), block_q=64, block_k=pfa.F32_BLOCK_K)
    tq, tk, tv, tg, to_, tl = (_t(np.asarray(a)) for a in (q, k, v, g, o, lse))
    delta = pfa.attention_delta(tg, to_)
    dq = pfa.flash_bwd_dq_plain(tq, tk, tv, tg, tl, delta)
    dk, dv = pfa.flash_bwd_dkv_plain(tq, tk, tv, tg, tl, delta)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BWD_TOL)


@pytest.mark.parametrize("c,act", [(320, "none"), (640, "silu")])
def test_f32_fused_norm_plain_matches_jax(c, act):
    """K7's plain version at float32 (the float32 kernel's arithmetic: the
    same statistics, h unrounded, the product summed in float32) against
    the Pallas K7 in interpret mode at float32."""
    rng = np.random.RandomState(c)
    x = (rng.randn(2, 8, 8, c) * 2 + 0.5).astype(np.float32)
    gamma, beta, bias = (rng.randn(c).astype(np.float32) for _ in range(3))
    w = (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = j_gn_act_proj(*(jnp.asarray(a) for a in (x, gamma, beta, w, bias)), 32, act=act, block_rows=64)
    got = pfn.gn_act_proj_plain(*(_t(a) for a in (x, gamma, beta, w, bias)), 32, act=act)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
