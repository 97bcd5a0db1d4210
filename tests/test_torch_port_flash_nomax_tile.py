"""The no-max forward's tiles (K1 and K2), held to the JAX package on the CPU.

The CUDA kernel for K1 and K2 is the online forward's loop in its no-max
mode: it walks the keys in ``ONLINE_BLOCK_K``-key tiles, rounds p to bf16
tile by tile and adds each tile's rounded p and p.v to the sums it carries.
With no running max nothing else is carried, so the tile size enters no
rounding and the plain version, ``flash_attention_nomax_plain``, needs no
tile constant. Here that arithmetic, written out tile by tile in the
kernel's order, equals the plain version and the Pallas no-max kernel run
at a 128-key block in interpret mode, in float32 at rtol 1e-5 (summation
order only), for head dims 40, 80 and 160 with a q tail and a masked key
tail; in bf16 it equals the plain version to one bf16 ulp. A row whose
natural logits all lie below -87 gives zeros in all three.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.flash_attention as jfa

from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
TILE = pfa.ONLINE_BLOCK_K  # the kernel's key tile (BLOCK_N in csrc/flash_fwd_online.cuh)
# Lq 200: a full 128-row q tile and a tail; Lk 300: two full key tiles and a
# tail of 44 keys masked in the third
LQ, LK = 200, 300


def _qkv(d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, 2, LQ, d).astype(np.float32)
    k = rng.randn(1, 2, LK, d).astype(np.float32)
    v = rng.randn(1, 2, LK, d).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nomax_by_tiles(q, k, v, tile=TILE):
    """The kernel's no-max loop: q pre-scaled by scale*log2e in q's dtype;
    for each key tile, p = exp2(qs.k^T) with results below 2^-126 flushed
    to 0, rounded to v's dtype, added to l and, times v, to acc; then
    o = acc * (1 / max(l, 1e-30)) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = (q * torch.tensor(scale * math.log2(math.e), dtype=q.dtype).item()).float()
    acc = torch.zeros(q.shape, dtype=torch.float32)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32)
    for j in range(0, k.shape[2], tile):
        p = torch.exp2(torch.matmul(qs, k[:, :, j:j + tile].float().transpose(-1, -2)))
        pb = torch.where(p < torch.finfo(torch.float32).tiny, torch.zeros_like(p), p).to(v.dtype).float()
        acc = acc + torch.matmul(pb, v[:, :, j:j + tile].float())
        l = l + pb.sum(dim=-1)
    return (acc * (1.0 / l.clamp_min(1e-30))[..., None]).to(q.dtype)


def _jax_nomax(q, k, v):
    """The Pallas no-max kernel (_flash_kernel_t_nomax) at the kernel's key
    block, interpret mode, on the TPU layout [B,H,D,L]; back to [B,H,L,D]."""
    tr = lambda a: jnp.asarray(a.transpose(0, 1, 3, 2))  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_t(tr(q), tr(k), tr(v), block_q=128, block_k=TILE, oneshot=False, nomax=True)
    return np.asarray(o).transpose(0, 1, 3, 2)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_tiles_equal_the_plain_version(d):
    q, k, v = (_t(a) for a in _qkv(d, seed=d))
    got = _nomax_by_tiles(q, k, v)
    np.testing.assert_allclose(got.numpy(), pfa.flash_attention_nomax_plain(q, k, v).numpy(), **TOL)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_tiles_equal_the_plain_version_in_bf16(d):
    """bf16 operands: p is rounded to bf16 at the same places tile by tile
    as over the whole row, so the two differ only where the fp32 summation
    order flips the final rounding: one bf16 ulp (2^-8 relative) at most."""
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(d, seed=d + 3))
    got = _nomax_by_tiles(q, k, v).float()
    want = pfa.flash_attention_nomax_plain(q, k, v).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2.0**-8, atol=2.0**-8 * float(want.abs().max()))
    assert float((got == want).float().mean()) > 0.99


@pytest.mark.parametrize("d", [40, 80, 160])
def test_tiles_equal_the_pallas_nomax_kernel(d):
    q, k, v = _qkv(d, seed=d + 1)
    got = _nomax_by_tiles(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), _jax_nomax(q, k, v), **TOL)


def test_underflow_row_is_zeros_by_tiles():
    """Every natural logit -95: exp2 underflows, so the kernel's loop, the
    plain version and the Pallas kernel all give zeros (the designed edge)."""
    d = 40
    q = np.zeros((1, 1, LQ, d), np.float32)
    k = np.zeros((1, 1, LK, d), np.float32)
    q[..., 0] = -95.0 * np.sqrt(d)
    k[..., 0] = 1.0
    v = np.random.RandomState(12).randn(1, 1, LK, d).astype(np.float32)
    for got in (_nomax_by_tiles(_t(q), _t(k), _t(v)).numpy(),
                pfa.flash_attention_nomax_plain(_t(q), _t(k), _t(v)).numpy(), _jax_nomax(q, k, v)):
        assert np.abs(got).max() == 0.0
