"""The Hopper flash backward's tiles and shared pre-scale, held to the JAX
package on the CPU.

Both backward kernels (K5 dq, K6 dk/dv) read q pre-scaled by
bf16(scale·log2e), formed once a backward by ``prescaled_q`` as
``_bwd_pallas`` forms ``qs_`` (flash_attention.py:673): here it equals
JAX's bit for bit in bf16. The plain versions re-form p from the lse, so
they hold at any tile; what depends on the tiles is whether chip_smoke.py's
bound (two bf16 ulps plus one at the output's scale) would see a kernel
that skips one of them: one q stage of K6 (48 rows at D=40, 64 at D=80,
32 at D=160) and one key stage of K5 (64 keys), read from the kernels'
sources.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffmining_tpu.ops.flash_attention as jfa

from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)
BWD_RTOL = 2.0**-6  # chip_smoke.py's bound for K5/K6 against their plain versions


def _k6_q_tile(d: int) -> int:
    """K6's q rows a stage at head dim d, from csrc/flash_bwd_dkv.cu."""
    src = (pfa.CSRC / "flash_bwd_dkv.cu").read_text()
    at40, at80, other = re.search(r"int NQ = D == 40 \? (\d+) : D == 80 \? (\d+) : (\d+);", src).groups()
    return int({40: at40, 80: at80}.get(d, other))


def _k5_key_tile() -> int:
    """K5's keys a stage, from csrc/flash_bwd_dq.cu."""
    return int(re.search(r"constexpr int NK = (\d+);", (pfa.CSRC / "flash_bwd_dq.cu").read_text()).group(1))


def _over_tolerance(got: torch.Tensor, want: torch.Tensor) -> float:
    w = want.float()
    tol = BWD_RTOL * w.abs() + 2.0**-7 * w.pow(2).mean().sqrt()
    return float(((got.float() - w).abs() / tol).max())


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def test_tiles_read_from_the_sources():
    assert [_k6_q_tile(d) for d in pfa.HEAD_DIMS] == [48, 64, 32]
    assert _k5_key_tile() == 64


@pytest.mark.parametrize("d", [40, 80, 160])
def test_prescaled_q_equals_jax_qs_bit_for_bit(d):
    """prescaled_q on the UNet's [B, L, H*D] layout viewed as [B, H, L, D]
    equals _bwd_pallas's ``q * jnp.asarray(s * LOG2E, q.dtype)`` in bf16
    bit for bit, and keeps the view's strides (the kernels read it in
    place)."""
    b, h, l = 2, 3, 77
    rng = np.random.RandomState(d)
    flat = torch.from_numpy(rng.randn(b, l, h * d).astype(np.float32)).to(torch.bfloat16)
    q = flat.view(b, l, h, d).transpose(1, 2)
    got = pfa.prescaled_q(q)
    assert got.dtype == torch.bfloat16 and got.stride() == q.stride()
    s = 1.0 / d**0.5
    qj = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    want = np.asarray(qj * jnp.asarray(s * jfa.LOG2E, qj.dtype))
    np.testing.assert_array_equal(_bits(got), want.view(np.uint16))
    # and it is the q the plain versions pre-scale
    np.testing.assert_array_equal(_bits(got), _bits(q * pfa._prescale(q, s)))


@pytest.mark.parametrize("l,d", [(1024, 40), (300, 80), (300, 160)])
def test_bwd_bound_catches_a_dropped_tile_at_the_kernel_tiles(l, d):
    """A K5 that skips one key stage, or a K6 that skips one q stage (the
    second of each), is far outside the bound that holds the kernels to
    their plain versions."""
    rng = np.random.RandomState(l + d)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 2, l, d).astype(np.float32)).to(torch.bfloat16) for _ in range(4))
    o, lse = pfa.flash_fwd_lse_plain(q, k, v, block_k=pfa.ONLINE_BLOCK_K)
    delta = pfa.attention_delta(g, o)

    nk = _k5_key_tile()
    keep_k = torch.cat([torch.arange(0, nk), torch.arange(2 * nk, l)])
    dq = pfa.flash_bwd_dq_plain(q, k, v, g, lse, delta)
    dq_dropped = pfa.flash_bwd_dq_plain(q, k[:, :, keep_k], v[:, :, keep_k], g, lse, delta)
    assert _over_tolerance(dq_dropped, dq) > 50

    nq = _k6_q_tile(d)
    keep_q = torch.cat([torch.arange(0, nq), torch.arange(2 * nq, l)])
    dk, dv = pfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta)
    dk_dropped, dv_dropped = pfa.flash_bwd_dkv_plain(q[:, :, keep_q], k, v, g[:, :, keep_q], lse[:, :, keep_q],
                                                     delta[:, :, keep_q])
    assert _over_tolerance(dk_dropped, dk) > 50
    assert _over_tolerance(dv_dropped, dv) > 50

