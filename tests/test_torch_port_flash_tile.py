"""The key tile of the port's online-softmax forward (K3 and K4), held to
the JAX package on the CPU.

The CUDA kernel rounds p to bf16 relative to the running max of each of its
``ONLINE_BLOCK_K``-key tiles, so its plain versions are exact for it only at
that block size. Here the plain versions at ``block_k=ONLINE_BLOCK_K``
equal the Pallas kernels run at the same key block in interpret mode, in
float32 at rtol 1e-5 (summation order only), for head dims 40, 80 and 160
with a q tail and a masked key tail: K4 through ``_flash_forward(...,
return_lse=True)``, K3 through ``_flash_forward_t``. And the constant
agrees with the kernel's own tile in ``csrc/flash_fwd_online.cuh``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import diffmining_tpu.ops.flash_attention as jfa

from diffmining_tpu_torch.ops import flash_attention as pfa

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=2e-6)
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


def test_online_block_k_is_the_kernel_tile():
    src = (pfa.CSRC / "flash_fwd_online.cuh").read_text()
    assert int(re.search(r"constexpr int BLOCK_N = (\d+);", src).group(1)) == pfa.ONLINE_BLOCK_K


@pytest.mark.parametrize("d", [40, 80, 160])
def test_lse_plain_at_the_kernel_tile_matches_jax(d):
    q, k, v = _qkv(d, seed=d)
    with pltpu.force_tpu_interpret_mode():
        o, lse = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                                    block_k=pfa.ONLINE_BLOCK_K, return_lse=True)
    got_o, got_lse = pfa.flash_fwd_lse_plain(_t(q), _t(k), _t(v), block_k=pfa.ONLINE_BLOCK_K)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), **TOL)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_online_plain_at_the_kernel_tile_matches_jax_t(d):
    q, k, v = _qkv(d, seed=d + 1)
    tr = lambda a: jnp.asarray(a.transpose(0, 1, 3, 2))  # noqa: E731  [B,H,D,L], the TPU layout
    with pltpu.force_tpu_interpret_mode():
        o = jfa._flash_forward_t(tr(q), tr(k), tr(v), block_q=128, block_k=pfa.ONLINE_BLOCK_K, oneshot=False,
                                 nomax=False)
    got = pfa.flash_fwd_online_plain(_t(q), _t(k), _t(v), block_k=pfa.ONLINE_BLOCK_K)
    np.testing.assert_allclose(got.numpy(), np.asarray(o).transpose(0, 1, 3, 2), **TOL)
