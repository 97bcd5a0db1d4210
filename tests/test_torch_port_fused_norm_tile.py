"""The statistics and the tiling of the port's K7 call, held to the JAX
package on the CPU.

``group_stats_plain`` repeats the CUDA statistics kernel's order (runs of 8
elements in memory order, Chan's centred merge a thread, a shuffle-down
tree). It is held to JAX's fp32 mean and variance (fused_norm.py:69-71, the
mean of squared deviations) in both layouts the UNet hands the kernel and at
a ragged pixel count, on data of unit scale and on data whose mean is large
against its spread (300 + randn). The tolerances: |mean - jax| <= 2^-21
max|x| (four fp32 ulps of the largest element: the same sums in another
order) and |rsig / jax - 1| <= 2^-17. A one-pass E[x^2] - E[x]^2 in fp32
loses the variance's digits on the large-mean data and lands over 20x
outside the rsig bound.

``gn_act_proj_tiled`` is the projection kernel's tiling (``plan``: pixel
tiles x Cout splits x B, h normalised once a block, Cout tiles summed over
64-channel K chunks); it is held to ``gn_act_proj_plain`` at
chip_smoke.py's K7 bound (one bf16 ulp of the product and of the result),
and a skipped Cout tile lands far outside it.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffmining_tpu_torch.ops import flash_attention as pfa
from diffmining_tpu_torch.ops import fused_norm as pfn

torch.set_num_threads(1)
ULP = 2.0**-7
MEAN_TOL = 2.0**-21  # of max |x|
RSIG_RTOL = 2.0**-17


def _x(b, hh, ww, c, layout, data, seed=0):
    """x [B, H, W, C] as the UNet hands it: NCHW viewed as NHWC, or
    channels-last; float32."""
    rng = np.random.RandomState(seed)
    a = rng.randn(b, c, hh, ww).astype(np.float32)
    a = 300.0 + a if data == "large_mean" else 2.0 * a + 0.5
    t = torch.from_numpy(a)
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    return t.permute(0, 2, 3, 1)


def _jax_stats(x, groups, eps=1e-6):
    """fused_norm.py:69-72 on x [B, H, W, C]: per-group mean and rsigma [B, G]."""
    b, hh, ww, c = x.shape
    xg = jnp.asarray(x.contiguous().numpy()).reshape(b, hh * ww, groups, c // groups)
    return np.asarray(xg.mean(axis=(1, 3))), np.asarray(jax.lax.rsqrt(xg.var(axis=(1, 3)) + eps))


def _stats_error(mean, rsig, x, groups):
    """(max |mean - jax| / max|x|, max |rsig / jax - 1|), per-channel
    statistics [B, C] read at each group's first channel."""
    jm, jr = _jax_stats(x, groups)
    cg = x.shape[3] // groups
    m, r = np.asarray(mean)[:, ::cg], np.asarray(rsig)[:, ::cg]
    return float(np.abs(m - jm).max() / x.abs().max()), float(np.abs(r / jr - 1).max())


# C 80 in 8 groups: 10 channels a group, so a run of 8 straddles pixels in
# channels-last x; N 21x23 = 483 (no multiple of 8): 4,830 elements a group,
# 604 runs, so threads 0-91 load two runs (t and t + 512) and the last run
# holds 6 elements
@pytest.mark.parametrize("data", ["unit", "large_mean"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
def test_group_stats_plain_matches_jax(layout, data):
    x = _x(2, 21, 23, 80, layout, data)
    mean, rsig = pfn.group_stats_plain(x, 8, 1e-6)
    assert mean.shape == rsig.shape == (2, 80) and mean.dtype == torch.float32
    mean_err, rsig_err = _stats_error(mean, rsig, x, 8)
    assert mean_err <= MEAN_TOL and rsig_err <= RSIG_RTOL


def test_one_pass_variance_fails_the_stats_bound():
    """The control: E[x^2] - E[x]^2 in fp32 on the large-mean data loses
    the variance's digits and lands outside the rsig bound."""
    x = _x(2, 21, 23, 80, "nchw", "large_mean")
    b, hh, ww, c = x.shape
    xg = x.reshape(b, hh * ww, 8, c // 8).permute(0, 2, 1, 3).reshape(b, 8, -1)
    mean = xg.mean(-1)
    rsig = 1.0 / torch.sqrt((xg * xg).mean(-1) - mean * mean + 1e-6)
    per_channel = [s[:, :, None].expand(b, 8, c // 8).reshape(b, c) for s in (mean, rsig)]
    _, rsig_err = _stats_error(*per_channel, x, 8)
    assert rsig_err > 20 * RSIG_RTOL


def test_group_stats_plain_on_bf16_takes_the_exact_values():
    """bf16 x goes in as its exact fp32 values: the same statistics as the
    float32 copy, bit for bit, in either layout."""
    for layout in ("nchw", "channels_last"):
        x = _x(1, 9, 7, 64, layout, "large_mean").to(torch.bfloat16)
        got = pfn.group_stats_plain(x, 32, 1e-6)
        want = pfn.group_stats_plain(x.float(), 32, 1e-6)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def _operands(b, hh, ww, c, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.randn(b, c, hh, ww) * 2.0 + 0.5).astype(np.float32)).to(torch.bfloat16)
    x = x.permute(0, 2, 3, 1)
    gamma, beta, bias = (torch.from_numpy((s * rng.randn(n) + o).astype(np.float32)).to(torch.bfloat16)
                         for s, o, n in ((0.3, 1.0, c), (0.3, 0.0, c), (0.5, 0.0, cout)))
    w = torch.from_numpy((rng.randn(c, cout) / np.sqrt(c)).astype(np.float32)).to(torch.bfloat16)
    return x, gamma, beta, w, bias


def _over_bound(got, want, bias):
    w = want.float()
    tol = ULP * (w.abs() + (w - bias.float()).abs()) + ULP * w.pow(2).mean().sqrt()
    return float(((got.float() - w).abs() / tol).max())


@pytest.mark.parametrize("shape,tiling", [
    # N 600 (a ragged 128-pixel tile), Cout 320 in two 160-wide tiles: the plan's split, then two splits
    ((2, 20, 30, 128, 320), None),
    ((2, 20, 30, 128, 320), pfn.Plan(128, 2, 2)),
    # C 320 = Cout, 64 pixels a block (each warpgroup half of a tile); then the ring's one tile a block
    ((1, 10, 10, 320, 320), pfn.Plan(64, 1, 2)),
    ((1, 10, 10, 320, 320), pfn.Plan(128, 2, 3, True)),
])
@pytest.mark.parametrize("act", ["none", "silu"])
def test_tiled_model_matches_plain(shape, tiling, act):
    ops = _operands(*shape, seed=11)
    want = pfn.gn_act_proj_plain(*ops, 32, act=act)
    got = pfn.gn_act_proj_tiled(*ops, 32, act=act, tiling=tiling)
    assert got.shape == want.shape
    assert _over_bound(got, want, ops[4]) <= 1.0
    assert float((got == want).float().mean()) > 0.97


def test_plan_at_the_unet_entries():
    """The four SpatialTransformer entries of a 512px pass at batch 8 on 132
    SMs: 128-pixel slabs at C320 and C640, one block covering all of Cout
    at level 0 and half of it at level 1; at C1280, where no slab fits, a
    ring of x and w chunks and one Cout tile a block. Every block fits in
    shared memory with two or more stages."""
    got = {}
    for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        p = pfn.plan(8, n, c, c)
        assert 2 <= p.stages <= pfn.MAX_STAGES
        assert pfn.smem_bytes(c, p.bm, p.stages, p.ring) <= pfn.SMEM_LIMIT
        assert pfn.smem_bytes(c, p.bm, p.stages + 1, p.ring) > pfn.SMEM_LIMIT or p.stages == pfn.MAX_STAGES
        assert (c // pfn.TILE_N) % p.splits == 0
        got[n] = (p.bm, p.ring, p.splits, -(-n // p.bm) * 8 * p.splits)
    assert got == {4096: (128, False, 1, 256), 1024: (128, False, 2, 128), 256: (128, True, 8, 128),
                   64: (64, True, 8, 64)}


def test_constants_match_the_kernel_source():
    src = (pfa.CSRC / "gn_act_proj.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("K_TILE") == pfn.K_TILE and const("TILE_N") == pfn.TILE_N
    assert const("STATS_THREADS") == pfn.STATS_THREADS
    assert const("SMEM_LIMIT") == pfn.SMEM_LIMIT and const("MAX_CHUNKS") == pfn.MAX_CHUNKS
    assert const("STATS_UNROLL") == pfn.STATS_UNROLL
