"""The port's CUDA kernels on a GPU (every test is marked ``cuda`` and skips
where there is no CUDA device): each kernel against its plain PyTorch
version at the shapes its path gives it, and the attention dispatch under
grad. This file imports neither JAX nor the JAX package, so on a machine
with a GPU and no JAX it runs on its own, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

The bounds are chip_smoke.py's: |kernel - plain| <= rtol |plain| + 2^-7
rms(plain). For the forwards rtol is 2^-7, one bf16 ulp of the element
(both round the same fp32 result to bf16, where summation order or
ex2.approx may flip a rounding); K3 and K4 are held to their plain
versions at the kernel's own key tiles (``ONLINE_BLOCK_K``), where p is
rounded relative to the same running max. The backward kernels also round p and ds to bf16
inside their sums, so a flipped rounding there moves the fp32 sum before
the final rounding: rtol 2^-6, two ulps. The fused-QKV-view check of K1/K2
adds what one flipped bf16 rounding of a row's largest p can move an
output by (``_over_p_flip_bound``). K7 rounds its product to bf16 and then adds the bias in
bf16, so a flipped rounding of the product is one ulp of the product,
|plain - bias|, which the bias can cancel down to a smaller result: its
bound adds 2^-7 |plain - bias|. The float32 kernels (``flash_fwd_f32``
in its three modes, ``flash_bwd_dq_f32``, ``flash_bwd_dkv_f32`` and
``gn_act_proj_f32``) compute their plain versions' float32 arithmetic in
another order, with TF32 off on both sides: 2^-14 |plain| + 2^-14 rms, and
the lse within 2^-14 max(1, |lse|); K5's delta within 2^-15 of
sum_d |dO o| as in bf16.
"""
import math

import pytest
import torch

from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa
from diffmining_tpu_torch.ops import fused_norm as pfn

BWD_RTOL = 2.0**-6


def _over_tolerance(got: torch.Tensor, want: torch.Tensor, rtol: float = 2.0**-7, rounded_before=None) -> float:
    w = want.float()
    mag = w.abs() if rounded_before is None else w.abs() + rounded_before.float().abs()
    tol = rtol * mag + 2.0**-7 * w.pow(2).mean().sqrt()
    return float(((got.float() - w).abs() / tol).max())


def _delta_over_tolerance(got: torch.Tensor, g: torch.Tensor, o: torch.Tensor) -> float:
    """K5's delta against attention_delta, in units of chip_smoke.py's bound:
    2^-15 of sum_d |dO o| (the same exact fp32 products summed in another
    order differ by at most 2 (D - 1) 2^-24 of it)."""
    want = pfa.attention_delta(g, o)
    return float(((got - want).abs() / ((g.float() * o.float()).abs().sum(-1) * 2.0**-15)).max())


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _operands(b, h, l, d, n, seed=0):
    """n [B, L, H*D] bf16 tensors viewed as [B, H, L, D], as the UNet hands them over."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(b, l, h * d, generator=gen, device="cuda").to(torch.bfloat16)
            .view(b, l, h, d).transpose(1, 2) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,h,l,d",
    [(2, 8, 4096, 40), (2, 8, 1024, 80), (1, 8, 1000, 160), (1, 2, 16384, 40)],
)
def test_kernel_matches_plain_on_card(b, h, l, d):
    """The CUDA kernel against its plain version on a GPU. Both round the
    same fp32 result to bf16, so they may differ by one bf16 ulp of the
    element (<= 2^-7 relative) where summation order or ex2.approx flips a
    rounding; the atol is one ulp at the output's scale (chip_smoke.py
    holds the kernel to the same bound)."""
    _needs_gpu()
    q, k, v = _operands(b, h, l, d, 3)
    got = pfa.flash_fwd_nomax(q, k, v)
    want = pfa.flash_attention_nomax_plain(q, k, v)
    rms = float(want.float().pow(2).mean().sqrt())
    torch.testing.assert_close(got.float(), want.float(), atol=2.0**-7 * rms, rtol=2.0**-7)
    scale = 1.0 / math.sqrt(d)
    ref = torch.nn.functional.scaled_dot_product_attention(q.float(), k.float(), v.float(), scale=scale)
    torch.testing.assert_close(got.float(), ref, atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,l,d", [(4, 8, 4096, 40), (4, 8, 1024, 80), (2, 8, 1000, 40), (2, 8, 1100, 160)])
def test_training_kernels_match_plain_on_card(b, h, l, d):
    """K4, K5 and K6 against their plain versions on a GPU, within the
    bounds of chip_smoke.py; K4 against the plain version at its own key
    tiles."""
    _needs_gpu()
    q, k, v, g = _operands(b, h, l, d, 4)
    o, lse = pfa.flash_fwd_lse(q, k, v)
    o_plain, lse_plain = pfa.flash_fwd_lse_plain(q, k, v, block_k=pfa.ONLINE_BLOCK_K)
    assert _over_tolerance(o, o_plain) <= 1.0
    torch.testing.assert_close(lse, lse_plain, rtol=1e-4, atol=1e-4)
    delta = pfa.attention_delta(g, o)
    qs = pfa.prescaled_q(q)
    dq, delta_k = pfa.flash_bwd_dq(q, k, v, g, o, lse, qs)
    assert _over_tolerance(dq, pfa.flash_bwd_dq_plain(q, k, v, g, lse, delta), BWD_RTOL) <= 1.0
    assert _delta_over_tolerance(delta_k, g, o) <= 1.0
    dk, dv = pfa.flash_bwd_dkv(q, k, v, g, lse, delta, qs)
    dk_plain, dv_plain = pfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta)
    assert _over_tolerance(dk, dk_plain, BWD_RTOL) <= 1.0 and _over_tolerance(dv, dv_plain, BWD_RTOL) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,d", [(1000, 1000, 40), (1100, 1100, 160), (1090, 1090, 80), (300, 1100, 80),
                                     (1100, 300, 40)])
def test_backward_kernels_match_plain_on_ragged_lengths_on_card(lq, lk, d):
    """K5 and K6 at their Hopper tiles (64-key stages of K5; q stages of K6
    of 48 rows at D=40, 64 at D=80, 32 at D=160) on lengths that leave a
    partial tile of q rows, of keys or of both, on the UNet's [B, L, H*D]
    views, with the pre-scaled q that the backward forms once for both:
    within the two-ulp bound of their plain versions, and K5's delta within
    its bound of attention_delta."""
    _needs_gpu()
    q, g = _operands(2, 8, lq, d, 2, seed=lq)
    k, v = _operands(2, 8, lk, d, 2, seed=lk + 1)
    o, lse = pfa.flash_fwd_lse(q, k, v)
    delta = pfa.attention_delta(g, o)
    qs = pfa.prescaled_q(q)
    assert qs.stride() == q.stride()
    dq, delta_k = pfa.flash_bwd_dq(q, k, v, g, o, lse, qs)
    dk, dv = pfa.flash_bwd_dkv(q, k, v, g, lse, delta, qs)
    assert delta_k.shape == delta.shape and _delta_over_tolerance(delta_k, g, o) <= 1.0
    dk_plain, dv_plain = pfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert _over_tolerance(dq, pfa.flash_bwd_dq_plain(q, k, v, g, lse, delta), BWD_RTOL) <= 1.0
    assert _over_tolerance(dk, dk_plain, BWD_RTOL) <= 1.0 and _over_tolerance(dv, dv_plain, BWD_RTOL) <= 1.0


@pytest.mark.cuda
def test_backward_with_a_non_contiguous_dO_on_card():
    """dO as the kernels may meet it: an aligned strided view handed straight
    to the wrappers, and one whose head dim is strided (not aligned) through
    the autograd Function, which copies it first. Both within the two-ulp
    bound of the plain versions on the contiguous dO."""
    _needs_gpu()
    b, h, l, d = 2, 8, 1024, 80
    leaves = [t.detach().requires_grad_(True) for t in _operands(b, h, l, d, 3, seed=5)]
    q, k, v = leaves
    o, lse = pfa.flash_fwd_lse(q, k, v)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    g_view = torch.randn(b, l, h, d, generator=gen, device="cuda").to(torch.bfloat16).transpose(1, 2)
    g_wide = torch.randn(b, h, l, 2 * d, generator=gen, device="cuda").to(torch.bfloat16)[..., ::2]
    assert not g_view.is_contiguous() and g_wide.stride(3) == 2
    for g in (g_view, g_wide):
        gc = g.contiguous()
        delta = pfa.attention_delta(gc, o)
        want = (pfa.flash_bwd_dq_plain(q, k, v, gc, lse, delta), *pfa.flash_bwd_dkv_plain(q, k, v, gc, lse, delta))
        if g is g_view:
            qs = pfa.prescaled_q(q)
            dq, delta_k = pfa.flash_bwd_dq(q, k, v, g, o, lse, qs)
            got = (dq, *pfa.flash_bwd_dkv(q, k, v, g, lse, delta_k, qs))
        else:
            got = torch.autograd.grad(pfa.flash_attention(q, k, v), leaves, g)
        assert all(_over_tolerance(a, w, BWD_RTOL) <= 1.0 for a, w in zip(got, want))


@pytest.mark.cuda
def test_dispatch_under_grad_on_card():
    """On a GPU: the gated UNet shape under grad goes through the autograd
    Function and launches K4, K5 and K6 once each; without grad, the no-max
    kernel; flash_fwd_nomax itself raises under grad."""
    _needs_gpu()
    leaves = [torch.randn(2, 1024, 8 * 80, device="cuda").to(torch.bfloat16).requires_grad_(True) for _ in range(3)]
    q, k, v = (t.view(2, 1024, 8, 80).transpose(1, 2) for t in leaves)
    before = [f.launches for f in (pfa.flash_fwd_lse, pfa.flash_bwd_dq, pfa.flash_bwd_dkv, pfa.flash_fwd_nomax)]
    out = pattn.sdpa(q, k, v)
    out.float().sum().backward()
    with torch.no_grad():
        pattn.sdpa(q, k, v)
    after = [f.launches for f in (pfa.flash_fwd_lse, pfa.flash_bwd_dq, pfa.flash_bwd_dkv, pfa.flash_fwd_nomax)]
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 1]
    assert all(t.grad is not None and float(t.grad.float().abs().max()) > 0 for t in leaves)
    with pytest.raises(RuntimeError, match="no backward"):
        pfa.flash_fwd_nomax(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("lq,lk", [(200, 300), (1000, 1000), (4096, 4096)])
def test_nomax_kernel_matches_plain_on_ragged_lengths_on_card(lq, lk, d):
    """K1/K2 at lengths that are no multiple of its q block (256, 192 or 128
    rows at D=40, 80, 160) or of its 128-key tile, and with Lq != Lk, on the
    UNet's [B, L, H*D] views, against the plain version at the one-ulp
    bound."""
    _needs_gpu()
    (q,) = _operands(2, 8, lq, d, 1, seed=4)
    k, v = _operands(2, 8, lk, d, 2, seed=5)
    got = pfa.flash_fwd_nomax(q, k, v)
    assert got.shape == q.shape
    assert _over_tolerance(got, pfa.flash_attention_nomax_plain(q, k, v)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_nomax_kernel_reads_a_fused_qkv_view_on_card(d):
    """q, k and v as slices of one [B, L, 3*H*D] projection, viewed as
    [B, H, L, D] (rows 3*H*D apart, not contiguous), as a fused QKV
    projection hands them over: the kernel reads them in place and agrees
    with the plain version on contiguous copies, within one ulp plus what a
    flipped rounding of a row's largest p can move (``_over_p_flip_bound``:
    at D=80 the plain version's fp32 logits flip a p of 71 in a sum of
    1728.2, 1.0184x the one-ulp bound)."""
    _needs_gpu()
    q, k, v = _fused_qkv(2, 8, 1000, d, 6)
    assert not q.is_contiguous() and q.stride(2) == 3 * 8 * d
    got = pfa.flash_fwd_nomax(q, k, v)
    assert torch.equal(got, pfa.flash_fwd_nomax(q.contiguous(), k.contiguous(), v.contiguous()))
    want = pfa.flash_attention_nomax_plain(q.contiguous(), k.contiguous(), v.contiguous())
    ratio = _over_p_flip_bound(got, want, q, k, v)
    print(f"fused view D{d} seed 6: {_over_tolerance(got, want):.4f} x the one-ulp bound, {ratio:.4f} x the p-flip bound")
    assert ratio <= 1.0, _worst_against_float64(got, want, q, k, v)


def _fused_qkv(b, h, l, d, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    qkv = torch.randn(b, l, 3 * h * d, generator=gen, device="cuda").to(torch.bfloat16)
    return [qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d).transpose(1, 2) for i in range(3)]


def _over_p_flip_bound(got, want, q, k, v) -> float:
    """|kernel - plain| in units of the one-ulp bound widened by what one
    flipped bf16 rounding of a row's largest p can move an output by: either
    side's fp32 logits may round a p = exp2(s) to the other bf16 neighbour,
    which moves o = sum p v / l by ulp(p) (v - o) / l. Per row, the term is
    one bf16 ulp of the row's largest p (p from the same arithmetic in
    float64: the pre-scale in bf16, exact logits and exp2, p rounded to
    bf16) times max |v - o| over the keys, over the row's sum l."""
    w = want.float()
    qs = pfa.prescaled_q(q.contiguous()).double()
    p = torch.exp2(qs @ k.double().transpose(-1, -2)).to(torch.bfloat16).double()
    l = p.sum(-1, keepdim=True)
    pmax = p.amax(-1, keepdim=True)
    ulp = torch.exp2(torch.floor(torch.log2(pmax)) - 7)
    vd = v.double()
    spread = torch.maximum(vd.amax(-2, keepdim=True) - w.double(), w.double() - vd.amin(-2, keepdim=True))
    tol = 2.0**-7 * w.abs() + 2.0**-7 * w.pow(2).mean().sqrt() + (ulp * spread / l).float()
    return float(((got.float() - w).abs() / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_p_flip_bound_on_five_seeds_on_card(d):
    """The fused-view check's bound on seeds 0-4: every reading at or under
    1, printed beside the one-ulp bound's (run with -s to see them)."""
    _needs_gpu()
    for seed in range(5):
        q, k, v = _fused_qkv(2, 8, 1000, d, seed)
        got = pfa.flash_fwd_nomax(q, k, v)
        want = pfa.flash_attention_nomax_plain(q.contiguous(), k.contiguous(), v.contiguous())
        old, new = _over_tolerance(got, want), _over_p_flip_bound(got, want, q, k, v)
        print(f"fused view D{d} seed {seed}: {old:.4f} x the one-ulp bound, {new:.4f} x the p-flip bound")
        assert new <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_p_flip_bound_catches_a_dropped_key_tile_on_card(d):
    """The control: the kernel run without keys 128-255 (one 128-key tile)
    lands far outside the widened bound against the plain version on all
    the keys."""
    _needs_gpu()
    q, k, v = _fused_qkv(2, 8, 1000, d, 6)
    want = pfa.flash_attention_nomax_plain(q.contiguous(), k.contiguous(), v.contiguous())
    k2, v2 = (torch.cat([t[:, :, :128], t[:, :, 256:]], dim=2) for t in (k, v))
    dropped = pfa.flash_fwd_nomax(q, k2, v2)
    ratio = _over_p_flip_bound(dropped, want, q, k, v)
    print(f"fused view D{d}, keys 128-255 dropped: {ratio:.4g} x the p-flip bound")
    assert ratio > 5.0


def _worst_against_float64(got, want, q, k, v) -> str:
    """The element furthest outside the bound, with the same arithmetic in
    float64 (the pre-scale in bf16, exact logits and exp2, p rounded to
    bf16) beside the kernel and the plain version: which of them moved."""
    w = want.float()
    r = (got.float() - w).abs() / (2.0**-7 * w.abs() + 2.0**-7 * w.pow(2).mean().sqrt())
    bi, hi, li, di = (int(i) for i in torch.unravel_index(r.argmax(), r.shape))
    qs = pfa.prescaled_q(q[bi:bi + 1, hi:hi + 1, li:li + 1])[0, 0, 0].double()
    p = torch.exp2(k[bi, hi].double() @ qs).to(torch.bfloat16).double()
    exact = float((p @ v[bi, hi].double())[di] / p.sum())
    return (f"element {(bi, hi, li, di)}: {float(r.max()):.4f} x the bound; kernel {float(got[bi, hi, li, di]):.8g}, "
            f"plain {float(want[bi, hi, li, di]):.8g}, float64 {exact:.8g}; largest p {float(p.max()):.4g} of sum {float(p.sum()):.6g}")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,l,d", [(2, 8, 4096, 40), (2, 8, 1100, 160)])
def test_online_kernel_matches_plain_on_card(b, h, l, d):
    """K3 against its plain version at the kernel's own key tiles: a main
    shape and a masked key tail."""
    _needs_gpu()
    q, k, v = _operands(b, h, l, d, 3)
    got = pfa.flash_fwd_online(q, k, v)
    assert _over_tolerance(got, pfa.flash_fwd_online_plain(q, k, v, block_k=pfa.ONLINE_BLOCK_K)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,d", [(1000, 1100, 40), (1100, 1000, 80), (200, 300, 160), (4096, 4096, 40)])
def test_online_forwards_match_plain_at_the_kernel_tile_on_card(lq, lk, d):
    """K4 and K3 against their plain versions at ONLINE_BLOCK_K on the
    UNet's [B, L, H*D] views (head dim contiguous, rows H*D apart): q
    lengths that are no multiple of the 128-row q tile, masked key tails,
    and head dims 40, 80 and 160."""
    _needs_gpu()
    (q,) = _operands(2, 8, lq, d, 1, seed=1)
    k, v = _operands(2, 8, lk, d, 2, seed=2)
    o, lse = pfa.flash_fwd_lse(q, k, v)
    o3 = pfa.flash_fwd_online(q, k, v)
    o_plain, lse_plain = pfa.flash_fwd_lse_plain(q, k, v, block_k=pfa.ONLINE_BLOCK_K)
    assert o.shape == o3.shape == q.shape and lse.shape == q.shape[:3]
    assert _over_tolerance(o, o_plain) <= 1.0 and _over_tolerance(o3, o_plain) <= 1.0
    torch.testing.assert_close(lse, lse_plain, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_online_forwards_stay_the_softmax_at_the_underflow_edge_on_card():
    """Every natural logit -95: exp2 without the max underflows to zero
    (the no-max kernel's designed edge), while K3 and K4 keep the running
    max and give the softmax, as their plain versions do."""
    _needs_gpu()
    d, l = 40, 1024
    q = torch.zeros(1, 2, l, d, device="cuda")
    k = torch.zeros(1, 2, l, d, device="cuda")
    q[..., 0] = -95.0 * math.sqrt(d)
    k[..., 0] = 1.0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    v = torch.randn(1, 2, l, d, generator=gen, device="cuda")
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    softmax = pattn.sdpa_plain(q.float(), k.float(), v.float())
    want, _ = pfa.flash_fwd_lse_plain(q, k, v, block_k=pfa.ONLINE_BLOCK_K)
    for got in (pfa.flash_fwd_lse(q, k, v)[0], pfa.flash_fwd_online(q, k, v)):
        assert float(got.float().abs().max()) > 0
        assert _over_tolerance(got, want) <= 1.0
        assert float((got.float() - softmax).abs().max()) <= 2.0**-7 * float(softmax.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,hh,ww,c,act,layout", [
    (4, 64, 64, 320, "none", "nchw"), (2, 63, 65, 320, "none", "nchw"), (2, 8, 8, 1280, "silu", "nchw"),
    (2, 32, 32, 640, "none", "channels_last"), (2, 33, 31, 640, "silu", "channels_last"),
    (2, 64, 64, 320, "none", "channels_last"), (2, 63, 65, 320, "none", "channels_last"),
    (2, 16, 16, 1280, "none", "nchw"), (2, 16, 16, 1280, "none", "channels_last"), (8, 8, 8, 1280, "silu", "nchw"),
])
def test_fused_norm_kernel_matches_plain_on_card(b, hh, ww, c, act, layout):
    """K7 on the UNet's activations viewed as NHWC, in both layouts the UNet
    hands it (NCHW, and channels-last after a transformer's proj_out): the
    512px level-0 entry (C320 in 32 groups, 10 channels a group, in both
    layouts), odd pixel counts (N4095 in both layouts: element loads for
    NCHW), C1280 (x streamed in chunks beside w) and the mid block's 8x8
    with the SiLU variant."""
    _needs_gpu()
    x, gamma, beta, w, bias = _gn_operands(b, hh, ww, c, layout, 2.0, 0.5)
    got = pfn.gn_act_proj(x, gamma, beta, w, bias, 32, act=act)
    want = pfn.gn_act_proj_plain(x, gamma, beta, w, bias, 32, act=act)
    assert got.shape == (b, hh, ww, c) and _over_tolerance(got, want, rounded_before=want.float() - bias.float()) <= 1.0


def _gn_operands(b, hh, ww, c, layout, scale, mean):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    x = (torch.randn(b, c, hh, ww, generator=gen, device="cuda") * scale + mean).to(torch.bfloat16)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    gamma, beta, bias = (torch.randn(c, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(3))
    w = (torch.randn(c, c, generator=gen, device="cuda") / c**0.5).to(torch.bfloat16).t()
    return x.permute(0, 2, 3, 1), gamma, beta, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("hh,ww,c", [(63, 65, 320), (32, 32, 640), (16, 16, 1280)])
def test_fused_norm_statistics_on_large_mean_data_on_card(hh, ww, c, layout):
    """x = 300 + randn, a mean large against the spread: the statistics
    kernel's per-channel mean and rsigma against group_stats_plain (which
    repeats its order; the CPU tests hold it to JAX) within chip_smoke.py's
    bounds, 2^-21 max|x| and 2^-17 relative, and the call's output within
    K7's bound."""
    _needs_gpu()
    x, gamma, beta, w, bias = _gn_operands(2, hh, ww, c, layout, 1.0, 300.0)
    stats = torch.empty(2, 2, c, device="cuda")
    got = pfn.gn_act_proj(x, gamma, beta, w, bias, 32, stats=stats)
    mean, rsig = pfn.group_stats_plain(x, 32, 1e-6)
    assert float((stats[:, 0] - mean).abs().max()) <= 2.0**-21 * float(x.float().abs().max())
    assert float((stats[:, 1] / rsig - 1).abs().max()) <= 2.0**-17
    want = pfn.gn_act_proj_plain(x, gamma, beta, w, bias, 32)
    assert torch.isfinite(got).all()
    assert _over_tolerance(got, want, rounded_before=want.float() - bias.float()) <= 1.0


def _f32_operands(b, h, lq, lk, d, seed=0):
    """float32 [B, L, H*D] projections viewed as [B, H, L, D], as the CLIP
    vision tower hands them over."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(b, n, h * d, generator=gen, device="cuda").view(b, n, h, d).transpose(1, 2)
            for n in (lq, lk, lk)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["online", "nomax"])
@pytest.mark.parametrize("b,h,lq,lk", [(2, 16, 1025, 1025), (1, 4, 4097, 4097), (1, 2, 1000, 1100), (2, 1, 70, 1)])
def test_f32_forward_matches_plain_on_card(mode, b, h, lq, lk):
    """flash_fwd_f32 against its plain version in float32 with TF32 off:
    float32 roundings in other orders, within 2^-14 of the element plus
    2^-14 of the output's rms (chip_smoke.py's bound); ragged q and key
    tiles, a one-key row."""
    _needs_gpu()
    q, k, v = _f32_operands(b, h, lq, lk, 64)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if mode == "online":
            got, want = pfa.flash_fwd_online(q, k, v), pfa.flash_fwd_online_plain(q, k, v)
        else:
            got, want = pfa.flash_fwd_nomax(q, k, v), pfa.flash_attention_nomax_plain(q, k, v)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    tol = 2.0**-14 * want.abs() + 2.0**-14 * want.pow(2).mean().sqrt()
    assert got.dtype == torch.float32 and bool(((got - want).abs() <= tol).all())


@pytest.mark.cuda
def test_f32_forward_raises_off_its_head_dims_on_card():
    """Head dim 72 is none of F32_HEAD_DIMS (40, 64, 80 and 160 are): the
    wrappers raise, forward and backward, and nothing pads it."""
    _needs_gpu()
    q, k, v = _f32_operands(1, 2, 1024, 1024, 72)
    with pytest.raises(ValueError, match="head dim 72"):
        pfa.flash_fwd_online(q, k, v)
    with pytest.raises(ValueError, match="head dim 72"):
        pfa.flash_attention(*(t.detach().requires_grad_(True) for t in (q, k, v)))
    q, k, v = _f32_operands(1, 2, 1024, 1024, 64)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        pfa.flash_fwd_nomax(q, k, v)


@pytest.mark.cuda
def test_f32_forward_raises_on_mixed_dtypes_on_card():
    _needs_gpu()
    q, k, v = _f32_operands(1, 2, 1024, 1024, 64)
    with pytest.raises(ValueError, match="float32 only"):
        pfa.flash_fwd_online(q, k.to(torch.bfloat16), v)


class _NoTF32:
    """TF32 off for float32 matmuls and convolutions (the plain versions)."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def _f32_over(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| in units of 2^-14 |want| + 2^-14 rms(want)."""
    tol = 2.0**-14 * want.abs() + 2.0**-14 * want.pow(2).mean().sqrt()
    return float(((got - want).abs() / tol).max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["online", "nomax", "lse"])
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("b,h,lq,lk", [(2, 8, 1024, 1024), (1, 2, 1000, 1100), (1, 3, 1100, 300), (2, 1, 70, 1)])
def test_f32_forward_modes_match_plain_at_the_unet_head_dims_on_card(mode, d, b, h, lq, lk):
    """flash_fwd_f32's three modes at SD-v1.5's head dims (D=40 padded to 48
    in shared memory) on the UNet's [B, L, H*D] views: ragged q and key
    tiles, Lq != Lk both ways, a one-key row; the lse mode's lse too."""
    _needs_gpu()
    q, k, v = _f32_operands(b, h, lq, lk, d, seed=d + lq)
    with _NoTF32():
        if mode == "online":
            got, want = pfa.flash_fwd_online(q, k, v), pfa.flash_fwd_online_plain(q, k, v)
        elif mode == "nomax":
            got, want = pfa.flash_fwd_nomax(q, k, v), pfa.flash_attention_nomax_plain(q, k, v)
        else:
            (got, lse), (want, lse_want) = pfa.flash_fwd_lse(q, k, v), pfa.flash_fwd_lse_plain(q, k, v)
            assert lse.shape == (b, h, lq)
            assert float(((lse - lse_want).abs() / lse_want.abs().clamp_min(1.0)).max()) <= 2.0**-14
    assert got.dtype == torch.float32 and got.shape == q.shape and _f32_over(got, want) <= 1.0


def _f32_backward(q, k, v, g):
    """The float32 backward through the wrappers, and its plain versions on
    the kernel forward's o and lse."""
    o, lse = pfa.flash_fwd_lse(q, k, v)
    qs = pfa.prescaled_q(q)
    dq, delta = pfa.flash_bwd_dq(q, k, v, g, o, lse, qs)
    dk, dv = pfa.flash_bwd_dkv(q, k, v, g, lse, delta, qs)
    gc = g.contiguous()
    with _NoTF32():
        delta_plain = pfa.attention_delta(gc, o)
        want = (pfa.flash_bwd_dq_plain(q, k, v, gc, lse, delta_plain),
                *pfa.flash_bwd_dkv_plain(q, k, v, gc, lse, delta_plain))
    return (dq, dk, dv), want, _delta_over_tolerance(delta, gc, o)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 80, 160])
@pytest.mark.parametrize("lq,lk", [(1024, 1024), (1000, 1100), (1100, 300), (70, 65)])
def test_f32_backward_matches_plain_on_card(d, lq, lk):
    """flash_bwd_dq_f32 (with delta) and flash_bwd_dkv_f32 against their
    plain versions in float32 on the UNet's [B, L, H*D] views: partial q
    and key tiles, Lq != Lk both ways, less than one q tile beside one key
    tile and a key. (With a single key p is 1 and dq and dk are exactly 0:
    both sides read rounding residues there, which no relative bound
    holds.)"""
    _needs_gpu()
    q, _, _ = _f32_operands(2, 4, lq, lq, d, seed=lq)
    _, k, v = _f32_operands(2, 4, lk, lk, d, seed=lk + 1)
    (g,) = _f32_operands(2, 4, lq, lq, d, seed=lq + 2)[:1]
    before = [f.launches for f in (pfa.flash_bwd_dq, pfa.flash_bwd_dkv, pfa.flash_bwd_dq_f32, pfa.flash_bwd_dkv_f32)]
    got, want, delta_ratio = _f32_backward(q, k, v, g)
    after = [f.launches for f in (pfa.flash_bwd_dq, pfa.flash_bwd_dkv, pfa.flash_bwd_dq_f32, pfa.flash_bwd_dkv_f32)]
    assert [a - b_ for a, b_ in zip(after, before)] == [0, 0, 1, 1]
    assert delta_ratio <= 1.0
    assert all(a.dtype == torch.float32 and a.shape == w.shape and _f32_over(a, w) <= 1.0 for a, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_f32_kernels_read_a_fused_qkv_view_on_card(d):
    """q, k and v as slices of one float32 [B, L, 3*H*D] projection (rows
    3*H*D apart) and dO as a transposed [B, L, H, D] buffer: the forward
    modes and the backward read them in place and agree with the plain
    versions."""
    _needs_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(d)
    b, h, l = 2, 4, 1000
    qkv = torch.randn(b, l, 3 * h * d, generator=gen, device="cuda")
    q, k, v = (qkv[..., i * h * d:(i + 1) * h * d].view(b, l, h, d).transpose(1, 2) for i in range(3))
    g = torch.randn(b, l, h, d, generator=gen, device="cuda").transpose(1, 2)
    assert not q.is_contiguous() and q.stride(2) == 3 * h * d
    with _NoTF32():
        assert _f32_over(pfa.flash_fwd_nomax(q, k, v), pfa.flash_attention_nomax_plain(q, k, v)) <= 1.0
        assert _f32_over(pfa.flash_fwd_online(q, k, v), pfa.flash_fwd_online_plain(q, k, v)) <= 1.0
    got, want, delta_ratio = _f32_backward(q, k, v, g)
    assert delta_ratio <= 1.0 and all(_f32_over(a, w) <= 1.0 for a, w in zip(got, want))


@pytest.mark.cuda
def test_f32_dispatch_under_grad_on_card():
    """A gated float32 UNet shape under grad goes through the autograd
    Function and launches the float32 lse mode, K5 and K6 once each (no bf16
    kernel); without grad the float32 no-max mode; the gradients agree with
    autograd through sdpa_plain in float32."""
    _needs_gpu()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    leaves = [torch.randn(2, 1024, 8 * 80, generator=gen, device="cuda").requires_grad_(True) for _ in range(3)]
    q, k, v = (t.view(2, 1024, 8, 80).transpose(1, 2) for t in leaves)
    assert pattn.kernel_route(q.dtype, 80, 1024, 1024, True).wrappers == (
        "flash_fwd_lse_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")
    fns = (pfa.flash_fwd_lse_f32, pfa.flash_bwd_dq_f32, pfa.flash_bwd_dkv_f32, pfa.flash_fwd_nomax_f32,
           pfa.flash_fwd_lse, pfa.flash_bwd_dq, pfa.flash_bwd_dkv, pfa.flash_fwd_nomax)
    before = [f.launches for f in fns]
    w = torch.randn(2, 8, 1024, 80, generator=gen, device="cuda")
    (pattn.sdpa(q, k, v) * w).sum().backward()
    got = [t.grad.clone() for t in leaves]
    with torch.no_grad():
        pattn.sdpa(q, k, v)
    assert [a - b_ for a, b_ in zip([f.launches for f in fns], before)] == [1, 1, 1, 1, 0, 0, 0, 0]
    for t in leaves:
        t.grad = None
    with _NoTF32():
        (pattn.sdpa_plain(q, k, v) * w).sum().backward()
    for a, t in zip(got, leaves):
        assert float((a - t.grad).norm() / t.grad.norm()) <= 1e-5


def _gn_f32_operands(b, hh, ww, c, layout, scale, mean):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    x = torch.randn(b, c, hh, ww, generator=gen, device="cuda") * scale + mean
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    gamma, beta, bias = (torch.randn(c, generator=gen, device="cuda") for _ in range(3))
    w = (torch.randn(c, c, generator=gen, device="cuda") / c**0.5).t()
    return x.permute(0, 2, 3, 1), gamma, beta, w, bias


@pytest.mark.cuda
@pytest.mark.parametrize("b,hh,ww,c,act,layout", [
    (2, 64, 64, 320, "none", "nchw"), (2, 63, 65, 320, "none", "nchw"), (2, 63, 65, 320, "silu", "channels_last"),
    (2, 32, 32, 640, "none", "channels_last"), (2, 16, 16, 1280, "none", "nchw"), (4, 8, 8, 1280, "silu", "nchw"),
])
@pytest.mark.parametrize("mean", [0.5, 300.0])
def test_f32_fused_norm_matches_plain_on_card(b, hh, ww, c, act, layout, mean):
    """gn_act_proj_f32 on float32 activations in both layouts the UNet hands
    it, odd pixel counts (N = 4095), the SiLU variant and data whose mean is
    large against its spread: the statistics held to group_stats_plain
    (its order; bit-equal expected, held to chip_smoke.py's bounds), the
    output to gn_act_proj_plain in float32."""
    _needs_gpu()
    x, gamma, beta, w, bias = _gn_f32_operands(b, hh, ww, c, layout, 2.0, mean)
    stats = torch.empty(b, 2, c, device="cuda")
    before = (pfn.gn_act_proj.launches, pfn.gn_act_proj_f32.launches)
    got = pfn.gn_act_proj(x, gamma, beta, w, bias, 32, act=act, stats=stats)
    assert (pfn.gn_act_proj.launches, pfn.gn_act_proj_f32.launches) == (before[0], before[1] + 1)
    mean_p, rsig_p = pfn.group_stats_plain(x, 32, 1e-6)
    assert float((stats[:, 0] - mean_p).abs().max()) <= 2.0**-21 * float(x.abs().max())
    assert float((stats[:, 1] / rsig_p - 1).abs().max()) <= 2.0**-17
    with _NoTF32():
        want = pfn.gn_act_proj_plain(x, gamma, beta, w, bias, 32, act=act)
    assert got.dtype == torch.float32 and got.shape == (b, hh, ww, c) and _f32_over(got, want) <= 1.0
