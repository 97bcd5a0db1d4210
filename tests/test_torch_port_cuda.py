"""The port's CUDA kernels on a GPU (every test is marked ``cuda`` and skips
where there is no CUDA device): each kernel against its plain PyTorch
version at the shapes its path gives it, and the attention dispatch under
grad. This file imports neither JAX nor the JAX package, so on a machine
with a GPU and no JAX it runs on its own, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

The bounds are chip_smoke.py's: |kernel - plain| <= rtol |plain| + 2^-7
rms(plain). For the forwards rtol is 2^-7, one bf16 ulp of the element
(both round the same fp32 result to bf16, where summation order or
ex2.approx may flip a rounding); K4 is held to its plain version at the
kernel's own 64-key tiles. The backward kernels also round p and ds to bf16
inside their sums, so a flipped rounding there moves the fp32 sum before
the final rounding: rtol 2^-6, two ulps.
"""
import math

import pytest
import torch

from diffmining_tpu_torch.ops import attention as pattn
from diffmining_tpu_torch.ops import flash_attention as pfa

BWD_RTOL = 2.0**-6


def _over_tolerance(got: torch.Tensor, want: torch.Tensor, rtol: float = 2.0**-7) -> float:
    w = want.float()
    tol = rtol * w.abs() + 2.0**-7 * w.pow(2).mean().sqrt()
    return float(((got.float() - w).abs() / tol).max())


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _operands(b, h, l, d, n):
    """n [B, L, H*D] bf16 tensors viewed as [B, H, L, D], as the UNet hands them over."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
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
    bounds of chip_smoke.py; K4 against the plain version at its own 64-key
    tiles."""
    _needs_gpu()
    q, k, v, g = _operands(b, h, l, d, 4)
    o, lse = pfa.flash_fwd_lse(q, k, v)
    o_plain, lse_plain = pfa.flash_fwd_lse_plain(q, k, v, block_k=64)
    assert _over_tolerance(o, o_plain) <= 1.0
    torch.testing.assert_close(lse, lse_plain, rtol=1e-4, atol=1e-4)
    delta = pfa.attention_delta(g, o)
    assert _over_tolerance(pfa.flash_bwd_dq(q, k, v, g, lse, delta),
                           pfa.flash_bwd_dq_plain(q, k, v, g, lse, delta), BWD_RTOL) <= 1.0
    dk, dv = pfa.flash_bwd_dkv(q, k, v, g, lse, delta)
    dk_plain, dv_plain = pfa.flash_bwd_dkv_plain(q, k, v, g, lse, delta)
    assert _over_tolerance(dk, dk_plain, BWD_RTOL) <= 1.0 and _over_tolerance(dv, dv_plain, BWD_RTOL) <= 1.0


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
