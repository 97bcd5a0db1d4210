"""The FLOP and byte counts against hand counts at small shapes."""
import torch

from portbench import counts
from portbench.reference.common import Conv2d, Linear, Ref, attention, FP32
from portbench.tests import tiny


class _Net(Ref):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(3, 8, 3, padding=1)
        self.lin = Linear(8, 5)

    def forward(self, x):
        y = self.conv(x)  # [2, 8, 6, 6]
        return self.lin(y.flatten(2).transpose(1, 2))  # [2, 36, 5]


def test_conv_and_linear_by_hand():
    got = counts.model_flops(_Net, lambda m, x: m(x), (2, 3, 6, 6))
    conv = 2 * 2 * 8 * 6 * 6 * 3 * 3 * 3
    lin = 2 * 2 * 36 * 8 * 5
    assert got == conv + lin


def test_attention_by_hand():
    b, h, l, d = 2, 3, 16, 8
    got = counts.model_flops(lambda: torch.nn.Identity(),
                             lambda m, q, k, v: attention(FP32, q, k, v, block=4), (b, h, l, d), (b, h, l, d),
                             (b, h, l, d))
    flops, nbytes = counts.attention_forward(b, h, l, l, d, 2)
    assert got == flops == 4 * b * h * l * l * d
    assert nbytes == 2 * 4 * b * h * l * d
    fb, bb = counts.attention_backward(b, h, l, l, d, 4)
    assert fb == 10 * b * h * l * l * d and bb == 4 * 8 * b * h * l * d


def test_unet_flops_grow_with_rows_and_cover_attention():
    import json

    cfg = tiny.SD["unet"]
    key = json.dumps(cfg, sort_keys=True)
    one = counts.unet_flops("u", key, 1, 8, 8, 77)
    assert counts.unet_flops("u", key, 3, 8, 8, 77) == 3 * one
    # the 8 x 8 level's self-attention alone: 4 L^2 C at L 64, C 32
    assert one > 4 * 64 * 64 * 32


def test_bound_is_the_larger_term():
    assert counts.bound_seconds(989e12, 0, "bf16") == 1.0
    assert counts.bound_seconds(0, 3.35e12, "fp32") == 1.0
    assert counts.bound_seconds(67e12, 0, "fp32") == 1.0
