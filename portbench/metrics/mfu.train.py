"""A train step's model FLOPs (the UNet forward and backward, 3 x the
forward, and the frozen VAE encoder and text encoder forwards) over the
traced window, in % of 989 TFLOP/s (bf16)."""
from portbench.readers import mfu


def read(run, trace):
    return mfu(run, trace, "bf16")
