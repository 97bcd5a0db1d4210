"""The sweep's model FLOPs (UNet passes and VAE encodes) over the traced
window, in % of 989 TFLOP/s (bf16)."""
from portbench.readers import mfu


def read(run, trace):
    return mfu(run, trace, "bf16")
