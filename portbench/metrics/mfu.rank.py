"""The vision tower's FLOPs over the traced window, in % of 67 TFLOP/s
(float32, TF32 off)."""
from portbench.readers import mfu


def read(run, trace):
    return mfu(run, trace, "fp32")
