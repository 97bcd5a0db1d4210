"""The vision tower's gated self-attention (Lq = Lk >= 1024) against its
float32 roofline (67 TFLOP/s outside the tensor cores), in %: see
portbench/readers.py ``roofline``."""
from portbench.readers import roofline


def read(run, trace):
    return roofline(run, trace)
