"""The UNet's gated self-attention (Lq = Lk >= 1024) against its bf16
roofline, in %: see portbench/readers.py ``roofline``."""
from portbench.readers import roofline


def read(run, trace):
    return roofline(run, trace)
