"""The UNet's gated self-attention under grad (forward with the row
statistics, and its backward) against its bf16 roofline, in %: see
portbench/readers.py ``roofline``."""
from portbench.readers import roofline


def read(run, trace):
    return roofline(run, trace)
