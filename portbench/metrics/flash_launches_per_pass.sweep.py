"""Launches of the flash kernels a UNet call: the attention wrappers'
``.launches`` counters over the traced window, over the UNet calls."""
from portbench.readers import per


def read(run, trace):
    return per(run, "launches", "unet_calls")
