"""UNet evaluations (output rows) a swept image: rows of every UNet call in
the traced window over the images written (benchmark counters around the
UNet forward)."""
from portbench.readers import per


def read(run, trace):
    return per(run, "unet_rows", "images")
