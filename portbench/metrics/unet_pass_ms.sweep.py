"""Device milliseconds of one UNet forward: the activities launched inside
the "pb.unet" spans over the number of calls."""


def read(run, trace):
    calls = trace.count("pb.unet")
    device_s = trace.span_device_s("pb.unet")
    return 1e3 * device_s / calls if calls and device_s > 0 else None
