"""Device milliseconds a step of the clip, AdamW and EMA passes: the
activities launched inside the "pb.optimizer" spans (around the train
step builder's ``_apply_and_ema``) over the steps traced."""


def read(run, trace):
    steps = trace.count("pb.optimizer")
    device_s = trace.span_device_s("pb.optimizer")
    return 1e3 * device_s / steps if steps and device_s > 0 else None
