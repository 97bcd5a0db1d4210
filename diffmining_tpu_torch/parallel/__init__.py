"""Multi-process data parallelism over ``torch.distributed`` (counterpart of
diffmining_tpu/parallel/)."""
