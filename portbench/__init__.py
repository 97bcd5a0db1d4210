"""The benchmark of diffmining_tpu_torch, the PyTorch and CUDA port: see
portbench/harness.py and BENCHMARK.json."""
