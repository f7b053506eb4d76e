"""The benchmark of the PyTorch/CUDA port `lins_tpu_torch` (see
benchmark/README.md)."""
