"""ftbench: the benchmark of `repro_torch` (the PyTorch and CUDA port),
serving long documents through a rank kill. See README.md."""
