"""Frozen arithmetic of the benchmark: analytic FLOPs (a copy of
`repro_torch/models/flops.py`), the kernels' byte and operation bounds (a
copy of `chip_smoke.py`'s) and the H100's published peaks. Later program
changes cannot move what these count."""
