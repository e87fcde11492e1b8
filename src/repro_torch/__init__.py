"""PyTorch + CUDA port of `repro` (Reinit++ global-restart recovery).

Sub-packages keep the reference's names. The port imports torch, numpy
and the standard library only; it never imports jax or `repro`.
"""
