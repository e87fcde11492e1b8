"""Peaks of one NVIDIA H100 SXM (data sheet, dense) and the byte and
operation bounds of the port's kernels F1 (flash attention) and S1
(Mamba1 selective scan), frozen from `chip_smoke.py`.

A bound is the least time the card could take for a launch: the larger
of its bytes at the HBM rate and its operations at the peak rate of the
units that run them. Each input byte is counted read once and each output
byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"bfloat16": 989e12,     # dense bf16 tensor-core peak
               "float32": 67e12}       # fp32 outside the tensor cores
INT32_OPS_PER_S = 67e12                # non-tensor 32-bit rate


def attention_work(B, Sq, Sk, H, Hkv, hd, causal, itemsize):
    """(FLOPs, bytes) of one attention forward: 4*hd FLOPs per unmasked
    (query, key) pair; q, k, v read once, o written once."""
    if causal:    # query i sits at key position i + Sk - Sq
        if Sk >= Sq:
            # sum over i of min(Sk, i + Sk - Sq + 1), in closed form
            pairs = Sq * (Sk - Sq) + Sq * (Sq + 1) // 2
        else:
            pairs = sum(min(Sk, max(0, i + Sk - Sq + 1)) for i in range(Sq))
    else:
        pairs = Sq * Sk
    return (4 * B * H * hd * pairs,
            itemsize * (2 * B * Sq * H * hd + 2 * B * Sk * Hkv * hd))


def flash_bound_s(flops: int, nbytes: int, dtype: str) -> tuple[float, str]:
    """F1's bound in seconds and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS_PER_S[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_work(b, S, di, ds) -> tuple[int, int]:
    """(operations, bytes) of one selective scan: per state and step an
    exp and 6 FLOPs, per channel and step one more; x, dt, B, C, A read
    once, y and h_final written once, all float32."""
    ops = b * S * di * (7 * ds + 1)
    nbytes = 4 * (3 * b * S * di + 2 * b * S * ds + di * ds + b * di * ds)
    return ops, nbytes


def scan_bound_s(b, S, di, ds) -> tuple[float, str]:
    """S1's bound in seconds and what sets it."""
    ops, nbytes = scan_work(b, S, di, ds)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
