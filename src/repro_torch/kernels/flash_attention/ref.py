"""Plain PyTorch version of the flash-attention forward (full
materialization): the same function as the JAX package's
`flash_attention_ref`.

The CPU tests hold it against the Pallas kernel in interpret mode, the
port's wrapper takes it for CPU tensors, and `chip_smoke.py` holds the
CUDA kernel F1 against it on the card. Nothing on the CUDA path calls it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,Hkv,hd) -> (B,Sq,H,hd) in q's dtype.

    GQA: head h of q attends to kv head h // (H // Hkv). Softmax in fp32
    with scale 1/sqrt(hd). Query position i is aligned to key position
    i + (Sk - Sq), so a query suffix against a longer KV prefix masks
    correctly; masked scores take the finite NEG_INF.
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


def max_row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over output rows (one query of one head, hd values),
    of max|got - want| over the row divided by max|want| over the row.
    A causal output's rows shrink with the keys they average, so one
    bound on the whole output's error is loose on its late rows; this
    reading holds each row to its own scale (a row equal to its
    reference reads 0)."""
    d = (got.float() - want.float()).abs().amax(-1)
    top = want.float().abs().amax(-1)
    return float(torch.where(d == 0, torch.zeros_like(d), d / top).max())
