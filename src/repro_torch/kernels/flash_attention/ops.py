"""Dispatch for the flash-attention forward (the reference's kernel A4).

`flash_attention` takes the model layout q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd):

  - CUDA tensors -> the hand-written kernel F1 (`csrc/flash_attention.cu`)
                    on the flattened layout (B*H, S, hd), whatever the
                    lengths; a build or launch failure raises
  - CPU tensors  -> the plain PyTorch version (`ref.flash_attention_ref`)

Tensors on any other device raise. Both routes go through an autograd
Function whose backward raises: the reference defines no VJP for its
kernel, so the port does not silently drop attention from a gradient.
"""
from __future__ import annotations

import math

import torch

from ._build import KERNELS
from .ref import flash_attention_ref

#: kernel launches per wrapper; only the CUDA branch counts
LAUNCHES = {"flash_attention": 0}

#: head dims F1 is compiled for (see `dispatch_hd` in the source)
HEAD_DIMS = (16, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention_bhsd_kernel(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool,
                                n_q_heads: int) -> torch.Tensor:
    """F1 on the flattened layout: q (B*H, Sq, hd), k/v (B*Hkv, Sk, hd),
    float32 or bfloat16 CUDA tensors -> (B*H, Sq, hd) in q's dtype."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    BH, Sq, hd = q.shape
    BHkv, Sk = k.shape[0], k.shape[1]
    H = n_q_heads
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_bhsd_kernel takes CUDA tensors "
                         "on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"F1 takes float32 or bfloat16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"F1 is built for head dims {HEAD_DIMS}, got {hd}")
    B = BH // H if H > 0 and BH % H == 0 else 0
    Hkv = BHkv // B if B and BHkv % B == 0 else 0
    if not Hkv or H % Hkv or tuple(k.shape) != (BHkv, Sk, hd) \
            or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} for H={H}")
    if Sk == 0 or BH > 65535:
        raise ValueError(f"F1 needs Sk > 0 and B*H <= 65535 (Sk={Sk}, "
                         f"B*H={BH})")
    out = torch.empty_like(q)
    if Sq == 0:
        return out
    for t in (q, k, v, out):
        if t.data_ptr() % 16:
            raise ValueError("F1 needs 16-byte aligned buffers")
    code = KERNELS.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], BH, H, Hkv, Sq, Sk, hd, int(causal),
        1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream)
    KERNELS.check(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """F1 in the model layout (B,Sq,H,hd) x (B,Sk,Hkv,hd) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qf = q.transpose(1, 2).reshape(B * H, Sq, hd)
    kf = k.transpose(1, 2).reshape(B * Hkv, Sk, hd)
    vf = v.transpose(1, 2).reshape(B * Hkv, Sk, hd)
    of = flash_attention_bhsd_kernel(qf, kf, vf, causal=causal, n_q_heads=H)
    return of.reshape(B, H, Sq, hd).transpose(1, 2)


def _forward(q, k, v, causal: bool) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    raise RuntimeError(f"no flash-attention kernel for device {q.device}")


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash attention (attn_impl='pallas') is forward-only: the "
            "reference defines no backward for its kernel; train with "
            "attn_impl='chunked'")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,Hkv,hd) -> (B,Sq,H,hd) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] \
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    return _ForwardOnly.apply(q, k, v, causal)
