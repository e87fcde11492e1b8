"""Dispatch for the flash-attention forward (the reference's kernel A4).

`flash_attention` takes the model layout q (B,Sq,H,hd), k/v (B,Sk,Hkv,hd):

  - CUDA tensors -> the hand-written kernel F1 (`csrc/flash_attention.cu`),
                    whatever the lengths; a build or launch failure raises.
                    The dtype picks F1's kernel: bfloat16 runs on the tensor
                    cores (wgmma, TMA), float32 on fp32 FMAs. F1 reads q, k,
                    v and writes o through their (batch, seq, head) strides,
                    so neither layout is copied.
  - CPU tensors  -> the plain PyTorch version (`ref.flash_attention_ref`)

Tensors on any other device raise, but for meta tensors, which get the
fake implementation (torch registers it as the operator's meta kernel).
Both routes are one torch operator,
`torch.ops.repro_torch.flash_attention`, so that a trace and
`torch.utils.flop_counter` see F1 as one op: a fake tensor (a dry run,
`launch/dryrun.py`) gets its output's shape and dtype and nothing else,
and the flop counter charges it `4·B·H·Sq·Sk·hd`, halved when causal with
Sq == Sk (`models/flops.py`'s `attn_flops` with flash). The operator runs
inside an autograd Function whose backward raises: the reference defines
no VJP for its kernel, so the port does not silently drop attention from
a gradient.

DTensors (a model under a mesh) go through `sharding.partition.
local_call`: each rank runs the route above on its own lanes and heads
(batch over the batch axes, q heads over the heads axis, K/V heads by
the kv_heads rule), with the K/V heads its q heads read. Attention is per
(lane, head), so the local call is exact. The kernel entry points raise
on a DTensor.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from ...device import is_dtensor, require_local
from ._build import KERNELS
from .ref import flash_attention_ref

#: kernel launches per wrapper; only the CUDA branch counts
LAUNCHES = {"flash_attention": 0}

#: head dims F1 is compiled for (see `rt_flash_attention` in the source);
#: 112 is zamba2-7b's shared attention block (d_model 3584 / 32 heads)
HEAD_DIMS = (16, 64, 112, 128)
#: the logical axes of q and of k/v under a mesh: lanes over the batch
#: axes, heads over the heads axis, K/V heads by the kv_heads rule
Q_AXES = ("batch", None, "heads", None)
KV_AXES = ("batch", None, "kv_heads", None)
#: dtype -> F1's kernel: 0 the fp32 FMA kernel, 1 the bf16 tensor-core one
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# Strides of size-1 dimensions are never stepped and arbitrary in torch;
# both helpers set them to hd, a multiple of 16 bytes like the rest.

def model_strides(t: torch.Tensor) -> tuple:
    """(batch, seq, head) element strides of a (B, S, H, hd) tensor."""
    B, S, H, hd = t.shape
    sb, ss, sh, _ = t.stride()
    return (hd if B == 1 else sb, hd if S == 1 else ss, hd if H == 1 else sh)


def flat_strides(t: torch.Tensor, heads: int) -> tuple:
    """(batch, seq, head) element strides of a (B*heads, S, hd) tensor:
    row b*heads + h of the first dimension is batch b, head h."""
    BH, S, hd = t.shape
    s0, s1, _ = t.stride()
    return (hd if BH == heads else heads * s0, hd if S == 1 else s1,
            hd if heads == 1 else s0)


def in_place(tensors, args: tuple) -> bool:
    """Whether F1 reads and writes `tensors` (q, k, v, o) where they lie,
    given their `launch_args`: each head dimension contiguous, each base
    and stride a multiple of 16 bytes (TMA's rule, and the float4 loads')."""
    bits = 0
    for t in tensors:
        if t.stride(-1) != 1:
            return False
        bits |= t.data_ptr()
    size = tensors[0].element_size()
    for st in args[7:]:
        bits |= st * size
    return bits % 16 == 0


def launch_args(q, k, v, o, *, n_q_heads: int | None = None) -> tuple:
    """The integers F1's entry point takes after the four pointers:
    (dtype code, B, H, Hkv, Sq, Sk, hd, then the (batch, seq, head)
    element strides of q, k, v and o). Model layout (B,S,H,hd) tensors,
    or, with `n_q_heads`, the flattened layout (B*H, S, hd)."""
    if n_q_heads is None:
        B, Sq, H, hd = q.shape
        Sk, Hkv = k.shape[1], k.shape[2]
        st = [model_strides(t) for t in (q, k, v, o)]
    else:
        BH, Sq, hd = q.shape
        H, Sk = n_q_heads, k.shape[1]
        B = BH // H
        Hkv = k.shape[0] // B
        st = [flat_strides(q, H), flat_strides(k, Hkv), flat_strides(v, Hkv),
              flat_strides(o, H)]
    return (_DTYPES[q.dtype], B, H, Hkv, Sq, Sk, hd, *st[0], *st[1], *st[2],
            *st[3])


def _check(q, k, v, B, H, Hkv, Sk, hd) -> None:
    dev = q.get_device()
    if not (q.is_cuda and k.get_device() == dev and v.get_device() == dev):
        raise ValueError("F1 takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"F1 takes float32 or bfloat16 q, k, v of one "
                         f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"F1 is built for head dims {HEAD_DIMS}, got {hd}")
    if not (B and Hkv and H % Hkv == 0 and Sk):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} for H={H}")
    if q.dtype == torch.float32 and B * H > 65535:
        raise ValueError(f"F1's float32 kernel needs B*H <= 65535, got "
                         f"{B * H}")


def _launch(q, k, v, out, causal: bool, n_q_heads=None) -> torch.Tensor:
    """Launch F1 on tensors `launch_args` describes (copying the inputs
    to fresh, aligned storage only if F1 cannot read them in place)."""
    args = launch_args(q, k, v, out, n_q_heads=n_q_heads)
    if not in_place((q, k, v, out), args):
        q, k, v = (t.clone(memory_format=torch.contiguous_format)
                   for t in (q, k, v))
        args = launch_args(q, k, v, out, n_q_heads=n_q_heads)
    code = KERNELS.lib().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args,
        int(causal), 1.0 / math.sqrt(args[6]),
        torch._C._cuda_getCurrentRawStream(q.get_device()))
    if code:
        KERNELS.check(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bhsd_kernel(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool,
                                n_q_heads: int) -> torch.Tensor:
    """F1 on the flattened layout: q (B*H, Sq, hd), k/v (B*Hkv, Sk, hd),
    float32 or bfloat16 CUDA tensors -> (B*H, Sq, hd) in q's dtype."""
    require_local("F1", q, k, v)
    BH, Sq, hd = q.shape
    BHkv, Sk = k.shape[0], k.shape[1]
    H = n_q_heads
    B = BH // H if H > 0 and BH % H == 0 else 0
    Hkv = BHkv // B if B and BHkv % B == 0 else 0
    _check(q, k, v, B, H, Hkv, Sk, hd)
    if tuple(k.shape) != (BHkv, Sk, hd) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} for H={H}")
    out = torch.empty((BH, Sq, hd), dtype=q.dtype, device=q.get_device())
    if Sq == 0:
        return out
    return _launch(q, k, v, out, causal, n_q_heads=H)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool) -> torch.Tensor:
    """F1 in the model layout (B,Sq,H,hd) x (B,Sk,Hkv,hd) -> (B,Sq,H,hd),
    the output contiguous so that merging its heads is a view."""
    require_local("F1", q, k, v)
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check(q, k, v, B, H, Hkv, Sk, hd)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.get_device())
    if Sq == 0:
        return out
    return _launch(q, k, v, out, causal)


def _route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> torch.Tensor:
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, causal=causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    raise RuntimeError(f"no flash-attention kernel for device {q.device}")


_op = torch.library.custom_op("repro_torch::flash_attention", _route,
                              mutates_args=())


@_op.register_fake
def _(q, k, v, causal):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, *args, **kwargs) -> int:
    """Scores and AV of every (lane, head, query, key): 4·B·H·Sq·Sk·hd,
    halved when causal with Sq == Sk, as `flops.attn_flops` charges the
    flash kernel."""
    B, Sq, H, hd = q_shape
    core = 4 * B * H * Sq * k_shape[1] * hd
    return core // 2 if causal and Sq == k_shape[1] else core


def _forward(q, k, v, causal):
    """The operator on plain tensors: F1's route for their device."""
    return _op(q, k, v, causal)


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
    if is_dtensor(q):
        from ...sharding.partition import local_call
        return local_call(
            lambda q, k, v, *, specs, coord: _local(q, k, v, causal, specs,
                                                    coord),
            (q, k, v), (Q_AXES, KV_AXES, KV_AXES), ((Q_AXES, q.shape),))
    return _ForwardOnly.apply(q, k, v, causal)


def _head_range(n_local: int, axes, coord) -> tuple[int, int]:
    """(first global head, global head count) of a local head dim split
    over the mesh axes `axes` (None: not split), major to minor."""
    if axes is None:
        return 0, n_local
    idx, n = 0, 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        i, size = coord[a]
        idx, n = idx * size + i, n * size
    return idx * n_local, n_local * n


def _local(q, k, v, causal: bool, specs, coord) -> torch.Tensor:
    """One rank's attention: its q heads over the K/V heads they read."""
    return _ForwardOnly.apply(q, *kv_for_heads(q, k, v, specs, coord),
                              causal)


def kv_for_heads(q, k, v, specs, coord):
    """Inside `local_call`: the local K/V heads that the local q heads
    (B, S, H_local, hd) read, (B, Sk, ., hd) each — a slice of the local
    K/V heads, or each q head's own K/V head where the split of the
    heads cuts a GQA group. `specs` are the fitted specs of q, k (, ...),
    `coord` the rank's mesh coordinate."""
    h0, H = _head_range(q.shape[2], specs[0][2], coord)
    g0, Hkv = _head_range(k.shape[2], specs[1][2], coord)
    rep, hl = H // Hkv, q.shape[2]
    # the K/V heads [lo, hi) of this rank's q heads, from the ints alone
    # (no value of a tensor is read: a dry run's tensors have none)
    lo, hi = h0 // rep - g0, (h0 + hl - 1) // rep + 1 - g0
    idx = None if h0 % rep == 0 and hl % rep == 0 else \
        torch.arange(h0, h0 + hl, device=k.device) // rep - g0
    if lo < 0 or hi > k.shape[2]:
        raise ValueError(f"q heads [{h0}, {h0 + hl}) read K/V heads this "
                         f"rank does not hold ([{g0}, {g0 + k.shape[2]}))")
    if idx is None:
        return k[:, :, lo:hi], v[:, :, lo:hi]
    return k.index_select(2, idx), v.index_select(2, idx)
