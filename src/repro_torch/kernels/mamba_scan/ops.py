"""Dispatch for the Mamba1 selective scan (the reference's kernel A5).

`mamba_scan(x, dt, B, C, A)` takes x, dt (b, S, di), B, C (b, S, ds) and
A (di, ds) and returns (y (b, S, di), h_final (b, di, ds) float32):

  - CUDA tensors -> the hand-written kernel S1 (`csrc/selective_scan.cu`)
                    at every shape (the reference's wrapper sends S < 8
                    or di < 8 to its oracle; the port does not); a build
                    or launch failure raises
  - CPU tensors  -> the plain PyTorch version (`ref.selective_scan_ref`)

Tensors on any other device raise, but for meta tensors, which get the
fake implementation (torch registers it as the operator's meta kernel).
Both routes are one torch operator,
`torch.ops.repro_torch.selective_scan`, so that a trace and
`torch.utils.flop_counter` see S1 as one op: a fake tensor (a dry run,
`launch/dryrun.py`) gets its outputs' shapes and dtypes and nothing else,
and the flop counter charges it `8·b·S·di·ds` (the scan term of
`models/flops.py`'s `mamba_flops`). The operator runs inside an autograd
Function whose backward raises: the reference defines no VJP for its
kernel, so the port does not silently drop the scan from a gradient.

DTensors (a model under a mesh) go through `sharding.partition.
local_call`: each rank scans its own lanes (batch axes) and channels
(heads axis). The scan is per (lane, channel), so the local call is
exact. The kernel entry point raises on a DTensor.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from ...device import is_dtensor, require_local
from ._build import KERNELS
from .ref import selective_scan_ref

#: kernel launches per wrapper; only the CUDA branch counts
LAUNCHES = {"selective_scan": 0}

#: state sizes S1 is compiled for (see `rt_selective_scan` in the source)
STATE_SIZES = (8, 16, 32)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def selective_scan_kernel(x: torch.Tensor, dt: torch.Tensor,
                          B: torch.Tensor, C: torch.Tensor,
                          A: torch.Tensor):
    """S1 on float32 CUDA tensors of one device -> (y (b, S, di) float32,
    h_final (b, di, ds) float32), launched on the current stream."""
    require_local("S1", x, dt, B, C, A)
    x, dt, B, C, A = (t.contiguous() for t in (x, dt, B, C, A))
    if not (x.is_cuda and all(t.device == x.device for t in (dt, B, C, A))):
        raise ValueError("selective_scan_kernel takes CUDA tensors on one "
                         "device")
    if any(t.dtype != torch.float32 for t in (x, dt, B, C, A)):
        raise ValueError("S1 takes float32 x, dt, B, C, A, got "
                         f"{[str(t.dtype) for t in (x, dt, B, C, A)]}")
    bsz, S, di = x.shape
    ds = B.shape[-1]
    if ds not in STATE_SIZES:
        raise ValueError(f"S1 is built for state sizes {STATE_SIZES}, "
                         f"got {ds}")
    if not (0 < bsz <= 65535 and S > 0 and di > 0):
        raise ValueError(f"S1 needs 0 < batch <= 65535, S > 0 and di > 0, "
                         f"got {tuple(x.shape)}")
    y = torch.empty_like(x)
    h = torch.empty((bsz, di, ds), dtype=torch.float32, device=x.device)
    code = KERNELS.lib().rt_selective_scan(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), y.data_ptr(), h.data_ptr(), bsz, S, di, ds,
        torch.cuda.current_stream(x.device).cuda_stream)
    KERNELS.check(code, "selective_scan")
    LAUNCHES["selective_scan"] += 1
    return y, h


def _route(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, A: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    if x.is_cuda:
        return selective_scan_kernel(x, dt, B, C, A)
    if x.device.type == "cpu":
        return selective_scan_ref(x, dt, B, C, A)
    raise RuntimeError(f"no selective-scan kernel for device {x.device}")


_op = torch.library.custom_op("repro_torch::selective_scan", _route,
                              mutates_args=())


@_op.register_fake
def _(x, dt, B, C, A):
    return (x.new_empty(x.shape),
            x.new_empty((x.shape[0], x.shape[2], B.shape[2]),
                        dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.selective_scan)
def _flops(x_shape, dt_shape, B_shape, *args, **kwargs) -> int:
    """dA, dBx, h and y of every (lane, step, channel, state): 8·b·S·di·ds,
    the scan term of `flops.mamba_flops`."""
    b, S, di = x_shape
    return 8 * b * S * di * B_shape[2]


def _forward(x, dt, B, C, A):
    """The operator on plain tensors: S1's route for their device."""
    return _op(x, dt, B, C, A)


class _ForwardOnly(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, B, C, A):
        return _forward(x, dt, B, C, A)

    @staticmethod
    def backward(ctx, gy, gh):
        raise NotImplementedError(
            "the selective scan (attn_impl='pallas') is forward-only: the "
            "reference defines no backward for its kernel; train with "
            "attn_impl='chunked'")


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
               C: torch.Tensor, A: torch.Tensor):
    """Selective scan y_t = C_t·h_t with h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t B_t from h = 0. x, dt: (b, S, di); B, C: (b, S, ds);
    A: (di, ds). Returns (y in x's dtype, h_final float32)."""
    if x.dim() != 3 or dt.shape != x.shape or B.dim() != 3 \
            or C.shape != B.shape or B.shape[:2] != x.shape[:2] \
            or tuple(A.shape) != (x.shape[2], B.shape[2]):
        raise ValueError(f"bad shapes x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)} A {tuple(A.shape)}")
    if is_dtensor(x):
        from ...sharding.partition import local_call
        xa, bca = ("batch", None, "heads"), ("batch", None, None)
        b, _, di = x.shape
        return local_call(
            lambda *ts, specs, coord: _ForwardOnly.apply(*ts),
            (x, dt, B, C, A), (xa, xa, bca, bca, ("heads", None)),
            ((xa, x.shape), (("batch", "heads", None), (b, di, B.shape[2]))))
    return _ForwardOnly.apply(x, dt, B, C, A)
