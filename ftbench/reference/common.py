"""Pieces shared by the references: float32 settings, seeded draws, the
fp8 rounding of the control, and RMSNorm."""
from __future__ import annotations

import math

import torch


def float32_exact() -> None:
    """No TF32 in float32 matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return t.mul_(std)


def uniform(gen: torch.Generator, shape, lo: float, hi: float
            ) -> torch.Tensor:
    t = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return t.mul_(hi - lo).add_(lo)


#: the embedding table's scale (GPT-2's and OLMo's initialisation). The
#: port ties the unembedding to the table: at unit scale a token's own row
#: outweighs every other logit, and a random model only echoes its last
#: input token, whatever its layers compute
TABLE_STD = 0.02

FP8_MAX = 448.0          # largest finite float8 e4m3


def fp8(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one per-tensor scale, back in
    float32."""
    amax = t.abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def mm(a: torch.Tensor, w: torch.Tensor, quant) -> torch.Tensor:
    """a @ w in float32, on fp8-rounded operands under `quant="fp8"`."""
    if quant == "fp8":
        return fp8(a) @ fp8(w)
    if quant is not None:
        raise ValueError(quant)
    return a @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def residual_std(fan_in: int, n_layers: int) -> float:
    """The output projections' scale: 1/sqrt(fan_in), shrunk by
    sqrt(2 * n_layers) as GPT-2 and OLMo initialise the projections that
    write the residual stream (Mamba by sqrt(n_layers))."""
    return 1.0 / math.sqrt(fan_in) / math.sqrt(2 * n_layers)
