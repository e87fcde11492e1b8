"""Attention, dense path: MHA/GQA with optional qk-norm, QKV bias and RoPE.

Two interchangeable inner implementations, written as plain torch ops that
mirror the JAX package's so the two compare like with like:
  - "naive":   materializes (B,H,S,S) scores — reference / tiny tests only.
  - "chunked": flash-style online softmax over KV chunks — bounded memory;
               the default and the training path.
The Pallas flash kernel's counterpart ("pallas") is not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from .config import ModelConfig
from .layers import _init, apply_rope, rmsnorm, rmsnorm_init, torch_dtype

Params = Any

NEG_INF = -1e30


def attention_init(gen, cfg: ModelConfig, dtype, lead=()):
    hd = cfg.head_dim
    p = {
        "wq": _init(gen, (*lead, cfg.d_model, cfg.n_heads * hd), dtype),
        "wk": _init(gen, (*lead, cfg.d_model, cfg.n_kv_heads * hd), dtype),
        "wv": _init(gen, (*lead, cfg.d_model, cfg.n_kv_heads * hd), dtype),
        "wo": _init(gen, (*lead, cfg.n_heads * hd, cfg.d_model), dtype),
    }
    zeros = lambda n: torch.zeros((*lead, n), dtype=torch_dtype(dtype),
                                  device=gen.device)
    if cfg.qkv_bias:
        p["bq"] = zeros(cfg.n_heads * hd)
        p["bk"] = zeros(cfg.n_kv_heads * hd)
        p["bv"] = zeros(cfg.n_kv_heads * hd)
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, dtype, gen.device, lead)
        p["k_norm"] = rmsnorm_init(hd, dtype, gen.device, lead)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions, compute_dtype):
    B, S, _ = x.shape
    hd = cfg.head_dim
    xc = x.to(compute_dtype)
    q = xc @ p["wq"].to(compute_dtype)
    k = xc @ p["wk"].to(compute_dtype)
    v = xc @ p["wv"].to(compute_dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(compute_dtype)
        k = k + p["bk"].to(compute_dtype)
        v = v + p["bv"].to(compute_dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def naive_attention(q, k, v, *, causal: bool, q_offset=0) -> torch.Tensor:
    """q: (B,Sq,H,hd); k,v: (B,Sk,Hkv,hd). Returns (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        scores = torch.where(kpos <= qpos, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def chunked_attention(q, k, v, *, causal: bool, q_offset=0,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Flash-style online-softmax over KV chunks. Same math as naive.

    Peak memory is O(Sq * kv_chunk) per head instead of O(Sq * Sk).
    """
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    kv_chunk = min(kv_chunk, Sk)
    if Sk % kv_chunk != 0:
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset)
    n_chunks = Sk // kv_chunk
    qf = q.float()
    scale = 1.0 / math.sqrt(hd)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset

    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    for idx in range(n_chunks):
        sl = slice(idx * kv_chunk, (idx + 1) * kv_chunk)
        kb = _repeat_kv(k[:, sl], n_rep).float()
        vb = _repeat_kv(v[:, sl], n_rep).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        if causal:
            kpos = idx * kv_chunk + torch.arange(kv_chunk,
                                                 device=q.device)[None, :]
            s = torch.where(kpos <= qpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(denom[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True,
              impl: str = "chunked",
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Full attention block: proj -> inner attention -> output proj."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    if impl == "naive":
        o = naive_attention(q, k, v, causal=causal)
    elif impl == "chunked":
        o = chunked_attention(q, k, v, causal=causal)
    elif impl == "pallas":
        raise NotImplementedError(
            "attn_impl='pallas' (flash attention, kernel A4) is not ported "
            "yet: ROADMAP queue A, slice 2")
    else:
        raise ValueError(impl)
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return o @ p["wo"].to(compute_dtype)
