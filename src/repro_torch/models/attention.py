"""Attention: MHA/GQA with optional qk-norm, QKV bias, RoPE, KV-cache
decode, and an encoder-decoder's cross-attention (K/V from the encoder
output, non-causal, no RoPE; a static cross K/V cache at decode).

Three interchangeable inner implementations (same math):
  - "naive":   materializes (B,H,S,S) scores — reference / tiny tests only.
  - "chunked": flash-style online softmax over KV chunks in plain torch
               ops — bounded memory; the default and the training path.
  - "pallas":  the reference's name for its Pallas flash kernel; here the
               hand-written CUDA kernel F1 (`kernels.flash_attention`),
               forward only. F1 reads q, k, v in this module's
               (B, S, H, hd) layout and returns o in it, so merging the
               heads after it is a view.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..device import is_dtensor
from ..kernels.flash_attention import ops as fa_ops
from ..sharding.partition import local_offsets, shard_constraint, unflatten
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


def _heads(p, xc, cfg: ModelConfig, name: str, n_heads: int, positions,
           compute_dtype):
    """One of q, k, v (`name`) of the compute-dtype input `xc` (B,S,D):
    projected (bias added), split into heads, qk-normed and rotated as
    `_project_qkv` does it."""
    B, S, _ = xc.shape
    t = xc @ p["w" + name].to(compute_dtype)
    if cfg.qkv_bias:
        t = t + p["b" + name].to(compute_dtype)
    t = unflatten(t, -1, (n_heads, cfg.head_dim))
    if cfg.qk_norm and name != "v":
        t = rmsnorm(p[name + "_norm"], t, cfg.norm_eps)
    if positions is not None and name != "v":
        t = apply_rope(t, positions, cfg.rope_theta)
    return t


def _project_qkv(p, x, cfg: ModelConfig, positions, compute_dtype):
    q = _project_q(p, x, cfg, positions, compute_dtype)
    return (q, *_project_kv(p, x, cfg, positions, compute_dtype))


# keep batch data-sharded and heads model-sharded through the attention
# core under a mesh (K/V heads by the kv_heads rule, replicated in the
# presets): the layouts F1's local call reads
Q_AXES, KV_AXES = fa_ops.Q_AXES, fa_ops.KV_AXES


def _project_q(p, x, cfg: ModelConfig, positions, compute_dtype):
    return shard_constraint(
        _heads(p, x.to(compute_dtype), cfg, "q", cfg.n_heads, positions,
               compute_dtype), *Q_AXES)


def _project_kv(p, x, cfg: ModelConfig, positions, compute_dtype):
    xc = x.to(compute_dtype)
    return tuple(shard_constraint(
        _heads(p, xc, cfg, n, cfg.n_kv_heads, positions, compute_dtype),
        *KV_AXES) for n in ("k", "v"))


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
              kv_input: Optional[torch.Tensor] = None,
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Full attention block: proj -> inner attention -> output proj.

    kv_input: encoder output (B, S_enc, D) for cross-attention; K/V are then
    projected from it (no RoPE on q, k or v, non-causal)."""
    if kv_input is not None:
        return cross_attention_with_kv(p, x, kv_input, cfg, impl=impl,
                                       compute_dtype=compute_dtype)[0]
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    return _out(p, _inner(impl, q, k, v, causal), cfg, compute_dtype)


def _out(p, o: torch.Tensor, cfg: ModelConfig, compute_dtype):
    """The output projection of attention's (B,S,H,hd) result."""
    B, S = o.shape[:2]
    o = shard_constraint(o.reshape(B, S, cfg.n_heads * cfg.head_dim),
                         "batch", None, "heads")
    return o @ p["wo"].to(compute_dtype)


def _inner(impl: str, q, k, v, causal: bool) -> torch.Tensor:
    if impl == "pallas":
        return fa_ops.flash_attention(q, k, v, causal=causal)
    if impl not in ("naive", "chunked"):
        raise ValueError(impl)
    fn = naive_attention if impl == "naive" else chunked_attention
    if is_dtensor(q):
        # each rank's lanes and q heads over the K/V heads they read, as
        # F1 runs: the einsums flatten (lane, head) into one batch dim,
        # which DTensor cannot split over two mesh axes (torch 2.11)
        from ..sharding.partition import local_call
        return local_call(
            lambda q, k, v, *, specs, coord: fn(
                q, *fa_ops.kv_for_heads(q, k, v, specs, coord),
                causal=causal),
            (q, k, v), (Q_AXES, KV_AXES, KV_AXES), ((Q_AXES, q.shape),))
    return fn(q, k, v, causal=causal)


def attention_with_kv(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      positions=None, impl: str = "chunked",
                      compute_dtype=torch.bfloat16):
    """Prefill path: returns (out, k, v) so the caller can build a KV cache."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    return _out(p, _inner(impl, q, k, v, True), cfg, compute_dtype), k, v


def cross_attention_with_kv(p: Params, x: torch.Tensor,
                            enc_out: torch.Tensor, cfg: ModelConfig, *,
                            impl: str = "chunked",
                            compute_dtype=torch.bfloat16):
    """Cross-attention of x (B,S,D) over the encoder output (B,S_enc,D),
    non-causal and without RoPE: (out, k, v), k and v as
    `project_cross_kv` gives them, so an encdec prefill projects the cross
    K/V once for both the attention and the decode cache."""
    q = _project_q(p, x, cfg, None, compute_dtype)
    k, v = project_cross_kv(p, enc_out, cfg, compute_dtype)
    return _out(p, _inner(impl, q, k, v, False), cfg, compute_dtype), k, v


def project_cross_kv(p: Params, enc_out: torch.Tensor, cfg: ModelConfig,
                     compute_dtype=torch.bfloat16):
    """Cross-attention K/V from encoder output (computed once, then cached)."""
    return _project_kv(p, enc_out, cfg, None, compute_dtype)


# ------------------------------------------------------------- decode paths

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
                  dtype=torch.bfloat16, device=None):
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cross_decode_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                           cross_k: torch.Tensor, cross_v: torch.Tensor,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Decode-time cross-attention of x (B,1,D) over a static encoder K/V
    cache (B,S_enc,Hkv,hd): no mask, float32 scores, the softmax weights
    in the compute dtype."""
    B = x.shape[0]
    q = _project_q(p, x, cfg, None, compute_dtype)
    # the naive core, non-causal: float32 scores, the weights in q's dtype
    o = _inner("naive", q, cross_k.to(compute_dtype),
               cross_v.to(compute_dtype), False)
    return o.reshape(B, 1, cfg.n_heads * cfg.head_dim) \
        @ p["wo"].to(compute_dtype)


def _write_local(cache, pos: torch.Tensor, new) -> None:
    """Write new (B,1,Hkv,hd) into a mesh-sharded cache (B,Smax,Hkv,hd)
    at the per-row positions pos (B,), in place. DTensor has no in-place
    scatter into a dim split over the mesh (lanes over the batch axes,
    positions over kv_seq), so each rank writes the rows and positions
    its own shard holds, by its global offsets; `new` is first laid out
    like the cache (its one position on every rank of the seq split)."""
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(q, Shard) and q.dim == 1 else q
          for q in cache.placements]
    new_l = new.redistribute(cache.device_mesh, pl).to_local()[:, 0]
    cl = cache.to_local()
    ob, os_ = local_offsets(cache)[:2]
    bl, sl = cl.shape[:2]
    p = pos[ob:ob + bl].to(cl.device, torch.long) - os_
    ok = (p >= 0) & (p < sl)
    p = p.clamp(0, sl - 1)
    rows = torch.arange(bl, device=cl.device)
    # rows whose position lies in another rank's shard rewrite what
    # they read
    keep = cl[rows, p]
    cl.index_put_((rows, p), torch.where(ok[:, None, None],
                                         new_l.to(cl.dtype), keep))


def decode_attention(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos, compute_dtype=torch.bfloat16):
    """One-token decode. x: (B,1,D); cache_*: (B,Smax,Hkv,hd); pos is a
    scalar (every row at the same position) or a (B,) vector of per-row
    positions (continuous-batching serving: each slot carries its own
    clock, so ragged occupancy decodes exactly like B independent
    single-sequence streams).

    The new K/V are written into the caches in place (the counterpart of
    the reference's donated `.at[rows, pos].set` and
    `dynamic_update_slice`), which are also returned: (out (B,1,D),
    cache_k, cache_v).
    """
    B = x.shape[0]
    pos = torch.as_tensor(pos)
    per_row = pos.dim() == 1
    if per_row:
        pos = pos.to(x.device, torch.long)
        positions = pos[:, None]
    else:
        pos = int(pos)
        positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, compute_dtype)
    if is_dtensor(cache_k):
        rows_pos = pos if per_row else torch.full((B,), pos, device=x.device)
        _write_local(cache_k, rows_pos, k)
        _write_local(cache_v, rows_pos, v)
    elif per_row:
        # row i's K/V lands at its own position: one batched scatter
        rows = torch.arange(B, device=x.device)
        cache_k.index_put_((rows, pos), k[:, 0].to(cache_k.dtype))
        cache_v.index_put_((rows, pos), v[:, 0].to(cache_v.dtype))
    else:
        cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
        cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
    if is_dtensor(q):
        from ..sharding.partition import local_call
        rows_pos = pos if per_row else torch.full((B,), pos, device=x.device)
        o = local_call(
            lambda q, ck, cv, ps, *, specs, coord: _decode_core(
                q, *fa_ops.kv_for_heads(q, ck, cv, specs, coord), ps,
                compute_dtype),
            (q, cache_k, cache_v, rows_pos),
            (Q_AXES, KV_AXES, KV_AXES, ("batch",)), ((Q_AXES, q.shape),))
    else:
        o = _decode_core(q, cache_k, cache_v, pos, compute_dtype)
    return _out(p, o, cfg, compute_dtype), cache_k, cache_v


def _decode_core(q, cache_k, cache_v, pos, compute_dtype) -> torch.Tensor:
    """One new query a row over its cache: q (B,1,H,hd), caches
    (B,Smax,Hkv,hd), pos a (B,) tensor or an int -> (B,1,H,hd).
    GQA-grouped einsums: K/V heads are never replicated to H. Under a
    mesh it runs through `local_call` on each rank's lanes and q heads
    with each layer's whole sequence (the cache is split over kv_seq at
    rest and gathered for the step; DTensor cannot flatten a split
    dim into the einsum's batch): attention is per (lane, head), so it
    is exact."""
    B, _, H, hd = q.shape
    Smax, Hkv = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd)                  # (B,g,r,hd)
    kf = cache_k.to(compute_dtype)                        # (B,S,g,hd)
    vf = cache_v.to(compute_dtype)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, kf).float()
    s = s / math.sqrt(hd)
    kpos = torch.arange(Smax, device=q.device)
    if isinstance(pos, torch.Tensor):
        mask = (kpos[None, :] <= pos[:, None])[:, None, None, :]
    else:
        mask = (kpos <= pos)[None, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrs,bsgd->bgrd", w.to(compute_dtype), vf)
    return o.reshape(B, 1, H, hd)
