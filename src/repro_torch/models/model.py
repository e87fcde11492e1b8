"""Model API of every architecture family: dense, vlm (the dense stack
behind a frontend that overwrites the first rows of the embedding), moe
(top-k routed experts with capacity), ssm (Mamba1), hybrid (Mamba2 + a
shared attention block, zamba2-style) and encdec (a bidirectional encoder
over frontend frame embeddings, and a decoder that cross-attends to it):
config -> init / forward / loss_fn / prefill / decode_step.

The parameter tree has the JAX package's structure and leaf paths
(`embedding/table`, `stack/layers/...` with a leading L axis, a hybrid's
`stack/shared/...` and `stack/tail/...`, an encdec's
`stack/enc_layers/...`, `frontend_proj/w`, `ln_enc`, `ln_f`), so either
package reads the other's checkpoints, and `params_from_jax` carries the
reference's parameters (or whole train state) across.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve, to_device
from ..tree import tree_map
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import moe as moe_mod
from .config import ModelConfig
from .layers import (dense, dense_init, embed, embedding_init, mlp, rmsnorm,
                     rmsnorm_init, torch_dtype, unembed)
from .transformer import (ExecConfig, _layer, _n_stacked,
                          decode_state_axes, decode_state_batch_axes,
                          encoder_forward, family,
                          stack_forward, stack_init)

Params = Any


def masked_chunked_xent(table: torch.Tensor, x: torch.Tensor,
                        labels: torch.Tensor, compute_dtype,
                        n_chunks: int = 8) -> torch.Tensor:
    """Cross-entropy over sequence chunks; labels < 0 are ignored.

    Never materializes the full (B,S,V) logits — peak logit memory is
    (B, S/n_chunks, V) per chunk.
    """
    B, S, _ = x.shape
    if S % n_chunks != 0:
        n_chunks = 1
    tbl = table.to(compute_dtype)
    c = S // n_chunks
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        xc = x[:, i * c:(i + 1) * c]
        lc = labels[:, i * c:(i + 1) * c].long()
        valid = lc >= 0
        logits = xc.to(compute_dtype) @ tbl.T
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, lc.clamp(min=0)[..., None])[..., 0]
        tot = tot + ((lse - gold) * valid).sum()
        cnt = cnt + valid.sum()
    return tot / torch.clamp(cnt, min=1.0)


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    ec: ExecConfig = ExecConfig()

    def init(self, gen: torch.Generator) -> Params:
        """Random parameters drawn from `gen`, on `gen.device`."""
        cfg = self.cfg
        dtype = cfg.param_dtype
        params = {
            "embedding": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype),
            "stack": stack_init(gen, cfg, dtype),
            "ln_f": rmsnorm_init(cfg.d_model, dtype, gen.device),
        }
        if cfg.frontend:
            params["frontend_proj"] = dense_init(gen, cfg.d_model,
                                                 cfg.d_model, dtype)
        if cfg.family == "encdec":
            params["ln_enc"] = rmsnorm_init(cfg.d_model, dtype, gen.device)
        return params

    def _embed_inputs(self, params, batch, dt):
        """Token embedding; in a vlm model with `frontend_emb` (B,nf,D) in
        the batch, its projection overwrites the first nf rows. A prompt
        shorter than nf would keep no text token (the reference then
        returns nf frontend rows; ROADMAP C9): the port raises."""
        x = embed(params["embedding"], batch["tokens"], dt)
        if self.cfg.family == "vlm" and "frontend_emb" in batch:
            fe = dense(params["frontend_proj"], batch["frontend_emb"], dt)
            nf = fe.shape[1]
            if x.shape[1] < nf:
                raise ValueError(
                    f"a vlm prompt needs S >= frontend_emb.shape[1]: "
                    f"{x.shape[1]} tokens for {nf} frontend rows would keep "
                    f"no text token (ROADMAP C9)")
            x = torch.cat([fe, x[:, nf:]], dim=1)
        return x

    def _encode(self, params, batch, dt):
        """An encdec model's encoder output, normed: the frontend's
        projection of `enc_emb` (B,S_enc,D) through the encoder."""
        fe = dense(params["frontend_proj"], batch["enc_emb"], dt)
        enc_out = encoder_forward(params["stack"], fe, self.cfg, self.ec, dt)
        return rmsnorm(params["ln_enc"], enc_out, self.cfg.norm_eps)

    def forward(self, params, batch):
        """Full-sequence forward -> (hidden (B,S,D), aux_loss)."""
        cfg, ec = self.cfg, self.ec
        dt = torch_dtype(cfg.compute_dtype)
        x = self._embed_inputs(params, batch, dt)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        enc_out = self._encode(params, batch, dt) \
            if cfg.family == "encdec" else None
        h, aux = stack_forward(params["stack"], x, cfg, ec, positions, dt,
                               enc_out=enc_out)
        h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return h, aux

    def logits(self, params, batch):
        """(B,S,V) logits — small-model/test path only."""
        h, aux = self.forward(params, batch)
        return unembed(params["embedding"], h,
                       torch_dtype(self.cfg.compute_dtype)), aux

    def loss_fn(self, params, batch):
        """Mean token cross-entropy + MoE aux. Returns (loss, metrics)."""
        h, aux = self.forward(params, batch)
        xent = masked_chunked_xent(params["embedding"]["table"], h,
                                   batch["labels"],
                                   torch_dtype(self.cfg.compute_dtype),
                                   n_chunks=self.ec.xent_chunks)
        loss = xent + 0.01 * aux
        return loss, {"xent": xent, "aux": aux}

    # ------------------------------------------------------- decode state

    def init_decode_state(self, batch: int, max_len: int, *, device=None):
        """The zeroed decode state on `device` (`cuda` unless named):
        dense, vlm and moe, KV caches {"k", "v"} of shape (L, batch,
        max_len, Hkv, hd) in the compute dtype; encdec, those and the
        cross K/V caches {"cross_k", "cross_v"} of shape (L, batch,
        enc_seq_len, Hkv, hd) in the compute dtype; ssm, {"h": (L, batch,
        di, ds), "conv": (L, batch, K-1, di)} in float32, whatever max_len
        is; hybrid,
        {"mamba": {"h": (G, E, batch, nh, hp, ds), "conv": (G, E, batch,
        K-1, di+2ds)} in float32, "tail": the same leaves with lead (T,)
        (absent when T is 0), "attn": {"k", "v"} (G, batch, max_len, Hkv,
        hd) in the compute dtype}, with G, T = divmod(n_layers,
        attn_every) and E = attn_every. The leaves are built by the
        family's row of `transformer.FAMILIES`."""
        cfg = self.cfg
        return family(cfg).init_state(cfg, batch, max_len,
                                      torch_dtype(cfg.compute_dtype),
                                      resolve(device))

    def decode_state_specs(self, rules):
        """PartitionSpec tree matching init_decode_state's structure:
        batch over DP axes, K/V heads by the kv_heads rule and the KV
        sequence by kv_seq, d_inner / SSM heads over the heads axis (the
        reference's specs, read from the family table)."""
        return decode_state_axes(self.cfg, lambda axes: rules.spec(*axes))

    def decode_state_batch_axes(self):
        """A tree shaped like `init_decode_state`'s whose leaves are the
        batch axis of each state leaf: 1 under a lead of one stacked axis
        (layers, groups, the tail), 2 under a hybrid's (G, E) lead. The
        serving engine splices prefilled lanes along these axes."""
        return decode_state_batch_axes(self.cfg)

    # ------------------------------------------------------------ prefill

    def prefill(self, params, batch, max_len: int):
        """Process a prompt; returns (last-position logits (B,1,V), decode
        state). The returned KV caches are padded to max_len so decode can
        continue in place; an ssm state is the recurrent state after the
        prompt (`attn_impl="pallas"`: scanned by S1 on the card, in a
        Mamba1 model). A hybrid model's shared block runs its attention
        through F1 under "pallas", once per group; an encdec model runs
        its encoder (non-causal), each decoder layer's self-attention and
        its cross-attention over the encoder through F1, and returns the
        cross K/V caches {"cross_k", "cross_v"} (L, B, S_enc, Hkv, hd)
        beside the self-attention ones. A vlm model's prompt embedding
        takes `batch["frontend_emb"]` where the batch has it."""
        cfg = self.cfg
        family(cfg)                     # ValueError for an unknown family
        dt = torch_dtype(cfg.compute_dtype)
        x = self._embed_inputs(params, batch, dt)
        if cfg.family == "ssm":
            return self._prefill_ssm(params, x, dt)
        if cfg.family == "hybrid":
            return self._prefill_hybrid(params, x, dt, max_len)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        enc_out = self._encode(params, batch, dt) \
            if cfg.family == "encdec" else None
        kvs = []
        for i in range(cfg.n_layers):
            x, kv = self._prefill_dense(_layer(params["stack"]["layers"], i),
                                        x, positions, dt, enc_out)
            kvs.append(kv)
        h = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
        return unembed(params["embedding"], h, dt), _kv_caches(kvs, max_len)

    def _prefill_dense(self, lp, x, positions, dt, enc_out=None):
        """One dense (or moe) block's prefill: (x, its K/V {"k", "v"} in
        the compute dtype). With `enc_out`, an encdec decoder block: the
        cross-attention comes between self-attention and MLP, and its K/V
        (projected once) are returned as "cross_k", "cross_v"."""
        cfg = self.cfg
        o, k, v = attn_mod.attention_with_kv(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
            positions=positions, impl=self.ec.attn_impl, compute_dtype=dt)
        x = x + o
        kv = {"k": k.to(dt), "v": v.to(dt)}
        if enc_out is not None:
            o, ck, cv = attn_mod.cross_attention_with_kv(
                lp["cross"], rmsnorm(lp["ln_x"], x, cfg.norm_eps), enc_out,
                cfg, impl=self.ec.attn_impl, compute_dtype=dt)
            x = x + o
            kv.update(cross_k=ck.to(dt), cross_v=cv.to(dt))
        return x + self._mlp(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps), dt), kv

    def _mlp(self, lp, x, dt):
        """A block's MLP: the routed experts where the block has them (their
        load-balancing loss dropped, as the reference's prefill and decode
        drop it), else the dense MLP."""
        if "moe" in lp:
            return moe_mod.moe_mlp(lp["moe"], x, self.cfg, dt,
                                   group_size=self.ec.moe_group)[0]
        return mlp(lp["mlp"], x, dt)

    def _prefill_mamba(self, layers, x, dt):
        """Prefill through a stack of Mamba blocks: (x, their states
        stacked on a leading axis)."""
        cfg = self.cfg
        states = []
        for i in range(_n_stacked(layers)):
            lp = _layer(layers, i)
            y, st = mamba_mod.mamba_forward_with_state(
                lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps), cfg, dt,
                impl=self.ec.attn_impl)
            x = x + y
            states.append(st)
        return x, _stack(states)

    def _prefill_ssm(self, params, x, dt):
        x, state = self._prefill_mamba(params["stack"]["layers"], x, dt)
        h = rmsnorm(params["ln_f"], x[:, -1:], self.cfg.norm_eps)
        return unembed(params["embedding"], h, dt), state

    def _prefill_hybrid(self, params, x, dt, max_len: int):
        cfg, stack = self.cfg, params["stack"]
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        groups, kvs = [], []
        for g in range(_n_stacked(stack["layers"])):
            x, st = self._prefill_mamba(_layer(stack["layers"], g), x, dt)
            groups.append(st)
            x, kv = self._prefill_dense(stack["shared"], x, positions, dt)
            kvs.append(kv)
        state = {"mamba": _stack(groups)}
        if "tail" in stack:
            x, state["tail"] = self._prefill_mamba(stack["tail"], x, dt)
        state["attn"] = _kv_caches(kvs, max_len)
        h = rmsnorm(params["ln_f"], x[:, -1:], cfg.norm_eps)
        return unembed(params["embedding"], h, dt), state

    # -------------------------------------------------------- decode step

    def decode_step(self, params, token, state, pos):
        """One-token decode. token: (B,1) int; pos: a scalar, or a (B,)
        tensor of per-row positions (the serving engine's continuous
        batching — see models.attention.decode_attention).

        Returns (logits (B,1,V), state). The leaves of `state` (KV caches,
        or the ssm state, which ignores `pos`) are updated in place (the
        reference donates them to the same end); an encdec model's cross
        K/V caches are read, never written. Every family embeds the tokens
        alone (a vlm frontend enters at prefill only)."""
        cfg = self.cfg
        family(cfg)                     # ValueError for an unknown family
        dt = torch_dtype(cfg.compute_dtype)
        x = embed(params["embedding"], token, dt)
        stack = params["stack"]
        if cfg.family == "ssm":
            x = self._decode_mamba(stack["layers"], x, state, dt)
        elif cfg.family == "hybrid":
            shared = stack["shared"]
            for g in range(_n_stacked(stack["layers"])):
                x = self._decode_mamba(_layer(stack["layers"], g), x,
                                       _layer(state["mamba"], g), dt)
                x = self._decode_dense(shared, x, state["attn"]["k"][g],
                                       state["attn"]["v"][g], pos, dt)
            if "tail" in stack:
                x = self._decode_mamba(stack["tail"], x, state["tail"], dt)
        else:
            for i in range(cfg.n_layers):
                cross = (state["cross_k"][i], state["cross_v"][i]) \
                    if cfg.family == "encdec" else None
                x = self._decode_dense(_layer(stack["layers"], i), x,
                                       state["k"][i], state["v"][i], pos, dt,
                                       cross)
        h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
        return unembed(params["embedding"], h, dt), state

    def _decode_dense(self, lp, x, cache_k, cache_v, pos, dt, cross=None):
        """One dense (or moe) block's decode step; writes the caches in
        place. With `cross` (one layer's cross K/V caches), an encdec
        decoder block: the cross-attention comes between self-attention
        and MLP."""
        cfg = self.cfg
        o, _, _ = attn_mod.decode_attention(
            lp["attn"], rmsnorm(lp["ln1"], x, cfg.norm_eps), cfg,
            cache_k=cache_k, cache_v=cache_v, pos=pos, compute_dtype=dt)
        x = x + o
        if cross is not None:
            x = x + attn_mod.cross_decode_attention(
                lp["cross"], rmsnorm(lp["ln_x"], x, cfg.norm_eps), cfg,
                cross_k=cross[0], cross_v=cross[1], compute_dtype=dt)
        return x + self._mlp(lp, rmsnorm(lp["ln2"], x, cfg.norm_eps), dt)

    def _decode_mamba(self, layers, x, states, dt):
        """A stack of Mamba blocks' decode step; `states` ({h, conv} with
        the stack's leading axis) are updated in place."""
        cfg = self.cfg
        for i in range(_n_stacked(layers)):
            lp = _layer(layers, i)
            y, st = mamba_mod.mamba_step(
                lp["mamba"], rmsnorm(lp["ln"], x, cfg.norm_eps),
                _layer(states, i), cfg, dt)
            x = x + y
            for k, v in st.items():
                states[k][i] = v
        return x


def _kv_caches(kvs: list, max_len: int) -> dict:
    """The per-layer K/V of a prefill -> the decode caches: each key
    stacked on a leading layer axis, "k" and "v" zero-padded along the
    sequence to max_len (so decode continues in place), the cross caches
    as they are. Built out of place, so that a prefill under a mesh keeps
    every cache a DTensor laid out like its K/V."""
    out = _stack(kvs)
    for key in ("k", "v"):
        pad = max_len - out[key].shape[2]
        if pad > 0:
            out[key] = F.pad(out[key], (0, 0, 0, 0, 0, pad))
    return out


def _stack(trees: list):
    """Trees of one structure -> one tree, each leaf stacked on a new
    leading axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def params_from_jax(tree, device=None):
    """A tree of numpy arrays (the JAX package's params or train state,
    e.g. `jax.device_get(state)`) -> the same tree of tensors on `device`
    (`cuda` unless the caller names another; see `device.resolve`).
    bfloat16 leaves (numpy's ml_dtypes) keep their bits."""
    return _params_from_jax(tree, resolve(device))


def _params_from_jax(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_params_from_jax(v, device) for v in tree)
    return to_device(tree, device)
