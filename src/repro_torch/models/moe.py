"""Top-k routed Mixture-of-Experts MLP with capacity, the JAX package's
grouped dispatch/combine formulation (GShard / Mesh-TF style) in torch.

Tokens are split into fixed-size routing groups; within a group each
token picks its top-k experts, and an expert takes at most `capacity` of
the group's assignments, queued choice-major (every token's first choice
before any token's second). Assignments past capacity are dropped. The
dispatch (G, g, E, C) 0/1 tensor and the gate-weighted combine tensor then
turn the token shuffle into dense products, as in the reference.

A routing group is cut from the flattened B*S tokens, so a group may span
batch lanes, and lanes then share capacity (ROADMAP C7): a lane's output
can depend on its neighbours. The port keeps the reference's grouping.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import is_dtensor
from ..sharding.partition import shard_constraint
from .config import ModelConfig
from .layers import _init

Params = Any


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, lead=()):
    """The router (D, E) at scale 1/sqrt(D); the experts' `wi_gate`,
    `wi_up` (E, D, F) and `wo` (E, F, D) at 1/sqrt(E): the reference's
    `_init` takes the fan-in from a leaf's first axis, which for an expert
    leaf is E, so the port passes that scale explicitly."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.d_ff
    expert = 1.0 / np.sqrt(E)
    return {
        "router": _init(gen, (*lead, D, E), dtype),
        "wi_gate": _init(gen, (*lead, E, D, Fd), dtype, scale=expert),
        "wi_up": _init(gen, (*lead, E, D, Fd), dtype, scale=expert),
        "wo": _init(gen, (*lead, E, Fd, D), dtype, scale=expert),
    }


def _top_k_routing(logits: torch.Tensor, k: int, capacity: int):
    """logits: (G, g, E) -> dispatch (G,g,E,C), combine (G,g,E,C), aux.

    The top-k is a stable sort, so that of tied probabilities the lower
    expert index comes first, as `jax.lax.top_k` orders them (`torch.topk`
    does not). dispatch and combine are built by scatter; each (t, e, c)
    receives at most one assignment, so they hold the reference's values
    bit for bit."""
    G, g, E = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[..., :k], gate_idx[..., :k]  # (G, g, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # one-hot per choice: (G, k, g, E), choice-major queue order (built by
    # comparison: `F.one_hot` checks its indices on the host, a sync a layer)
    experts = torch.arange(E, dtype=gate_idx.dtype, device=logits.device)
    choice_oh = (gate_idx.transpose(1, 2)[..., None] == experts).int()
    flat = choice_oh.reshape(G, k * g, E)
    pos_in_expert = (torch.cumsum(flat, dim=1, dtype=torch.int32)
                     - flat).reshape(G, k, g, E)
    slot = (pos_in_expert * choice_oh).sum(-1).transpose(1, 2)   # (G, g, k)
    # a dropped assignment (slot >= capacity) goes to a spare last column
    col = torch.where(slot < capacity, gate_idx * capacity + slot,
                      E * capacity)

    def scatter(src):
        # out of place: under a mesh `col` and `src` are DTensors, which
        # DTensor scatters only into a new tensor
        out = torch.scatter(torch.zeros((G, g, E * capacity + 1),
                                        dtype=torch.float32,
                                        device=logits.device), -1, col, src)
        return out[..., :-1].reshape(G, g, E, capacity)

    dispatch = scatter(torch.ones_like(gate_vals))
    combine = scatter(gate_vals)
    aux = _load_balance_loss(probs, choice_oh)
    return dispatch, combine, aux


def _load_balance_loss(probs: torch.Tensor,
                       choice_oh: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: E * dot(mean_prob, mean_top1_assignment)."""
    E = probs.shape[-1]
    density = choice_oh[:, 0].float().mean(dim=(0, 1))  # top-1 share
    mean_prob = probs.mean(dim=(0, 1))
    return E * (density * mean_prob).sum()


def moe_mlp(p: Params, x: torch.Tensor, cfg: ModelConfig,
            compute_dtype=torch.bfloat16, group_size: int = 512):
    """x: (B, S, D) -> (y (B,S,D), aux_loss scalar float32)."""
    B, S, D = x.shape
    T = B * S
    E, k = cfg.n_experts, cfg.experts_per_token
    g = min(group_size, T)
    if T % g != 0:                       # tiny smoke shapes: one group
        g = T
    G = T // g
    capacity = max(int(cfg.capacity_factor * k * g / E), 1)
    capacity = max((capacity + 3) // 4 * 4, 4)   # pad to a lane-friendly size

    dt = compute_dtype
    xt = shard_constraint(x.reshape(G, g, D), "batch", None, None).to(dt)
    logits = xt @ p["router"].to(dt)
    dispatch, combine, aux = _top_k_routing(logits, k, capacity)

    # (G,g,E,C) x (G,g,D) -> (G,E,C,D): routing groups over the batch
    # axes, experts over the expert axis
    xe = _dispatch(dispatch.to(dt), xt)
    xe = shard_constraint(xe, "batch", "expert", None, None)
    ye = _experts(xe, p["wi_gate"].to(dt), p["wi_up"].to(dt),
                  p["wo"].to(dt))
    ye = shard_constraint(ye, "batch", "expert", None, None)
    y = _combine(combine.to(dt), ye)
    return y.reshape(B, S, D), aux.float()


def _experts(xe, wi_gate, wi_up, wo):
    """Each expert's gated MLP on its slots: (G,E,C,D) -> (G,E,C,D).
    Under a mesh it runs through `local_call` on each rank's groups and
    experts, the weights gathered over their embed axis (the FSDP
    gather): DTensor (torch 2.11) fails to lay out the einsums' permuted
    results. Per (group, expert) it is exact."""
    if not is_dtensor(xe):
        gt = torch.einsum("Gecd,edf->Gecf", xe, wi_gate)
        up = torch.einsum("Gecd,edf->Gecf", xe, wi_up)
        return torch.einsum("Gecf,efd->Gecd", F.silu(gt) * up, wo)
    from ..sharding.partition import local_call
    xa, wa = ("batch", "expert", None, None), ("expert", None, None)
    return local_call(
        lambda *ts, specs, coord: _experts(*ts).contiguous(),
        (xe, wi_gate, wi_up, wo), (xa, wa, wa, wa), ((xa, xe.shape),))


# Under a mesh the routing products are matmuls over (expert, slot)
# flattened expert-major: an einsum may flatten them slot-major, which
# DTensor (torch 2.11) cannot do with the experts split; without a mesh
# the einsums stay, whose bits the port's transcripts were taken with

def _dispatch(dispatch: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """(G,g,E,C) x (G,g,D) -> (G,E,C,D)."""
    if not is_dtensor(xt):
        return torch.einsum("Gtec,Gtd->Gecd", dispatch, xt)
    G, g, E, C = dispatch.shape
    return (dispatch.reshape(G, g, E * C).transpose(1, 2) @ xt).reshape(
        G, E, C, xt.shape[-1])


def _combine(combine: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """(G,g,E,C) x (G,E,C,D) -> (G,g,D)."""
    if not is_dtensor(ye):
        return torch.einsum("Gtec,Gecd->Gtd", combine, ye)
    G, g, E, C = combine.shape
    return combine.reshape(G, g, E * C) @ ye.reshape(G, E * C, ye.shape[-1])
