"""Hand-rolled AdamW with global-norm clipping and warmup+cosine schedule.

Pure functions over explicit trees, as in the JAX package: every update
returns new tensors, so a snapshot of the old state is never modified.
The maths is float32; moments are stored in each parameter's dtype and
`count` is int32, which keeps the optimizer state's leaves identical in
dtype and path to the reference's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Warmup + cosine decay, in float32 on `step`'s device."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    prog = prog.clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> dict:
    leaf = tree_leaves(params)[0]
    return {
        "m": tree_map(torch.zeros_like, params),
        "v": tree_map(torch.zeros_like, params),
        "count": torch.zeros((), dtype=torch.int32, device=leaf.device),
    }


def global_norm(tree) -> torch.Tensor:
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.sqrt(torch.stack(sq).sum())


def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """Returns (new_params, new_opt_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    count = opt_state["count"] + 1
    cf = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=cf.device), cf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=cf.device), cf)
    lr = lr_at(cfg, count)

    def upd(p, g, m, v):
        gf = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * gf
        v = cfg.b2 * v + (1 - cfg.b2) * gf.square()
        mhat = m / bc1
        vhat = v / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        pf = p.float()
        pf = pf - lr * (step + cfg.weight_decay * pf)
        return pf.to(p.dtype), m.to(p.dtype), v.to(p.dtype)

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads),
        tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}
