"""Model API of the dense family: config -> init / forward / loss_fn.

The parameter tree has the JAX package's structure and leaf paths
(`embedding/table`, `stack/layers/...` with a leading L axis, `ln_f`),
so either package reads the other's checkpoints, and `params_from_jax`
carries the reference's parameters (or whole train state) across.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..device import resolve
from .config import ModelConfig
from .layers import embed, embedding_init, rmsnorm, rmsnorm_init, torch_dtype
from .transformer import ExecConfig, stack_forward, stack_init

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
        return {
            "embedding": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                        dtype),
            "stack": stack_init(gen, cfg, dtype),
            "ln_f": rmsnorm_init(cfg.d_model, dtype, gen.device),
        }

    def forward(self, params, batch):
        """Full-sequence forward -> (hidden (B,S,D), aux_loss)."""
        cfg, ec = self.cfg, self.ec
        dt = torch_dtype(cfg.compute_dtype)
        x = embed(params["embedding"], batch["tokens"], dt)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None, :]
        h, aux = stack_forward(params["stack"], x, cfg, ec, positions, dt)
        h = rmsnorm(params["ln_f"], h, cfg.norm_eps)
        return h, aux

    def loss_fn(self, params, batch):
        """Mean token cross-entropy + MoE aux. Returns (loss, metrics)."""
        h, aux = self.forward(params, batch)
        xent = masked_chunked_xent(params["embedding"]["table"], h,
                                   batch["labels"],
                                   torch_dtype(self.cfg.compute_dtype),
                                   n_chunks=self.ec.xent_chunks)
        loss = xent + 0.01 * aux
        return loss, {"xent": xent, "aux": aux}


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
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)
