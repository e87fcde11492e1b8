"""Deterministic, step-indexed, resumable synthetic token pipeline.

batch(step) is a pure function of (seed, step) — the pipeline cursor IS
the step counter, so checkpoint/restart resumes bit-identically with no
separate data state to save. The tokens are the JAX package's numpy
`host_batch` (its `batch()` draws from jax.random, which torch cannot
reproduce), moved to the pipeline's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    device: str = "cuda"

    def batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.host_batch(step).items()}

    def host_batch(self, step: int) -> dict:
        """Zipf-ish tokens with a learnable neighbour structure (numpy)."""
        rng = np.random.default_rng((self.seed << 20) ^ step)
        u = rng.random((self.global_batch, self.seq_len + 1))
        base = (u * u * (self.vocab_size - 1)).astype(np.int32)
        idx = np.arange(self.seq_len + 1)
        repeat = np.roll(base, 1, axis=1) + 1
        toks = np.where((idx % 2 == 0)[None, :], base,
                        repeat % self.vocab_size)
        return {"tokens": np.ascontiguousarray(toks[:, :-1]),
                "labels": np.ascontiguousarray(toks[:, 1:])}
