"""Logical-axis → mesh-axis sharding rules.

Parameters are named by their tree path (e.g. "stack/layers/attn/wq");
each rule maps a path *pattern* plus array rank to a tuple of logical
axes, and a preset maps logical axes onto physical mesh axes. This keeps
the model code free of mesh knowledge: the same tree runs on one device
with no mesh, on a small CPU mesh in the tests, or on the (16,16) pod
and (2,16,16) multi-pod meshes.

Logical axes used across the codebase:
  "batch"    — per-example axis (data parallel; "pod"+"data" on multi-pod)
  "embed"    — d_model / residual stream (FSDP axis: sharded over "data")
  "heads"    — attention heads / d_ff / d_inner (tensor parallel: "model")
  "kv_heads" — KV heads; sharded over "model" only when it divides evenly
  "expert"   — MoE expert axis (expert parallel: "model")
  "vocab"    — vocabulary (sharded over "model" for the big tables)
  "seq"      — sequence axis (sequence parallel, opt-in)
  None       — replicated

The tables are the JAX package's, copied: the same presets, the same
regexes in the same order (first match wins), and a `PartitionSpec` of
the port's own whose entries and equality are those of jax's.
`sharding.partition` turns a spec into DTensor placements.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional


class PartitionSpec:
    """Per tensor dim: a mesh-axis name, a tuple of names (the dim split
    over several axes, major to minor), or None (not split). Equal to a
    spec or a tuple with the same entries; trailing Nones count, as in
    jax (`P("a", None) != P("a")`)."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(tuple(p) if isinstance(p, list) else p
                            for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self):
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self):
        return hash(self._parts)

    def __repr__(self):
        return f"PartitionSpec{self._parts!r}" if len(self._parts) != 1 \
            else f"PartitionSpec({self._parts[0]!r})"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping of logical axis names to physical mesh axes."""
    batch: Any = None
    embed: Any = None
    heads: Any = None
    kv_heads: Any = None
    expert: Any = None
    vocab: Any = None
    seq: Any = None
    kv_seq: Any = None     # decode KV-cache sequence axis (flash-decode)

    def physical(self, logical: Optional[str]):
        if logical is None:
            return None
        return getattr(self, logical)

    def spec(self, *logical_axes) -> P:
        return P(*(self.physical(a) for a in logical_axes))


# Presets keyed by mesh flavour. "model" carries TP + EP; "data" carries
# FSDP + DP; "pod" extends DP across pods.
PRESETS = {
    # single device / smoke tests: everything replicated
    "single": ShardingRules(),
    # one pod: (data, model). kv_heads are REPLICATED over the model axis
    # (Megatron GQA convention): kv head counts (1/4/8) never divide a
    # 16-way TP axis, and replicating the small K/V lets the GQA head
    # expansion happen locally instead of as a gather of the repeated
    # tensor.
    "pod": ShardingRules(
        batch="data", embed="data", heads="model", kv_heads=None,
        expert="model", vocab="model", seq=None),
    # two pods: (pod, data, model); batch over both DP axes
    "multipod": ShardingRules(
        batch=("pod", "data"), embed="data", heads="model", kv_heads=None,
        expert="model", vocab="model", seq=None),
    # serving presets: weights are TP-sharded over "model" but REPLICATED
    # over the data axis (embed=None): there is no optimizer state to
    # justify FSDP at inference, and FSDP-sharded weights cost a full
    # weight gather per decoded token. The decode KV cache is
    # sequence-sharded over "model" (kv_seq): kv-head counts rarely
    # divide a 16-way TP axis.
    "pod_serve": ShardingRules(
        batch="data", embed=None, heads="model", kv_heads=None,
        expert="model", vocab="model", seq=None, kv_seq="model"),
    "multipod_serve": ShardingRules(
        batch=("pod", "data"), embed=None, heads="model",
        kv_heads=None, expert="model", vocab="model", seq=None,
        kv_seq="model"),
}


# ------------------------------------------------------------- param rules
#
# (path-regex, logical axes per dim). The FIRST match wins. Patterns match
# the "/"-joined tree path *suffix*. A leading "L/" dim is added
# automatically for stacked-layer params (rank == len(axes) + 1).

PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / unembedding: vocab × embed
    (r"embedding/table$",        ("vocab", "embed")),
    # attention projections
    (r"attn/wq$|cross/wq$",      ("embed", "heads")),
    (r"attn/wk$|cross/wk$",      ("embed", "kv_heads")),
    (r"attn/wv$|cross/wv$",      ("embed", "kv_heads")),
    (r"attn/wo$|cross/wo$",      ("heads", "embed")),
    (r"attn/b[qkv]$|cross/b[qkv]$", ("heads",)),
    (r"(q|k)_norm/scale$",       (None,)),
    # dense mlp
    (r"mlp/wi_(gate|up)$",       ("embed", "heads")),
    (r"mlp/wo$",                 ("heads", "embed")),
    # MoE: expert-sharded tables; router replicated on its output axis
    (r"moe/router$",             ("embed", None)),
    (r"moe/wi_(gate|up)$",       ("expert", "embed", None)),
    (r"moe/wo$",                 ("expert", None, "embed")),
    # mamba (projections are split per output — see mamba.py)
    (r"mamba/in_(x|z)$",         ("embed", "heads")),
    (r"mamba/in_dt$",            ("embed", "heads")),
    (r"mamba/in_bc$",            ("embed", None)),
    (r"mamba/out_proj$",         ("heads", "embed")),
    (r"mamba/x_proj$",           ("heads", None)),
    (r"mamba/dt_proj$",          (None, "heads")),
    (r"mamba/(conv_w|conv_b|conv_bc_w|conv_bc_b|dt_bias|A_log|D)$", None),
    (r"mamba/norm/scale$",       (None,)),
    # norms and any other small vectors: replicated
    (r"(ln\d?|ln_x|norm)/scale$", (None,)),
    (r"frontend_proj/w$",        ("embed", "heads")),
    (r"frontend_proj/b$",        ("heads",)),
]


def _match_rule(path: str, rank: int):
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            if axes is None:
                return P()
            if len(axes) == rank:
                return tuple(axes)
            if len(axes) + 1 == rank:          # stacked-layer leading dim(s)
                return (None,) + tuple(axes)
            if len(axes) + 2 == rank:          # hybrid grouped (G, K, ...)
                return (None, None) + tuple(axes)
    return None


def spec_for_path(path: str, rank: int, rules: ShardingRules) -> P:
    """PartitionSpec for a parameter leaf given its path and rank."""
    m = _match_rule(path, rank)
    if m is None or isinstance(m, P):
        return P()
    return rules.spec(*m)


def tree_paths(tree, prefix: str = ""):
    """A tree shaped like `tree` whose leaves are their "/"-joined paths:
    dict keys as they are, list and tuple entries by index — the strings
    the JAX package's `_path_str` builds for the same tree."""
    if isinstance(tree, dict):
        return {k: tree_paths(v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_paths(v, f"{prefix}/{i}" if prefix
                                     else str(i))
                          for i, v in enumerate(tree))
    return prefix


def tree_specs(params, rules: ShardingRules):
    """PartitionSpec tree matching a parameter (or state) tree."""
    from repro_torch.tree import tree_map
    return tree_map(
        lambda leaf, path: spec_for_path(path, len(getattr(leaf, "shape",
                                                           ())), rules),
        params, tree_paths(params))
