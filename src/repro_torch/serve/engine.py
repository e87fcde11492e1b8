"""Batched serving engine: slot-based continuous batching over decode_step.

A fixed pool of `n_slots` sequences shares one decode step. Requests
occupy free slots, prefill writes their prompt KV state into the slot,
and every engine step decodes one token for all active slots.

Positions are *per slot*: the engine passes a `(n_slots,)` position vector
into `decode_step`, so each slot writes its KV at its own clock and its
causal mask is built from its own position — ragged occupancy (slots
admitted at different times) decodes exactly like `n_slots` independent
single-sequence streams. A slot's output therefore never depends on what
the other slots are doing, which is also what makes recovery replay
bit-identical regardless of how admission interleaves after a restore.
A MoE model is the exception, as in the reference: its routing groups
are cut from every lane of a call, and lanes in one group share each
expert's capacity (ROADMAP C7).

Admission is batched: queued requests with equal prompt length are
prefilled together, lane-padded to a *fixed* `prefill_batch` width so the
prefill shape (and with it every lane's bitwise result) does not depend
on how many requests happened to be waiting. A small LRU keyed on the
prompt reuses the prefill of repeated prompts.

Emission: tokens leave the engine through the `sink` callback exactly
once, tracked by a per-request `emitted` watermark. A restored engine
whose watermark was advanced to the client's delivered count re-decodes
the gap silently — no token that already left the system is ever
re-delivered.

Fault tolerance: `snapshot()`/`restore()` capture and reinstate the full
churning state — decode KV state, slot table, *and* the pending queue —
without stalling the decode stream (device clones + an async copy to
pinned host memory). `serve.replicate.ServeReplicator` turns snapshots
into BuddyStore delta frames, and `serve.cluster.ServeCluster` drives
rank loss + recovery under load.

This is the PyTorch port of the JAX package's engine, with two
differences. The decode step updates the KV caches in place (the
reference donates them to the same end). Admission writes a prefilled
lane along each state leaf's batch axis as the model names it
(`Model.decode_state_batch_axes`: axis 1 of the dense `(L, B, S, Hkv,
hd)`, axis 2 of a hybrid's Mamba2 `(G, E, B, ...)`); the reference finds
that axis by its size, which picks a layer or group axis when one equals
n_slots and prefill_batch (ROADMAP C2).

With `mesh`/`rules` every rank of the mesh runs the engine (one process a
device, each fed the same requests): the parameters are placed by
`tree_shardings`, the decode state as DTensors by the model's
`decode_state_specs` fitted by `_divisible` (lanes over the data axis,
the KV sequence over kv_seq), and each prefill and decode step runs in a
constraint scope on token batches split by `batch_spec`. Admission
writes a prefilled lane into the rank that holds its slot, without
gathering the cache; snapshots and restores keep the placements.

Prefill takes the prompt's tokens alone, as in the reference: a vlm model
is served without its frontend, and an encdec model, whose prefill needs
the encoder's input `enc_emb`, is refused when the engine is made (the
reference fails at its first admission; ROADMAP C8).
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import HostCopy, host_leaf, is_dtensor, to_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import family
from repro_torch.scenarios import hooks
from repro_torch.sharding.partition import (NamedSharding, _divisible,
                                            batch_spec, constraint_scope,
                                            distribute, distribute_tree,
                                            from_full, gather, local_offsets,
                                            named, tree_shardings)
from repro_torch.tree import tree_leaves, tree_map

@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # emission watermark: #tokens of `out` already delivered to the sink.
    # Recovery sets it to the client's delivered count so replayed tokens
    # are re-decoded but never re-delivered.
    emitted: int = 0

    def to_dict(self) -> dict:
        return {"rid": int(self.rid), "prompt": [int(t) for t in self.prompt],
                "max_new_tokens": int(self.max_new_tokens),
                "out": [int(t) for t in self.out],
                "done": bool(self.done), "emitted": int(self.emitted)}

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        return cls(rid=d["rid"], prompt=list(d["prompt"]),
                   max_new_tokens=d["max_new_tokens"], out=list(d["out"]),
                   done=d["done"], emitted=d["emitted"])


class SnapshotLeaf:
    """One leaf of `ServeEngine.snapshot()`: a clone on the device (a
    DTensor keeps its placements), and for a plain CUDA leaf its copy
    into pinned host memory, started without waiting. `host()` waits for
    that copy (a DTensor leaf is assembled, by every rank of its mesh);
    `restore` clones `dev`."""

    __slots__ = ("dev", "copy")

    def __init__(self, t: torch.Tensor):
        self.dev = t.detach().clone()
        self.copy = HostCopy(self.dev) \
            if self.dev.is_cuda and not is_dtensor(self.dev) else None

    def host(self):
        """The leaf on the host (numpy, or a CPU tensor for bfloat16)."""
        return self.copy.result() if self.copy is not None \
            else host_leaf(gather(self.dev))


def _local_lanes(dst, src, axis: int, pairs: list):
    """For a DTensor decode-state leaf: (its local shard, the prefill
    leaf `src` laid out like it but whole along `axis`, the (local slot,
    lane) pairs of the slots this rank holds)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = dst.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim == axis else p
          for p in dst.placements]
    if is_dtensor(src):
        src = src.redistribute(mesh, pl)
    else:
        src = from_full(src.to(dst.device), mesh, pl)
    local = dst.to_local()
    lo, n = local_offsets(dst)[axis], local.shape[axis]
    return local, src.to_local(), [(d - lo, s) for d, s in pairs
                                   if lo <= d < lo + n]


def host_state(state):
    """A snapshot's state tree with every leaf on the host."""
    return tree_map(lambda a: a.host() if isinstance(a, SnapshotLeaf)
                    else a, state)


class ServeEngine:
    def __init__(self, model: Model, params, *, n_slots: int = 4,
                 max_len: int = 256, greedy: bool = True,
                 prefill_batch: Optional[int] = None,
                 prefill_cache: int = 0,
                 mesh=None, rules=None,
                 sink: Optional[Callable[[int, int, int], None]] = None,
                 name: str = "serve0"):
        needs = [k for k in family(model.cfg).prefill_inputs
                 if k != "tokens"]
        if needs:
            raise ValueError(
                f"ServeEngine prefills from the prompt's tokens alone, and "
                f"the {model.cfg.family} model {model.cfg.name!r} needs "
                f"{', '.join(needs)} at prefill (ROADMAP C8): call "
                f"Model.prefill and Model.decode_step with those inputs "
                f"instead")
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.greedy = greedy
        self.name = name
        self.sink = sink
        # fixed prefill lane count: groups are padded up to this width so
        # the prefill shape never depends on queue occupancy
        self.prefill_batch = min(n_slots, 4) if prefill_batch is None \
            else max(1, min(prefill_batch, n_slots))
        self.mesh, self.rules = mesh, rules
        self._state_shd = None
        if mesh is not None:
            if rules is None:
                raise ValueError("mesh requires sharding rules")
            params = distribute_tree(params,
                                     tree_shardings(mesh, params, rules))
            self._state_shd = self._decode_state_shardings()
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.state = self._place(model.init_decode_state(
            n_slots, max_len, device=self.device))
        # the batch axis of each state leaf, in a tree shaped like it
        self.batch_axes = model.decode_state_batch_axes()
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int32)       # next position per slot
        self.queue: list[Request] = []
        self.completed: list[Request] = []
        self._decode = model.decode_step
        self._prefill_fn = lambda p, t: model.prefill(p, {"tokens": t},
                                                      max_len=self.max_len)
        # repeated-prompt prefill reuse: prompt -> (first token, one-lane
        # host state). A prompt is cached on its *second* miss, so
        # one-shot prompts never pay the host copy.
        self.prefill_cache_size = prefill_cache
        self._prefill_cache: OrderedDict[tuple, tuple] = OrderedDict()
        self._seen_prompts: set[tuple] = set()
        self._tick = 0                     # engine steps taken (monotonic)
        self.prefill_calls = 0             # model prefills run (cache misses)

    # ----------------------------------------------------------- sharding

    def _decode_state_shardings(self):
        meta = self.model.init_decode_state(self.n_slots, self.max_len,
                                            device="meta")
        return tree_map(
            lambda leaf, s: NamedSharding(self.mesh, _divisible(
                s, leaf.shape, self.mesh)),
            meta, self.model.decode_state_specs(self.rules))

    def _place(self, state):
        """A decode state on the mesh: plain leaves (the same on every
        rank) placed by the decode-state shardings, DTensors as they
        are."""
        if self._state_shd is None:
            return state
        return tree_map(lambda a, s: a if is_dtensor(a) else distribute(a, s),
                        state, self._state_shd)

    def _scope(self):
        return constraint_scope(self.mesh, self.rules) \
            if self.mesh is not None else contextlib.nullcontext()

    def _tokens(self, toks: np.ndarray):
        """A (B, S) token batch on the device, its lanes split over the
        batch axes under a mesh."""
        t = torch.from_numpy(toks).to(self.device)
        if self.mesh is None:
            return t
        return distribute(t, named(self.mesh, _divisible(
            batch_spec(self.rules), t.shape, self.mesh)))

    # -------------------------------------------------------------- admin

    def submit(self, req: Request):
        if len(req.prompt) >= self.max_len - 1:
            raise ValueError(f"prompt of {len(req.prompt)} tokens does not "
                             f"fit max_len={self.max_len}")
        self.queue.append(req)
        tracing.begin("request.queued", (self.name, req.rid), rid=req.rid,
                      engine=self.name)

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def _flush(self, req: Request):
        """Deliver every not-yet-emitted token. A watermark ahead of
        `out` (set by recovery) suppresses delivery until decode has
        replayed past it."""
        while req.emitted < len(req.out):
            if self.sink is not None:
                self.sink(req.rid, req.emitted, req.out[req.emitted])
            req.emitted += 1

    def _finish_if_done(self, slot: int, req: Request):
        # the prefill-emitted token is the first *generated* token but
        # does not count toward max_new_tokens: a request gets exactly
        # max_new_tokens decode-step tokens on top of it
        if len(req.out) - 1 >= req.max_new_tokens \
                or self.pos[slot] >= self.max_len - 1:
            req.done = True
            self.completed.append(req)
            self.slots[slot] = None

    # ---------------------------------------------------------- admission

    def _splice(self, slot_idx: list[int], lanes: list[int], src_state):
        """Write lanes of a prefilled batch-`g` state into the given
        slots of the decode state, in place, along the batch axis. A
        DTensor leaf is written shard by shard: the prefill state (small)
        is laid out like the leaf but with every lane on every rank, and
        each rank writes the slots its shard holds."""
        def sp(dst, src, axis):
            if dst.dim() != src.dim():
                raise ValueError(f"rank mismatch {tuple(dst.shape)} vs "
                                 f"{tuple(src.shape)}")
            pairs = list(zip(slot_idx, lanes))
            if is_dtensor(dst):
                dst, src, pairs = _local_lanes(dst, src, axis, pairs)
            else:
                src = src.to(self.device)
            if not pairs:
                return
            dst_idx = torch.tensor([d for d, _ in pairs], device=dst.device)
            src_idx = torch.tensor([s for _, s in pairs], device=dst.device)
            lanes_ = src.index_select(axis, src_idx).to(dst.dtype)
            dst.index_copy_(axis, dst_idx, lanes_)

        tree_map(sp, self.state, src_state, self.batch_axes)

    def _cache_get(self, key: tuple):
        hit = self._prefill_cache.get(key)
        if hit is not None:
            self._prefill_cache.move_to_end(key)
        return hit

    def _cache_put(self, key: tuple, nxt: int, lane_state):
        if self.prefill_cache_size <= 0 or key in self._prefill_cache:
            return
        if key not in self._seen_prompts:
            self._seen_prompts.add(key)          # cache on second sighting
            return
        host = tree_map(lambda a: a.cpu(), lane_state)
        self._prefill_cache[key] = (nxt, host)
        while len(self._prefill_cache) > self.prefill_cache_size:
            self._prefill_cache.popitem(last=False)

    def _lane_state(self, src_state, lane: int):
        """One lane of a batch-G prefill state, lane axis kept (size 1);
        under a mesh, assembled (the prefill state, not the cache)."""
        return tree_map(lambda a, axis: gather(a).narrow(axis, lane, 1),
                        src_state, self.batch_axes)

    def _commit_admission(self, slot: int, req: Request, nxt: int):
        req.out.append(int(nxt))
        self.slots[slot] = req
        self.pos[slot] = len(req.prompt)
        self._finish_if_done(slot, req)
        self._flush(req)

    @torch.no_grad()
    def _admit(self):
        """Prefill queued requests into free slots, in strict FIFO order,
        batching maximal same-prompt-length queue prefixes up to the
        fixed `prefill_batch` width."""
        free = self._free_slots()
        while free and self.queue:
            key = tuple(self.queue[0].prompt)
            hit = self._cache_get(key) if self.prefill_cache_size else None
            if hit is not None:
                nxt, lane_state = hit
                # interruption point: admission decided, nothing committed
                hooks.fire("serve.prefill.mid", engine=self,
                           rids=[self.queue[0].rid])
                req = self.queue.pop(0)
                tracing.end("request.queued", (self.name, req.rid))
                slot = free.pop(0)
                self._splice([slot], [0], lane_state)
                self._commit_admission(slot, req, nxt)
                continue
            head_len = len(self.queue[0].prompt)
            width = min(len(free), self.prefill_batch)
            take = []
            for r in self.queue:
                if len(take) >= width or len(r.prompt) != head_len:
                    break
                take.append(r)
            # lane-pad to the fixed width: dummy lanes replicate lane 0,
            # and per-lane data independence keeps real lanes bit-exact,
            # except where a MoE routing group spans lanes and they share
            # its capacity (ROADMAP C7; the reference behaves alike)
            toks = np.tile(np.asarray(take[0].prompt, np.int64),
                           (self.prefill_batch, 1))
            for i, r in enumerate(take):
                toks[i] = np.asarray(r.prompt, np.int64)
                tracing.end("request.queued", (self.name, r.rid))
            pad = self.prefill_batch - len(take)
            with tracing.span("engine.prefill", lanes=len(take),
                              pad_lanes=pad, S=head_len):
                tracing.count("engine.prefill_tokens", len(take) * head_len)
                tracing.count("engine.prefill_pad_tokens", pad * head_len)
                with self._scope():
                    logits, st = self._prefill_fn(self.params,
                                                  self._tokens(toks))
                nxts = gather(logits[:, -1]).argmax(-1).cpu().numpy()
            self.prefill_calls += 1
            # interruption point: prefill computed, nothing committed —
            # a kill here loses the compute but neither queue nor slots
            hooks.fire("serve.prefill.mid", engine=self,
                       rids=[r.rid for r in take])
            slots = free[:len(take)]
            free = free[len(take):]
            self._splice(slots, list(range(len(take))), st)
            for lane, (slot, req) in enumerate(zip(slots, take)):
                self.queue.remove(req)
                self._cache_put(tuple(req.prompt), int(nxts[lane]),
                                self._lane_state(st, lane))
                self._commit_admission(slot, req, int(nxts[lane]))

    # --------------------------------------------------------------- step

    @torch.no_grad()
    def step(self) -> int:
        """One decode step for all active slots; returns #active."""
        hooks.fire("serve.decode.step", engine=self, step=self._tick)
        self._tick += 1
        with tracing.span("engine.admit"):
            self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        # current token per slot: last emitted (or pad for empty slots)
        cur = np.zeros((self.n_slots, 1), np.int64)
        for i in active:
            cur[i, 0] = self.slots[i].out[-1]
        # per-slot positions: each slot writes its KV at its own clock
        # and masks from its own position; inactive slots decode padding
        # into lanes that the next admission's prefill fully overwrites
        with tracing.span("engine.decode", active=len(active)):
            with self._scope():
                logits, self.state = self._decode(
                    self.params, self._tokens(cur), self.state,
                    torch.from_numpy(self.pos.astype(np.int64)).to(
                        self.device))
            nxt = gather(logits[:, 0]).argmax(-1).cpu().numpy()
        for i in active:
            req = self.slots[i]
            req.out.append(int(nxt[i]))
            self.pos[i] += 1
            self._finish_if_done(i, req)
            self._flush(req)
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        """Step until queue and slots are empty; returns every request
        completed by this engine (including ones finished before the
        call)."""
        for _ in range(max_steps):
            n = self.step()
            if n == 0 and not self.queue:
                break
        return list(self.completed)

    # ---------------------------------------------------- fault tolerance

    def snapshot(self) -> dict:
        """Capture the churning state — decode KV, slot table, *and*
        pending queue — without stalling the decode stream: each leaf is
        cloned on the device (the decode step updates the live caches in
        place) and its copy to pinned host memory is *started*, not
        awaited. The copy overlaps subsequent engine steps and is waited
        for only if and when the snapshot is read on the host
        (`host_state`, the replicator)."""
        return {
            "state": tree_map(SnapshotLeaf, self.state),
            "pos": self.pos.copy(),
            "slots": [s.to_dict() if s else None for s in self.slots],
            "queue": [r.to_dict() for r in self.queue],
            "tick": self._tick,
        }

    def restore(self, snap: dict):
        """Reinstate a snapshot — from `snapshot()` or composed from
        frames (`ServeReplicator.compose`, host leaves): decode state,
        per-slot positions, slot table (with each request's done flag and
        emission watermark) and the pending queue. The state is copied,
        so restoring the same snapshot twice survives the decode step's
        in-place updates."""
        def place(a):
            if isinstance(a, SnapshotLeaf):
                return a.dev.clone()
            return to_device(a, self.device)

        self.state = self._place(tree_map(place, snap["state"]))
        self.pos = np.asarray(snap["pos"], np.int32).copy()
        self.slots = [Request.from_dict(d) if d else None
                      for d in snap["slots"]]
        self.queue = [Request.from_dict(d) for d in snap.get("queue", ())]
        self._tick = int(snap.get("tick", self._tick))
        for r in self.queue:
            tracing.begin("request.queued", (self.name, r.rid), rid=r.rid,
                          engine=self.name, restored=True)

    def live_requests(self) -> list[Request]:
        """Every request the engine still owns (slots + queue)."""
        return [s for s in self.slots if s is not None] + list(self.queue)
