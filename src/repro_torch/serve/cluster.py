"""In-process fault-tolerant serving cluster (the PyTorch port of the JAX
package's cluster, unchanged in behaviour).

`ServeCluster` runs `world` serving ranks — each a `ServeEngine` over the
same immutable params, serving its own slice of the request stream — and
replicates each rank's churning state into its ring buddy's BuddyStore
as delta frames (`ServeReplicator`). A deterministic open-loop load
generator (`LoadGen`) keeps traffic flowing regardless of completions,
and a `TokenSink` ledger receives every emitted token exactly once,
raising on any duplicate or gap.

Faults are injected through the process-global `scenarios.hooks`
registry: the engine fires `serve.decode.step` / `serve.prefill.mid` at
its interruption points and the cluster's injector raises `RankKilled`
there, which the round loop catches — the rank's engine, local store and
unpublished progress are gone, exactly like a process loss.

Recovery strategies (same menu the training scenarios measure):

* ``reinit``  — the rank respawns after `respawn_delay` rounds, composes
  its buddy's held frames, restores, and replays forward. Tokens the
  clients already hold are re-decoded but suppressed by each request's
  emission watermark (set to the sink's delivered count), so nothing is
  re-delivered and nothing is lost.
* ``replica`` — every published frame is eagerly composed into a warm
  standby snapshot on the buddy; promotion restores from it in the same
  round with nothing to compose and (at `publish_every=1`) at most one
  step to replay.

The headline metric is **tokens-to-first-recovered-token**: how many
tokens the surviving ranks deliver between the kill and the first new
token from a request the dead rank owned — the serving analogue of the
paper's recovery-latency measurements.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.memory_ckpt import BuddyStore
from repro_torch.scenarios import hooks

from .engine import Request, ServeEngine
from .replicate import ServeReplicator


class RankKilled(Exception):
    def __init__(self, rank: int):
        super().__init__(f"rank {rank} killed")
        self.rank = rank


class TokenSink:
    """Delivery ledger: the system-of-record for what clients received.

    `__call__(rid, idx, tok)` accepts token `idx` of request `rid`.
    A redelivery must be byte-identical to what the client already holds
    (else it raises — the zero-re-emission property failed); an index gap
    means a token was lost. Both are hard failures, not warnings."""

    def __init__(self):
        self.tokens: Dict[int, List[int]] = {}
        self.order: List[int] = []       # rid per delivery, arrival order

    def __call__(self, rid: int, idx: int, tok: int):
        got = self.tokens.setdefault(rid, [])
        if idx < len(got):
            raise AssertionError(
                f"duplicate delivery rid={rid} idx={idx}")
        if idx > len(got):
            raise AssertionError(
                f"delivery gap rid={rid}: got idx={idx}, "
                f"expected {len(got)}")
        got.append(int(tok))
        self.order.append(rid)

    def delivered(self, rid: int) -> int:
        return len(self.tokens.get(rid, ()))


@dataclasses.dataclass
class Arrival:
    rid: int
    rank: int
    round: int
    prompt: List[int]
    max_new_tokens: int

    def expected_tokens(self, max_len: int) -> int:
        # prefill emits one token, decode adds max_new, truncated by the
        # engine's max_len guard (slot freed at pos == max_len-1)
        return min(self.max_new_tokens + 1,
                   max_len - len(self.prompt))

    def request(self) -> Request:
        return Request(rid=self.rid, prompt=list(self.prompt),
                       max_new_tokens=self.max_new_tokens)


class LoadGen:
    """Seeded open-loop load: the arrival schedule is fixed up front and
    never reacts to completions (requests keep landing while a rank is
    down — that is the point). Round-robin rank assignment by rid."""

    def __init__(self, *, world: int, rounds: int, per_round: int = 1,
                 prompt_lens=(4, 4, 6), max_new: int = 5,
                 vocab: int = 64, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.arrivals: List[Arrival] = []
        rid = 0
        for rnd in range(rounds):
            for _ in range(per_round):
                plen = int(prompt_lens[rid % len(prompt_lens)])
                prompt = [int(t) for t in rng.integers(1, vocab, plen)]
                self.arrivals.append(Arrival(
                    rid=rid, rank=rid % world, round=rnd,
                    prompt=prompt, max_new_tokens=max_new))
                rid += 1

    def due(self, rnd: int, rank: int) -> List[Arrival]:
        return [a for a in self.arrivals
                if a.round == rnd and a.rank == rank]

    def for_rank(self, rank: int) -> List[Arrival]:
        return [a for a in self.arrivals if a.rank == rank]


class ServeCluster:
    def __init__(self, model, params, *, world: int = 2, n_slots: int = 4,
                 max_len: int = 64, strategy: str = "reinit",
                 publish_every: int = 2, respawn_delay: int = 2,
                 base_every: int = 4, prefill_batch: Optional[int] = None,
                 engine_kw: Optional[dict] = None):
        if strategy not in ("reinit", "replica"):
            raise ValueError(strategy)
        self.model, self.params = model, params
        self.world, self.n_slots, self.max_len = world, n_slots, max_len
        self.strategy = strategy
        # a replica stream must carry every step or promotion would
        # silently become a replay strategy
        self.publish_every = 1 if strategy == "replica" else publish_every
        self.respawn_delay = 0 if strategy == "replica" else respawn_delay
        self.base_every = base_every
        self.prefill_batch = prefill_batch
        self.engine_kw = dict(engine_kw or {})
        self.sink = TokenSink()
        self.stores: Dict[int, BuddyStore] = {}
        self.engines: Dict[int, Optional[ServeEngine]] = {}
        self.reps: Dict[int, ServeReplicator] = {}
        self.standby: Dict[int, dict] = {}     # origin -> warm snapshot
        self.alive = [True] * world
        self.down_until: Dict[int, int] = {}
        self.submitted: Dict[int, Dict[int, Arrival]] = {
            r: {} for r in range(world)}
        self.metrics: Dict[str, Any] = {"kills": []}
        for r in range(world):
            self.stores[r] = BuddyStore(r, world,
                                        push_remote=self._push_remote(r))
            self.engines[r] = self._new_engine(r)
            self.reps[r] = ServeReplicator(self.stores[r],
                                           base_every=base_every)

    # ------------------------------------------------------------ fabric

    def _push_remote(self, origin: int):
        def push(buddy: int, step: int, payload: bytes):
            # dead buddies drop the push, like a refused TCP connect
            if self.alive[buddy]:
                self.stores[buddy].hold(origin, step, payload)
                if self.strategy == "replica":
                    # eager apply: the standby snapshot is always the
                    # newest composable state of the origin
                    self.standby[origin] = ServeReplicator.compose(
                        self.stores[buddy].held_map(origin))
        return push

    def _buddy_of(self, rank: int) -> int:
        return (rank + 1) % self.world

    def _new_engine(self, rank: int) -> ServeEngine:
        return ServeEngine(self.model, self.params, n_slots=self.n_slots,
                           max_len=self.max_len, sink=self.sink,
                           prefill_batch=self.prefill_batch,
                           name=f"rank{rank}", **self.engine_kw)

    # -------------------------------------------------------------- run

    def run(self, load: LoadGen, *, rounds: int,
            fault: Optional[dict] = None,
            drain_rounds: int = 400) -> Dict[str, Any]:
        """Drive the cluster: `rounds` of open-loop arrivals, then drain.
        `fault`: {"round": r, "rank": k, "point": <serve hook point>} —
        installed through the scenarios hook registry for the duration
        of the run. Returns the metrics dict; the sink holds the
        transcripts."""
        self._round = 0
        prev = hooks.active()
        if fault is not None:
            hooks.install(self._injector(fault))
        try:
            total = rounds + drain_rounds
            for rnd in range(total):
                self._round = rnd
                self._revive_due(rnd)
                for rank in range(self.world):
                    for a in load.due(rnd, rank):
                        self.submitted[rank][a.rid] = a
                        if self.alive[rank]:
                            self.engines[rank].submit(a.request())
                        # a down rank's arrivals wait in `submitted`
                        # and are replayed into the respawned engine
                for rank in range(self.world):
                    if not self.alive[rank]:
                        continue
                    try:
                        self.engines[rank].step()
                    except RankKilled as k:
                        self._on_kill(k.rank, rnd)
                        continue
                    if rnd % self.publish_every == 0:
                        self.reps[rank].publish(self.engines[rank])
                if rnd >= rounds and self._drained(load):
                    break
            return self._finalize(load)
        finally:
            hooks.clear()
            if prev is not None:
                hooks.install(prev)

    def _injector(self, fault: dict):
        tgt_point, tgt_rank = fault["point"], fault["rank"]
        tgt_round = fault["round"]
        fired = [False]

        def inject(point: str, **ctx):
            if fired[0] or point != tgt_point:
                return
            eng = ctx.get("engine")
            if eng is None or eng.name != f"rank{tgt_rank}":
                return
            if self._round < tgt_round:
                return
            fired[0] = True
            raise RankKilled(tgt_rank)

        return inject

    # --------------------------------------------------------- recovery

    def _on_kill(self, rank: int, rnd: int):
        self.alive[rank] = False
        self.engines[rank] = None
        self.metrics["kills"].append(
            {"rank": rank, "round": rnd, "strategy": self.strategy,
             "sink_mark": len(self.sink.order)})
        self.down_until[rank] = rnd + self.respawn_delay
        # local store and unpublished frames die with the process; the
        # buddy's held copies are what recovery composes from
        self.stores[rank] = BuddyStore(rank, self.world,
                                       push_remote=self._push_remote(rank))
        # the dead rank held its predecessors' frame history: every rank
        # whose buddy just vanished re-anchors its stream (next frame
        # full) so no delta ever chains to frames nobody holds
        for r in range(self.world):
            if r != rank and self._buddy_of(r) == rank:
                self.reps[r].rebase()

    def _revive_due(self, rnd: int):
        for rank, due in list(self.down_until.items()):
            if rnd >= due:
                del self.down_until[rank]
                self._recover(rank, rnd)

    def _recover(self, rank: int, rnd: int):
        if self.strategy == "replica" and rank in self.standby:
            snap = self.standby[rank]
        else:
            held = self.stores[self._buddy_of(rank)].held_map(rank)
            try:
                snap = ServeReplicator.compose(held)
            except KeyError:
                snap = None      # died before the first publish: cold
                                 # start, every request re-submits
        eng = self._new_engine(rank)
        if snap is not None:
            eng.restore(snap)
        replay = 0
        # watermarks: anything the clients already hold must be
        # re-decoded silently, never re-delivered
        for req in eng.live_requests():
            d = self.sink.delivered(req.rid)
            replay += max(0, d - req.emitted)
            req.emitted = max(req.emitted, d)
        live = {r.rid for r in eng.live_requests()}
        done_in_snap = {s["rid"] for s in (snap["slots"] if snap else [])
                        if s and s["done"]}
        # re-submit what the snapshot never saw (arrived after the
        # frame) or what it had already retired but the clients had not
        # fully received; dedupe by rid
        for rid, a in sorted(self.submitted[rank].items()):
            if a.round > rnd or rid in live or rid in done_in_snap:
                continue
            exp = a.expected_tokens(self.max_len)
            if self.sink.delivered(rid) >= exp:
                continue
            req = a.request()
            req.emitted = self.sink.delivered(rid)
            eng.submit(req)
        self.engines[rank] = eng
        # continue the step numbering past the dead incarnation's chain
        # so stale held frames on the buddy age out of the window
        self.reps[rank] = ServeReplicator(self.stores[rank],
                                          base_every=self.base_every,
                                          start_step=self.reps[rank]
                                          .next_step)
        self.alive[rank] = True
        self.metrics["kills"][-1].update(
            {"recovered_round": rnd, "rounds_down": rnd -
             self.metrics["kills"][-1]["round"], "replayed_tokens": replay})

    # --------------------------------------------------------- plumbing

    def _drained(self, load: LoadGen) -> bool:
        if not all(self.alive):
            return False
        for rank in range(self.world):
            eng = self.engines[rank]
            if eng.queue or any(s is not None for s in eng.slots):
                return False
        return True

    def _finalize(self, load: LoadGen) -> Dict[str, Any]:
        dropped = []
        for a in load.arrivals:
            if self.sink.delivered(a.rid) < a.expected_tokens(self.max_len):
                dropped.append(a.rid)
        self.metrics["requests_dropped"] = len(dropped)
        self.metrics["dropped_rids"] = dropped
        self.metrics["tokens_delivered"] = len(self.sink.order)
        for kill in self.metrics["kills"]:
            owned = {a.rid for a in load.for_rank(kill["rank"])}
            mark = kill["sink_mark"]
            first = next((i for i, rid in
                          enumerate(self.sink.order[mark:])
                          if rid in owned), None)
            kill["tokens_to_first_recovered_token"] = first
        return self.metrics

    def transcripts(self) -> Dict[int, List[int]]:
        """rid -> delivered tokens, the client-visible ground truth."""
        return {rid: list(t) for rid, t in self.sink.tokens.items()}
