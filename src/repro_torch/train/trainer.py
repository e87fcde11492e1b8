"""Fault-tolerant training driver — the paper's Fig. 2 made executable,
in PyTorch on one device.

The driver wraps its main loop in `reinit_main` (the MPI_Reinit analogue).
A deterministic FaultInjector kills a random rank (or node) at a random
step; the configured RecoveryStrategy then *actually performs* its recovery
actions on the training state:

  CR        drop everything (state, the step function), re-"deploy" and
            reload the latest FILE checkpoint.
  Reinit++  survivors keep device state and the step function; the lost
            shard's state is restored from the buddy MEMORY checkpoint
            (process failure) or the file checkpoint (node failure);
            Algorithms 1/2 re-form the cluster view.
  ULFM      like Reinit++ for state, but pays revoke/shrink/agree all-rank
            agreement rounds during recovery and a heartbeat tax on every
            fault-free step.
  Replica   a warm shadow copy of the state, mirrored after every step,
            is promoted in place: no rollback.
  Shrink    elastic: re-host onto a spare while the pool lasts, then
            contract the world (a node's group, or one rank) down to the
            `min_data_parallel` floor; a repaired node grows it back.

Gray (slow/lossy) faults are observed per rank as modelled barrier
lateness; with `mitigate=True` under the elastic strategy a persistent
straggler is drained through the shrink path.

Because the data pipeline is step-indexed and checkpoints are taken every
policy-interval, a failed-and-recovered run converges to the bit-identical
state of an uninterrupted run. On the card that needs deterministic
kernels: the entry points call `repro_torch.device.set_deterministic()`.

With `mesh`/`rules` every rank of the mesh runs this driver (one process a
device): the state is held as DTensors placed by `state_shardings`, each
step runs in a constraint scope on the rank's slice of the global batch
(placed by `batch_spec`), the buddy copy is a real ring of shards over the
data axis (`buddy_exchange`, when that axis is longer than one) and the
file tier is written by the mesh's origin rank. The injector is
deterministic and every rank holds the same view, so every rank takes
the same recovery branch. A shrink or grow-back bumps the mesh epoch as
bookkeeping (the devices stay; as in the reference) and rebuilds the step
function, and the global batch never changes, so a shrunk run's final
state is bit-identical to the fault-free run's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch.checkpoint import FileCheckpointer, buddy_exchange, \
    restore_from_buddy
from repro_torch.checkpoint.policy import CheckpointPolicy
from repro_torch.core import (ClusterView, ElasticManager, FailureEvent,
                              FailureType, FaultInjector, MeshEpoch,
                              RankState, RecoveryReport, ROLLBACK,
                              RollbackSignal, apply_recovery, get_strategy,
                              reinit_main, root_handle_failure)
from repro_torch.device import resolve, to_device
from repro_torch.models.model import Model
from repro_torch.scenarios.schema import GRAY_DRAIN_PERSIST, GRAY_HOWS, \
    gray_delay_s
from repro_torch.sharding.partition import (batch_spec, constraint_scope,
                                            distribute, distribute_tree,
                                            gather, named,
                                            state_shardings, _divisible)
from repro_torch.sharding.rules import PRESETS, ShardingRules
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .data import TokenPipeline
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .straggler import StragglerTracker


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 50
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_every: int = 1
    ckpt_shards: int = 4
    # K>1: full file snapshot every K-th save, dirty-tile deltas between
    ckpt_delta_every: int = 0
    # N>0: background re-base rewrites a delta chain as a fresh base once
    # it reaches N links
    ckpt_rebase_after: int = 0
    # device dirty-tile gather for delta saves: auto/on/off
    ckpt_gather: str = "auto"
    async_file_ckpt: bool = False
    strategy: str = "reinit"
    # logical deployment (the paper's root/daemon/rank tree)
    n_nodes: int = 2
    ranks_per_node: int = 4
    spare_nodes: int = 1
    # elastic world floor, in whole node groups: shrinking recovery
    # refuses to contract below min_data_parallel * ranks_per_node ranks
    min_data_parallel: int = 1
    # gray-failure policy: off tolerates a degraded rank (the run slows,
    # nothing else changes); on drains a persistent straggler through
    # the shrink path and re-admits it at the repair's grow-back
    mitigate: bool = False
    seed: int = 0
    log_every: int = 0
    device: str = "cuda"


@dataclasses.dataclass
class StepLog:
    step: int
    loss: float
    seconds: float
    heartbeat_overhead: float = 0.0


def _clone(state):
    """Device copy of a state tree."""
    return tree_map(lambda a: a.clone(), state)


class Trainer:
    def __init__(self, model: Model, data: TokenPipeline,
                 opt_cfg: AdamWConfig, tc: TrainConfig, *,
                 mesh=None, rules: Optional[ShardingRules] = None,
                 injector: Optional[FaultInjector] = None):
        self.model = model
        self.data = data
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.mesh = mesh
        self.rules = rules or PRESETS["single"]
        self.device = resolve(tc.device)
        self.strategy = get_strategy(tc.strategy)
        self.injector = injector
        self.view = ClusterView.build(tc.n_nodes, tc.ranks_per_node,
                                      tc.spare_nodes)
        self.n_ranks = tc.n_nodes * tc.ranks_per_node
        # elastic strategy: the membership machine owns the spare pool,
        # the shrink/grow decisions and the dropped-rank ledger; one node
        # = one data-parallel group. The mesh epoch is bookkeeping only
        # (the devices of a mesh stay through a shrink, as in the
        # reference)
        self.elastic = ElasticManager(
            self.view, MeshEpoch(epoch=0, data_parallel=tc.n_nodes,
                                 model_parallel=tc.ranks_per_node),
            min_data_parallel=tc.min_data_parallel) \
            if self.strategy.key == "shrink" else None
        self.policy = CheckpointPolicy(every_steps=tc.ckpt_every,
                                       async_file=tc.async_file_ckpt)
        self.file_ckpt = FileCheckpointer(
            tc.ckpt_dir, n_shards=tc.ckpt_shards,
            delta_every=tc.ckpt_delta_every, gather=tc.ckpt_gather,
            rebase_after=tc.ckpt_rebase_after, mesh=mesh)
        # buddy memory checkpoint: (step, state_copy, buddy_copy)
        self.mem_ckpt: Optional[tuple[int, Any, Any]] = None
        # replica strategy: the victim's warm shadow — a device copy of
        # the state mirrored after *every* step (the replication stream),
        # hosted off-node by construction, so recovery is promote-and-
        # continue with zero rollback
        self.shadow_ckpt: Optional[tuple[int, Any]] = None
        self.state: Optional[dict] = None
        self.logs: list[StepLog] = []
        self.reports: list[RecoveryReport] = []
        self.straggler = StragglerTracker()
        # gray-failure plan from the injector's scenario (if any): the
        # (index, fault) pairs whose victims get modelled per-rank
        # delays, and the set already cured by a drain. A gray plan
        # re-tunes the tracker: few samples suffice, and the absolute
        # floor at half the smallest injected delay keeps jitter out.
        self._gray: list = []
        self._gray_mitigated: set[int] = set()
        sc = getattr(injector, "scenario", None)
        if sc is not None:
            self._gray = [(i, f) for i, f in enumerate(sc.faults)
                          if f.how in GRAY_HOWS]
        if self._gray:
            self.straggler = StragglerTracker(
                window=32, threshold_mads=4.0, min_samples=2,
                min_flag_s=0.5 * min(gray_delay_s(f)
                                     for _, f in self._gray))
        self._build_step()

    # ----------------------------------------------------------- stepping

    def _build_step(self):
        model, opt_cfg = self.model, self.opt_cfg

        def train_step(state, batch):
            params = tree_map(lambda p: p.detach().requires_grad_(),
                              state["params"])
            loss, metrics = model.loss_fn(params, batch)
            # a leaf the loss does not reach (a vlm's frontend_proj on a
            # batch of tokens alone) gets zeros, as jax.grad gives it
            grads = torch.autograd.grad(loss, tree_leaves(params),
                                        materialize_grads=True)
            with torch.no_grad():
                new_p, new_opt, om = adamw_update(
                    state["params"], tree_unflatten(params, list(grads)),
                    state["opt"], opt_cfg)
            new_state = {"params": new_p, "opt": new_opt,
                         "step": state["step"] + 1}
            return new_state, (loss.detach(), {**metrics, **om})

        self._step_fn = train_step

    def _step(self, state, batch):
        if self.mesh is None:
            return self._step_fn(state, batch)
        with constraint_scope(self.mesh, self.rules):
            new, out = self._step_fn(state, self._place_batch(batch))
            # the step's result laid out as its input was (a replicated
            # leaf's update comes back as a pending sum)
            return tree_map(lambda a, s: a.redistribute(s.mesh,
                                                        s.placements),
                            new, state_shardings(self.mesh, new,
                                                 self.rules)), out

    def _place_batch(self, batch):
        """This rank's slice of the global batch, as DTensors."""
        return {k: distribute(v, named(self.mesh, _divisible(
            batch_spec(self.rules), v.shape, self.mesh)))
            for k, v in batch.items()}

    # -------------------------------------------------------------- state

    def init_state(self) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = self.model.init(gen)
        return self._place({"params": params, "opt": adamw_init(params),
                            "step": torch.zeros((), dtype=torch.int32,
                                                device=self.device)})

    def _place(self, state) -> dict:
        """A state of plain tensors (the same on every rank) placed on the
        mesh by `state_shardings`; as it is without a mesh."""
        if self.mesh is None:
            return state
        return distribute_tree(state, state_shardings(self.mesh, state,
                                                      self.rules))

    def _load_state(self, state) -> dict:
        return self._place(tree_map(lambda a: to_device(a, self.device),
                                    state))

    def _data_parallel(self) -> bool:
        """Whether the mesh's data axis is longer than one (the buddy copy
        then lives on another rank)."""
        return self.mesh is not None \
            and "data" in self.mesh.mesh_dim_names \
            and self.mesh.size(self.mesh.mesh_dim_names.index("data")) > 1

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _injected_at(self, point: str, step: Optional[int] = None):
        """Scenario fault due at a named interruption point — how the
        in-process driver reaches the checkpoint-phase and cascade
        injection points the real runtime fires through
        repro_torch.scenarios.hooks."""
        inj = self.injector
        if inj is None or not hasattr(inj, "check_point"):
            return None
        live = set(self.view.ranks())
        return inj.check_point(
            point, step=step, view=self.view,
            eligible=lambda f: f.target != "rank" or f.rank in live)

    def _save_ckpt(self, step: int):
        """Both faces of Table 2: buddy memory copy + file checkpoint.

        Mirrors the real worker's commit order (file first, then the
        buddy push) so the checkpoint-phase interruption points carry
        the same meaning: a mid-write death leaves both tiers at step-1;
        a pre-push death leaves the file one step ahead of the buddy
        copy, and the merged restore must still reach `step`."""
        failure = self._injected_at("worker.ckpt.mid_write", step)
        if failure is not None:
            # dies with the shard bytes un-renamed: nothing durable at
            # `step` anywhere — recovery resumes from step-1; the replica
            # shadow goes cold (no stalled kill barrier to promote at)
            self.shadow_ckpt = None
            self._handle_failure(failure)
            raise RollbackSignal(self.view.epoch)
        state = self.state
        if self._data_parallel():
            buddy = buddy_exchange(state, self.mesh, self.rules)
        else:
            buddy = _clone(state)       # the buddy copy is on this device
        local = _clone(state)
        self.file_ckpt.save(step, state, async_=self.policy.async_file)
        failure = self._injected_at("worker.ckpt.pre_push", step)
        if failure is not None:
            # the file committed but the buddy copy was never pushed — the
            # memory tier stays at step-1 and the merged restore takes the
            # newer file
            self.shadow_ckpt = None
            self._handle_failure(failure)
            raise RollbackSignal(self.view.epoch)
        self.mem_ckpt = (step, local, buddy)

    # ----------------------------------------------------------- recovery

    def _handle_failure(self, failure: FailureEvent,
                        cascade: bool = False) -> RecoveryReport:
        rep = RecoveryReport(strategy=self.strategy.name, failure=failure)
        # cascades merge into the recovery in flight via respawn, never
        # shrink on their own (a second failure during recovery must not
        # drop a rank survivors are blocked waiting on) — same policy as
        # the sim and the real root's open-join-window classification
        if self.elastic is not None and not cascade \
                and self.elastic.decide(failure) == "shrink":
            return self._handle_failure_shrink(rep, failure)

        # --- detection (child monitor / channel break at the root)
        t0 = time.monotonic()
        cmd = root_handle_failure(self.view, failure)
        states = apply_recovery(self.view, cmd)
        if len(states) != self.n_ranks:         # non-shrinking invariant
            raise RuntimeError(f"recovery changed the world: {len(states)} "
                               f"ranks, expected {self.n_ranks}")
        if self.elastic is not None:
            self.elastic.nonshrink_plan(failure)     # mesh bookkeeping
        rep.detect_s = time.monotonic() - t0

        # --- zero-rollback fast path (replica): promote the warm shadow.
        # A node loss does not invalidate it (shadows live off-node); a
        # cold shadow falls through to the ordinary path below.
        if self.strategy.replicates and self.shadow_ckpt is not None:
            t0 = time.monotonic()
            step, shadow = self.shadow_ckpt
            self.shadow_ckpt = None   # consumed: a cascade during this
                                      # recovery has no second standby
            if failure.kind is FailureType.NODE:
                self.mem_ckpt = None  # buddy copies died with the node
            rep.mpi_recovery_s = time.monotonic() - t0
            t0 = time.monotonic()
            self.state = _clone(shadow)
            self._sync()
            rep.ckpt_read_s = time.monotonic() - t0
            rep.rollback_step = step
            self.reports.append(rep)
            self._fire_cascades()
            return rep

        # --- MPI recovery: what each strategy actually does
        t0 = time.monotonic()
        ckpt_kind = self.strategy.checkpoint_kind(failure.kind)
        if self.strategy.redeploys:
            # CR: teardown — lose device state AND the step function
            self.state = None
            self.mem_ckpt = None
            self._build_step()          # drop the step function, rebuild
        else:
            if self.strategy.allrank_collectives:
                # ULFM: revoke/shrink/agree rounds across all ranks
                x = torch.ones(self.n_ranks, dtype=torch.float32,
                               device=self.device)
                for _ in range(self.strategy.allrank_collectives):
                    x = x / x.sum()
                self._sync()
            if failure.kind is FailureType.NODE:
                # node loss invalidates buddy copies of that node's shards
                self.mem_ckpt = None
        rep.mpi_recovery_s = time.monotonic() - t0

        # --- application recovery: reload the appropriate checkpoint.
        # The memory tier is only taken when it is at least as new as the
        # file tier (a worker.ckpt.pre_push failure leaves the file ahead)
        t0 = time.monotonic()
        use_memory = ckpt_kind == "memory" and self.mem_ckpt is not None
        if use_memory:
            self.file_ckpt.wait()
            fsteps = self.file_ckpt.steps()
            if fsteps and fsteps[-1] > self.mem_ckpt[0]:
                use_memory = False
        if use_memory:
            step, local, buddy = self.mem_ckpt
            restored = restore_from_buddy(buddy, self.mesh, self.rules) \
                if self._data_parallel() else buddy
            # survivors keep `local`; the failed shard comes from
            # `restored` (the same global value: the tests hold the
            # digests equal)
            self.state = _clone(restored)
            rollback_step = step
        else:
            rollback_step, self.state = self._restore_file()
        self._sync()
        rep.ckpt_read_s = time.monotonic() - t0
        rep.rollback_step = rollback_step
        self.reports.append(rep)
        self._fire_cascades()
        return rep

    def _fire_cascades(self):
        """Cascade injection points (a second failure during the recovery
        just performed). Each fires at most once per scenario; the nested
        recovery re-restores the same state, so continuation stays
        bit-identical."""
        for point in ("worker.recovery.enter", "worker.recovery.pulled",
                      "worker.recovery.compose"):
            cascade = self._injected_at(point)
            if cascade is not None:
                self._handle_failure(cascade, cascade=True)
                return

    def _restore_file(self):
        """(rollback step, state) from the newest file checkpoint, or
        (0, a fresh state) when there is none."""
        self.file_ckpt.wait()
        step, state = self.file_ckpt.load_latest()
        if step is None:
            return 0, self.init_state()
        return step, self._load_state(state)

    def _handle_failure_shrink(self, rep: RecoveryReport,
                               failure: FailureEvent) -> RecoveryReport:
        """Elastic shrinking recovery: the spare pool is exhausted, so the
        data axis contracts instead of re-hosting — by a whole node group
        on a node loss, or by a single rank on a process loss (uneven
        groups). Survivors keep their device state; the mesh epoch bump
        rebuilds the step function, and the step-indexed TokenPipeline
        keeps the *global* batch, so the run stays on the same data
        trajectory through the shrink."""
        t0 = time.monotonic()
        cmd = self.elastic.shrink(failure)   # view+mesh+dropped ledger
        self.n_ranks = len(cmd.world)
        rep.detect_s = time.monotonic() - t0

        t0 = time.monotonic()
        self._build_step()           # mesh epoch bumped: rebuild the step
        if failure.kind is FailureType.NODE:
            self.mem_ckpt = None     # the lost node took its buddy-held
                                     # copies with it
        rep.mpi_recovery_s = time.monotonic() - t0

        # survivors roll back to their newest durable state: the memory
        # copy when it survived (process shrink), else the file
        # checkpoint at the cut
        t0 = time.monotonic()
        if self.mem_ckpt is not None:
            step, local, _ = self.mem_ckpt
            self.state = _clone(local)
            rollback_step = step
        else:
            rollback_step, self.state = self._restore_file()
        self._sync()
        rep.ckpt_read_s = time.monotonic() - t0
        rep.rollback_step = rollback_step
        rep.world_after = self.n_ranks
        self.reports.append(rep)
        self._fire_cascades()
        return rep

    def _observe_gray(self, step: int):
        """Per-rank gray-failure observation. One device has one clock,
        so what the tracker sees is modelled barrier LATENESS relative to
        the fastest member — healthy ranks observe 0.0, victims observe
        the injected deceleration delay — never the measured step time
        (immune to globally slow steps, such as the restore after a
        recovery). With mitigate=on (and the elastic strategy, the only
        one that can re-host), a rank on a GRAY_DRAIN_PERSIST streak is
        drained: returns the FailureEvent that re-hosts it through the
        ordinary shrink path, and marks the fault cured — the drained
        rank's next incarnation (the grow-back) is healthy. Tolerate mode
        only records the flags."""
        if not self._gray:
            return None
        live = set(self.view.ranks())
        rpn = self.tc.ranks_per_node
        delays: dict[int, float] = {}
        for i, f in self._gray:
            # `step` is the post-increment count; the fault starts
            # degrading the iteration whose top is f.step
            if i in self._gray_mitigated or step <= f.step:
                continue
            if f.target == "node":
                node = f.rank // rpn
                victims = range(node * rpn, (node + 1) * rpn)
            else:
                victims = (f.rank,)
            for r in victims:
                delays[r] = delays.get(r, 0.0) + gray_delay_s(f)
        for r in sorted(live):
            self.straggler.observe(step, delays.get(r, 0.0), rank=r)
        if not (self.tc.mitigate and self.elastic is not None):
            return None
        flagged = self.straggler.stragglers(GRAY_DRAIN_PERSIST) & live
        if not flagged:
            return None
        self.straggler.reset_streaks()
        for i, f in self._gray:
            if i in self._gray_mitigated:
                continue
            if f.target == "node":
                node = f.rank // rpn
                group = set(range(node * rpn, (node + 1) * rpn)) & live
                if group and group <= flagged:
                    self._gray_mitigated.add(i)
                    return FailureEvent(kind=FailureType.NODE,
                                        node=f"node{node}", rank=f.rank,
                                        at_step=step)
            elif f.rank in flagged:
                self._gray_mitigated.add(i)
                return FailureEvent(kind=FailureType.PROCESS,
                                    rank=f.rank, at_step=step)
        return None

    def _handle_repair(self, repair) -> Optional[RecoveryReport]:
        """Grow-back: a repaired node rejoins at a checkpoint boundary.
        The admission policy (the membership machine) re-admits the most
        recently dropped group — world re-expands, mesh epoch bumps, the
        step function is rebuilt — or, with a full world, adds the node
        to the spare pool (no recovery, returns None)."""
        if self.elastic is None:
            return None              # non-elastic runs never shrank
        node = f"node{repair.rank // self.tc.ranks_per_node}"
        if node in self.view.children:
            return None              # node never left the world: no-op
        if self.elastic.admit(node) == "spare":
            self.elastic.grant_spare(node)
            return None
        rep = RecoveryReport(
            strategy=self.strategy.name,
            failure=FailureEvent(kind=FailureType.NODE, node=node,
                                 at_step=repair.step))
        t0 = time.monotonic()
        cmd = self.elastic.grow(node)
        self.n_ranks = len(cmd.world)
        rep.detect_s = time.monotonic() - t0

        t0 = time.monotonic()
        self._build_step()           # mesh epoch bumped: rebuild the step
        rep.mpi_recovery_s = time.monotonic() - t0

        # the re-admitted ranks restore from the durable checkpoint at
        # the consistent cut (Table-2 "grow" scheme: file tier)
        t0 = time.monotonic()
        self.file_ckpt.wait()
        step, state = self.file_ckpt.load_latest()
        if step is not None:
            self.state = self._load_state(state)
            rep.rollback_step = step
        self._sync()
        rep.ckpt_read_s = time.monotonic() - t0
        rep.world_after = self.n_ranks
        self.reports.append(rep)
        self._fire_cascades()
        return rep

    # ---------------------------------------------------------------- run

    def _resilient_body(self, rank_state: RankState) -> int:
        """The user-supplied restart-point function of MPI_Reinit."""
        tc = self.tc
        if rank_state is RankState.NEW and self.state is None:
            # fresh start — or resume from disk if a checkpoint exists
            step, state = self.file_ckpt.load_latest()
            self.state = self.init_state() if step is None \
                else self._load_state(state)
        if self.state is None:
            raise RuntimeError("no training state after recovery")
        hb = self.strategy.fault_free_overhead(self.n_ranks)

        step = int(gather(self.state["step"]))
        while step < tc.total_steps:
            ROLLBACK.check()                      # safe-point (paper §3.2)
            failure = self.injector.check(step, self.view) \
                if self.injector else None
            if failure is not None:
                self._handle_failure(failure)
                raise RollbackSignal(self.view.epoch)
            repair = self.injector.check_repair(step) \
                if self.injector is not None \
                and hasattr(self.injector, "check_repair") else None
            if repair is not None and self._handle_repair(repair):
                raise RollbackSignal(self.view.epoch)

            t0 = time.monotonic()
            batch = self.data.batch(step)
            self.state, (loss, _) = self._step(self.state, batch)
            self._sync()
            dt = time.monotonic() - t0
            step = int(gather(self.state["step"]))
            loss = gather(loss)
            self.straggler.observe(step, dt)
            drain = self._observe_gray(step)
            if drain is not None:
                # drain BEFORE this step's checkpoint commits: the last
                # durable cut is the completed boundary — the same place
                # the real root withholds the barrier release
                self._handle_failure(drain)
                raise RollbackSignal(self.view.epoch)
            if self.strategy.replicates:
                # replication stream: mirror every step's state to the
                # rank's off-node shadow — what makes the promote
                # zero-rollback
                self.shadow_ckpt = (step, _clone(self.state))
            self.logs.append(StepLog(step=step, loss=float(loss),
                                     seconds=dt, heartbeat_overhead=hb))
            if self.policy.should_checkpoint(step):
                self._save_ckpt(step)
            if tc.log_every and step % tc.log_every == 0:
                print(f"[{self.strategy.name}] step {step} "
                      f"loss {float(loss):.4f} ({dt*1e3:.1f} ms)")
        self.file_ckpt.wait()
        return step

    def run(self) -> dict:
        final_step = reinit_main(self._resilient_body)
        return {
            "final_step": final_step,
            "losses": [l.loss for l in self.logs],
            "reports": self.reports,
            "stragglers": self.straggler.flagged,
            "stragglers_by_rank": dict(self.straggler.flagged_by_rank),
        }
