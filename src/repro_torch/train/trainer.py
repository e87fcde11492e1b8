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

Because the data pipeline is step-indexed and checkpoints are taken every
policy-interval, a failed-and-recovered run converges to the bit-identical
state of an uninterrupted run. On the card that needs deterministic
kernels: the entry points call `repro_torch.device.set_deterministic()`.

Not ported yet (ROADMAP queue A): the elastic `shrink` strategy and gray
(slow/lossy) faults.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import FileCheckpointer
from repro_torch.checkpoint.policy import CheckpointPolicy
from repro_torch.core import (ClusterView, FailureEvent, FailureType,
                              FaultInjector, RankState, RecoveryReport,
                              ROLLBACK, RollbackSignal, apply_recovery,
                              get_strategy, reinit_main, root_handle_failure)
from repro_torch.device import resolve
from repro_torch.models.model import Model
from repro_torch.scenarios.schema import GRAY_HOWS
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

from .data import TokenPipeline
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .straggler import StragglerTracker

_NOT_PORTED = ("is not ported to repro_torch yet (ROADMAP queue A: "
               "trainer shrink and gray paths)")


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


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A loaded checkpoint leaf (numpy view of a mapped frame, or a CPU
    tensor) -> a tensor of its own on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    return torch.from_numpy(np.array(a)).to(device)


class Trainer:
    def __init__(self, model: Model, data: TokenPipeline,
                 opt_cfg: AdamWConfig, tc: TrainConfig, *,
                 injector: Optional[FaultInjector] = None):
        self.model = model
        self.data = data
        self.opt_cfg = opt_cfg
        self.tc = tc
        self.device = resolve(tc.device)
        self.strategy = get_strategy(tc.strategy)
        if self.strategy.key == "shrink":
            raise NotImplementedError(f"strategy 'shrink' {_NOT_PORTED}")
        sc = getattr(injector, "scenario", None)
        if sc is not None and any(f.how in GRAY_HOWS for f in sc.faults):
            raise NotImplementedError(f"gray faults {_NOT_PORTED}")
        self.injector = injector
        self.view = ClusterView.build(tc.n_nodes, tc.ranks_per_node,
                                      tc.spare_nodes)
        self.n_ranks = tc.n_nodes * tc.ranks_per_node
        self.policy = CheckpointPolicy(every_steps=tc.ckpt_every,
                                       async_file=tc.async_file_ckpt)
        self.file_ckpt = FileCheckpointer(
            tc.ckpt_dir, n_shards=tc.ckpt_shards,
            delta_every=tc.ckpt_delta_every, gather=tc.ckpt_gather,
            rebase_after=tc.ckpt_rebase_after)
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
        self._build_step()

    # ----------------------------------------------------------- stepping

    def _build_step(self):
        model, opt_cfg = self.model, self.opt_cfg

        def train_step(state, batch):
            params = tree_map(lambda p: p.detach().requires_grad_(),
                              state["params"])
            loss, metrics = model.loss_fn(params, batch)
            grads = torch.autograd.grad(loss, tree_leaves(params))
            with torch.no_grad():
                new_p, new_opt, om = adamw_update(
                    state["params"], tree_unflatten(params, list(grads)),
                    state["opt"], opt_cfg)
            new_state = {"params": new_p, "opt": new_opt,
                         "step": state["step"] + 1}
            return new_state, (loss.detach(), {**metrics, **om})

        self._step = train_step

    # -------------------------------------------------------------- state

    def init_state(self) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        params = self.model.init(gen)
        return {"params": params, "opt": adamw_init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=self.device)}

    def _load_state(self, state) -> dict:
        return tree_map(lambda a: _to_device(a, self.device), state)

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
        buddy = _clone(state)           # one device: the buddy is a copy
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

    def _handle_failure(self, failure: FailureEvent) -> RecoveryReport:
        rep = RecoveryReport(strategy=self.strategy.name, failure=failure)

        # --- detection (child monitor / channel break at the root)
        t0 = time.monotonic()
        cmd = root_handle_failure(self.view, failure)
        states = apply_recovery(self.view, cmd)
        if len(states) != self.n_ranks:         # non-shrinking invariant
            raise RuntimeError(f"recovery changed the world: {len(states)} "
                               f"ranks, expected {self.n_ranks}")
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
            # survivors keep `local`; the failed shard comes from the buddy
            # (same global value at world 1)
            self.state = _clone(buddy)
            rollback_step = step
        else:
            self.file_ckpt.wait()
            step, state = self.file_ckpt.load_latest()
            if step is None:
                self.state = self.init_state()
                rollback_step = 0
            else:
                self.state = self._load_state(state)
                rollback_step = step
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
                self._handle_failure(cascade)
                return

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

        step = int(self.state["step"])
        while step < tc.total_steps:
            ROLLBACK.check()                      # safe-point (paper §3.2)
            failure = self.injector.check(step, self.view) \
                if self.injector else None
            if failure is not None:
                self._handle_failure(failure)
                raise RollbackSignal(self.view.epoch)

            t0 = time.monotonic()
            batch = self.data.batch(step)
            self.state, (loss, _) = self._step(self.state, batch)
            self._sync()
            dt = time.monotonic() - t0
            step = int(self.state["step"])
            self.straggler.observe(step, dt)
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
