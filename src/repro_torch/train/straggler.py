"""Straggler detection over step times — robust stats + per-rank streaks.

The paper's recovery model assumes fail-stop failures; production fleets
also see *gray* ones: slow nodes, lossy links — ranks that keep
answering but keep everyone waiting. The tracker keeps a robust running
estimate (median + MAD over a window of every observation) and flags
observations that exceed it; with `rank=` given, flags and
consecutive-flag streaks are attributed to that rank, and
`stragglers()`/`persistent()` answer the question mitigation acts on:
which ranks have been slow *persistently*, not just once. The root's
drain path and the trainer's ElasticManager re-host a persistent
straggler exactly like a failed rank — a deliberate reuse of the
Reinit++ shrink/grow machinery.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Callable, Deque, Optional


@dataclasses.dataclass
class StragglerTracker:
    """Robust straggler detector with optional per-rank attribution.

    Population model: every observation — whatever its rank — lands in
    one shared window, and the flagging baseline is the *population's*
    median + MAD. That is what keeps attribution honest: a persistently
    slow rank never normalises its own baseline (judged only against
    its own history it would stop looking slow after one window), and a
    healthy rank is never blamed for the population-wide noise floor.

    Usage:
      observe(step, seconds)          aggregate outlier detection (the
                                      trainer watching its own step dt)
      observe(step, seconds, rank=r)  per-rank attribution: the flag and
                                      the consecutive-flag streak are
                                      recorded against r (the root
                                      watching per-rank barrier lateness)

    Flag rule — all three must hold, and never before `min_samples`
    observations exist:
      seconds > median + threshold_mads * MAD   robust outlier
      seconds > 1.5 * median                    relative floor: a
                                                flat-line window's
                                                near-zero MAD must not
                                                flag noise
      seconds >= min_flag_s                     absolute floor: sub-
                                                resolution jitter is
                                                never a straggler

    `persistent(rank, persist)` / `stragglers(persist)` report ranks
    flagged on `persist` *consecutive* observations — one slow step is
    noise, a streak is a gray failure. `reset_streaks()` belongs at
    recovery boundaries: a re-formed world starts with a clean slate.
    """
    window: int = 50
    threshold_mads: float = 6.0
    min_samples: int = 10
    min_flag_s: float = 0.0
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def __post_init__(self):
        self._times: Deque[float] = collections.deque(maxlen=self.window)
        self.flagged: list[tuple[int, float]] = []
        self.flagged_by_rank: dict[int, list[tuple[int, float]]] = {}
        self._streak: dict[int, int] = {}

    def observe(self, step: int, seconds: float,
                rank: Optional[int] = None) -> bool:
        """Record one observation; returns True when it flags."""
        flagged = False
        if len(self._times) >= self.min_samples:
            med = statistics.median(self._times)
            mad = statistics.median(
                abs(t - med) for t in self._times) or 1e-9
            if (seconds > med + self.threshold_mads * mad
                    and seconds > 1.5 * med
                    and seconds >= self.min_flag_s):
                flagged = True
                self.flagged.append((step, seconds))
                if rank is not None:
                    self.flagged_by_rank.setdefault(rank, []).append(
                        (step, seconds))
                if self.on_straggler:
                    self.on_straggler(step, seconds, med)
        if rank is not None:
            self._streak[rank] = \
                (self._streak.get(rank, 0) + 1) if flagged else 0
        self._times.append(seconds)
        return flagged

    def persistent(self, rank: int, persist: int = 2) -> bool:
        """Has `rank` flagged on its last `persist` observations?"""
        return self._streak.get(rank, 0) >= persist

    def stragglers(self, persist: int = 2) -> set:
        """Every rank currently on a flag streak of at least `persist`."""
        return {r for r, n in self._streak.items() if n >= persist}

    def reset_streaks(self):
        """Recovery boundary: the world re-formed (drain, shrink, grow)
        and in-flight streaks describe incarnations that no longer
        exist."""
        self._streak.clear()

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0
