"""Reinit++ — the paper's contribution as a composable library.

Layers:
  events     RankState / FailureEvent / ReinitCommand vocabulary
  protocol   Algorithms 1 & 2 (root HandleFailure, daemon HandleReinit)
  failure    detectors (child/channel monitors, ULFM heartbeat model,
             deterministic fault injection)
  reinit     reinit_main() rollback-point API (the MPI_Reinit analogue)
  elastic    spare pool, mesh epochs, shrinking-recovery option
  recovery   CR / Reinit++ / ULFM strategy objects
"""
from .events import (FailureEvent, FailureType, GrowCommand, PromoteCommand,
                     Promotion, RankState, RecoveryReport, ReinitCommand,
                     Respawn, ShrinkCommand)
from .protocol import (ClusterView, DaemonActions, apply_recovery,
                       daemon_handle_reinit, root_handle_failure,
                       root_handle_failure_promote,
                       root_handle_failure_shrink, root_handle_rejoin)
from .failure import (ChannelMonitor, ChildMonitor, FaultInjector,
                      HeartbeatModel, ScenarioInjector, kill_process)
from .reinit import (ROLLBACK, RollbackSignal, SIGREINIT, install_sigreinit,
                     reinit_main)
from .membership import MembershipMachine, RankMembership, Transition
from .elastic import ElasticManager, MeshEpoch
from .recovery import (CR, REINIT, REPLICA, SHRINK, STRATEGIES,
                       STRATEGY_ALIASES, ULFM, get_strategy)
