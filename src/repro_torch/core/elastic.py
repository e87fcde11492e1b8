"""Elastic mesh management: spare capacity, re-meshing, shrink + grow.

The paper's deployment requires over-provisioned slots to survive node
failures (§3.2 "Application Deployment"); `shrink`/`grow` go beyond the
paper (its deferred future work): when the pool is exhausted the data
axis contracts instead of re-spawning, and a repaired node's REJOIN
re-expands it back toward the initial world.

All the actual state lives in `repro_torch.core.membership.MembershipMachine`
— this module keeps the historical `ElasticManager` name plus the
mesh-only `nonshrink_plan` helper the global-restart recovery paths use
(they run Algorithm 1 themselves and only need the mesh bookkeeping).
Shrinks and grows go through the machine's audited transitions
(`shrink`/`grow`/`grant_spare`) exclusively.
"""
from __future__ import annotations

import dataclasses

from .events import FailureEvent, FailureType
from .membership import MembershipMachine, MeshEpoch, RankMembership, \
    Transition

__all__ = ["ElasticManager", "MeshEpoch", "RankMembership", "Transition"]


class ElasticManager(MembershipMachine):
    """The membership machine under its original name."""

    def nonshrink_plan(self, failure: FailureEvent) -> MeshEpoch:
        """Global-restart (paper): same mesh shape, failed shard re-hosted.
        Mesh epoch only bumps for node failures (device set changed)."""
        if failure.kind is FailureType.NODE:
            self.mesh = dataclasses.replace(self.mesh,
                                            epoch=self.mesh.epoch + 1)
        return self.mesh
