"""Checkpoint cadence + Table-2 scheme selection (failure × strategy).

                 CR      ULFM     Reinit++
    process      file    memory   memory
    node         file    file     file

CR always re-deploys, so only permanent storage survives; memory (buddy)
checkpoints are valid only for single process failures — a node failure can
wipe both the local and the buddy copy, hence file.
"""
from __future__ import annotations

import dataclasses

TABLE2 = {
    ("process", "cr"): "file",
    ("process", "ulfm"): "memory",
    ("process", "reinit"): "memory",
    ("node", "cr"): "file",
    ("node", "ulfm"): "file",
    ("node", "reinit"): "file",
    # elastic shrinking recovery: like Reinit++ while spares absorb the
    # loss (a node loss takes the buddy copies with it -> file). Once the
    # pool is exhausted the recovery *shrinks* instead of respawning and
    # survivors restore from their own local memory — that branch is
    # modeled explicitly by the executors, not through this table.
    ("process", "shrink"): "memory",
    ("node", "shrink"): "file",
    # replica failover: the warm shadow *is* the memory tier, and it is
    # admitted off-node by construction, so even a node loss leaves it
    # intact — the promoted shadow composes its streamed frames without
    # ever touching the file tier. (When no warm shadow exists the root
    # falls back to Reinit++, which uses that row of this table.)
    ("process", "replica"): "memory",
    ("node", "replica"): "memory",
}


#: restore scheme of a grow-back (elastic re-admission): the rejoining
#: ranks were *out of the world* — nobody held buddy copies for them, so
#: their last durable state is the file tier (the checkpoints they
#: committed before being dropped, which survivors keep pinned as the
#: grow anchor). Survivors roll back from their own local copies.
GROW_RESTORE_KIND = "file"


def checkpoint_kind_for(failure: str, strategy: str) -> str:
    if failure == "grow":
        return GROW_RESTORE_KIND
    return TABLE2[(failure, strategy)]


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """Every-N-steps cadence; the paper checkpoints after every iteration."""
    every_steps: int = 1
    async_file: bool = True
    keep: int = 3

    def should_checkpoint(self, step: int) -> bool:
        return step % self.every_steps == 0
