from .rules import ShardingRules, PRESETS, spec_for_path, tree_specs
from .partition import (
    shard_constraint, constraint_scope, tree_shardings, state_shardings,
    batch_spec,
)
