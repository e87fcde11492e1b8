from . import serde
from .manifest import (Manifest, flatten_leaves, flatten_state, tree_digest,
                       unflatten_state)
from .file_ckpt import FileCheckpointer
from .policy import CheckpointPolicy, checkpoint_kind_for
