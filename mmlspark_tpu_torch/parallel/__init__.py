"""See the package docstring. The mesh builders and the placement
helpers are exported here, as the JAX package's ``parallel`` exports
them."""

from mmlspark_tpu_torch.parallel.dist import (
    placement_label,
    placement_report,
    process_local_rows,
    spec_for_leaf,
    state_specs,
    train_mesh,
    tree_bytes,
)
from mmlspark_tpu_torch.parallel.topology import (
    MeshSpec,
    build_mesh,
    distributed_init,
)

__all__ = [
    "MeshSpec",
    "build_mesh",
    "distributed_init",
    "placement_label",
    "placement_report",
    "process_local_rows",
    "spec_for_leaf",
    "state_specs",
    "train_mesh",
    "tree_bytes",
]
