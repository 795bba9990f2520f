"""See the package docstring. The mesh builders, the batch padding and
bucketing helpers, the placement helpers of ``dist`` and the pipeline
runner are exported here, as the JAX package's ``parallel`` exports
them. The attention functions stay in their modules: exporting
``ring_attention`` here would shadow the module of that name (JAX's
package has that shadow)."""

from mmlspark_tpu_torch.parallel.dist import (
    Shards,
    batch_shardings,
    gathered,
    placement_label,
    placement_report,
    process_local_rows,
    put_batch,
    shard_state,
    spec_for_leaf,
    state_shardings,
    state_specs,
    train_mesh,
    tree_bytes,
)
from mmlspark_tpu_torch.parallel.pipeline import (
    PipelineRunner,
    StagePlan,
    bubble_ratio,
    plan_stages,
    split_rows,
)
from mmlspark_tpu_torch.parallel.sharding import (
    bucket_ladder,
    bucket_target,
    pad_to_bucket,
    pad_to_multiple,
    padded_device_batch,
    round_to_multiple,
    shard_batch,
    unpad,
)
from mmlspark_tpu_torch.parallel.topology import (
    MeshSpec,
    build_mesh,
    distributed_init,
    in_single_device_scope,
    single_device_scope,
)

__all__ = [
    "MeshSpec",
    "PipelineRunner",
    "Shards",
    "StagePlan",
    "batch_shardings",
    "bubble_ratio",
    "bucket_ladder",
    "bucket_target",
    "build_mesh",
    "distributed_init",
    "gathered",
    "in_single_device_scope",
    "pad_to_bucket",
    "pad_to_multiple",
    "padded_device_batch",
    "placement_label",
    "placement_report",
    "plan_stages",
    "process_local_rows",
    "put_batch",
    "round_to_multiple",
    "shard_batch",
    "shard_state",
    "single_device_scope",
    "spec_for_leaf",
    "split_rows",
    "state_shardings",
    "state_specs",
    "train_mesh",
    "tree_bytes",
    "unpad",
]
