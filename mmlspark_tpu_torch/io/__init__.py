"""Storage and IO of the port: ``fs`` (local paths and fsspec URLs),
``checkpoint`` (the sharded train-state store and the integrity
manifests of directory checkpoints), ``binary`` (whole-file reads) and
``streaming`` (the file stream source and ``foreach_batch``)."""
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.checkpoint import (
    ShardedCheckpointManager, restore_sharded, save_sharded,
)
from mmlspark_tpu_torch.io.streaming import FileStreamSource

__all__ = ["FileStreamSource", "ShardedCheckpointManager",
           "read_binary_files", "restore_sharded", "save_sharded"]
