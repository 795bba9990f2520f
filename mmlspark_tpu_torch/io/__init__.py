"""Storage and IO of the port: ``fs`` (local paths and fsspec URLs),
``checkpoint`` (the sharded train-state store and the integrity
manifests of directory checkpoints), ``binary`` (whole-file reads, by
the native C++ reader or in Python), ``images`` (image reading and the
PIL codec), ``streaming`` (the file stream source and
``foreach_batch``), ``http`` (the client and the HTTP column stages)
and ``services`` (the Cognitive Services clients and batch writers)."""
from mmlspark_tpu_torch.io.binary import read_binary_files
from mmlspark_tpu_torch.io.checkpoint import (
    ShardedCheckpointManager, restore_sharded, save_sharded,
)
from mmlspark_tpu_torch.io.images import (
    read_images, decode_image, encode_image,
)
from mmlspark_tpu_torch.io.streaming import FileStreamSource
from mmlspark_tpu_torch.io.http import (
    HTTPRequestData, HTTPResponseData, HTTPClient, HTTPTransformer,
    SimpleHTTPTransformer, JSONInputParser, JSONOutputParser,
    StringOutputParser, CustomInputParser, CustomOutputParser,
    basic_handler, advanced_handler,
)

__all__ = [
    "FileStreamSource", "ShardedCheckpointManager",
    "read_binary_files", "read_images", "decode_image", "encode_image",
    "restore_sharded", "save_sharded",
    "HTTPRequestData", "HTTPResponseData", "HTTPClient", "HTTPTransformer",
    "SimpleHTTPTransformer", "JSONInputParser", "JSONOutputParser",
    "StringOutputParser", "CustomInputParser", "CustomOutputParser",
    "basic_handler", "advanced_handler",
]
