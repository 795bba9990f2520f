"""Pipeline stages: frame utilities, data prep, batching, image ops
(``mmlspark_tpu/stages``'s names).

``basic``, ``prep`` and ``batching`` run on the host (numpy); the image
stages run their op chains on the stage's device."""

from mmlspark_tpu_torch.stages.basic import (
    DropColumns, SelectColumns, RenameColumn, Repartition, Cacher,
    CheckpointData, Explode, Lambda, ScaleColumn, UDFTransformer,
    TextPreprocessor,
    UnicodeNormalize, ClassBalancer, ClassBalancerModel, PartitionSample,
    MultiColumnAdapter, EnsembleByKey, SummarizeData, Timer, TimerModel,
)
from mmlspark_tpu_torch.stages.prep import (
    ValueIndexer, ValueIndexerModel, IndexToValue,
    CleanMissingData, CleanMissingDataModel, DataConversion,
)
from mmlspark_tpu_torch.stages.batching import (
    BucketBatcher, FixedBatcher, DynamicBufferedBatcher, TimeIntervalBatcher,
    FixedMiniBatchTransformer, DynamicMiniBatchTransformer, FlattenBatch,
)
from mmlspark_tpu_torch.stages.image import (
    ImageTransformer, ResizeImageTransformer, UnrollImage, UnrollBinaryImage,
    ImageSetAugmenter,
)

__all__ = [
    "DropColumns", "SelectColumns", "RenameColumn", "Repartition", "Cacher",
    "CheckpointData", "Explode", "Lambda", "ScaleColumn", "UDFTransformer",
    "TextPreprocessor", "UnicodeNormalize", "ClassBalancer",
    "ClassBalancerModel", "PartitionSample", "MultiColumnAdapter",
    "EnsembleByKey", "SummarizeData", "Timer", "TimerModel",
    "ValueIndexer", "ValueIndexerModel", "IndexToValue",
    "CleanMissingData", "CleanMissingDataModel", "DataConversion",
    "BucketBatcher", "FixedBatcher", "DynamicBufferedBatcher",
    "TimeIntervalBatcher",
    "FixedMiniBatchTransformer", "DynamicMiniBatchTransformer", "FlattenBatch",
    "ImageTransformer", "ResizeImageTransformer", "UnrollImage",
    "UnrollBinaryImage", "ImageSetAugmenter",
]
