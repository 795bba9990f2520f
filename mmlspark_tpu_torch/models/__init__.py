"""The port's models: the frame plane's networks (:class:`NNFunction`,
the ResNet builders, :class:`NNModel`, the zoo, :class:`NNLearner`,
:class:`ImageFeaturizer`) and the transformer LM, dense or a mixture
of experts, with its int8 decode FFN and its train-state checkpoints in
:mod:`~mmlspark_tpu_torch.models.transformer` (``mmlspark_tpu/models``'s
public names)."""
from mmlspark_tpu_torch.models.function import NNFunction, LayeredModel
from mmlspark_tpu_torch.models.nn import NNModel
from mmlspark_tpu_torch.models.trainer import NNLearner
from mmlspark_tpu_torch.models.featurizer import ImageFeaturizer
from mmlspark_tpu_torch.models.resnet import (
    ResNet, ConvNet, cifar_resnet, cifar_convnet,
)
from mmlspark_tpu_torch.models.zoo import (
    ModelDownloader, ModelRepo, ModelSchema,
)
from mmlspark_tpu_torch.models.transformer import (
    TransformerConfig,
    build_spmd_train_step,
    init_params_np as init_transformer_params,
    shard_params as shard_transformer_params,
    reference_logits,
    restore_train_state,
    save_train_state,
)

__all__ = ["NNFunction", "LayeredModel", "NNModel", "NNLearner",
           "ImageFeaturizer", "ResNet",
           "ConvNet", "cifar_resnet", "cifar_convnet",
           "ModelDownloader", "ModelRepo", "ModelSchema",
           "TransformerConfig", "build_spmd_train_step",
           "init_transformer_params", "shard_transformer_params",
           "reference_logits", "restore_train_state", "save_train_state"]
