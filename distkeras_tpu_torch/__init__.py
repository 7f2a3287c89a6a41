"""PyTorch port of distkeras_tpu for NVIDIA Hopper (H100).

This package exports what the port has so far: training through
``SingleTrainer``, ``EnsembleTrainer``, ``AveragingTrainer``,
``SynchronousDistributedTrainer`` and the asynchronous parameter-server
trainers (DOWNPOUR, ADAG, AEASGD, EAMSGD, DynSGD), with step checkpoints
and resume; ``TrainerConfig``; stamped weight files that either package
reads, and publish directories; batch inference and evaluation; the
BERT/GPT family, ResNet-18/50 and the MLP/CNN models; and the data
transformers, with flash
attention forward and backward (CUDA C++) and the fused softmax
cross-entropy forward and backward (Triton) as hand-written kernels.
``distkeras_tpu`` is the reference it is held against; this package never
imports it, nor JAX.
"""

from distkeras_tpu_torch.checkpoint import (
    CheckpointManager,
    load_weights_file,
    load_weights_file_with_provenance,
    load_weights_meta,
    publish_weights,
    read_manifest,
    save_weights_file,
    weights_digest,
    weights_provenance,
)
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer,
    LabelIndexTransformer,
    MinMaxTransformer,
    OneHotTransformer,
    ReshapeTransformer,
    StandardScaleTransformer,
    Transformer,
    TransformerPipeline,
)
from distkeras_tpu_torch.inference.evaluators import AccuracyEvaluator
from distkeras_tpu_torch.inference.predictors import ModelPredictor
from distkeras_tpu_torch.models.bert import (
    BertConfig,
    bert_base_mlm,
    bert_tiny_mlm,
    gpt_small,
    gpt_tiny,
)
from distkeras_tpu_torch.models.cnn import cifar10_cnn, mnist_cnn
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.models.mlp import higgs_mlp, mnist_mlp
from distkeras_tpu_torch.models.resnet import ResNet, resnet18, resnet50
from distkeras_tpu_torch.training.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AsynchronousDistributedTrainer,
    AveragingTrainer,
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
    SynchronousDistributedTrainer,
    Trainer,
)
from distkeras_tpu_torch.utils.bridge import params_from_jax, params_to_jax
from distkeras_tpu_torch.utils.config import TrainerConfig
from distkeras_tpu_torch.utils.device import resolve_device
from distkeras_tpu_torch.utils.pytree import deserialize_pytree, serialize_pytree

__all__ = [
    "ADAG",
    "AEASGD",
    "AccuracyEvaluator",
    "AsynchronousDistributedTrainer",
    "AveragingTrainer",
    "BertConfig",
    "CheckpointManager",
    "DOWNPOUR",
    "Dataset",
    "DenseTransformer",
    "DynSGD",
    "EAMSGD",
    "EnsembleTrainer",
    "LabelIndexTransformer",
    "MinMaxTransformer",
    "Model",
    "ModelPredictor",
    "OneHotTransformer",
    "ReshapeTransformer",
    "ResNet",
    "SingleTrainer",
    "StandardScaleTransformer",
    "SynchronousDistributedTrainer",
    "TrainedModel",
    "Trainer",
    "TrainerConfig",
    "Transformer",
    "TransformerPipeline",
    "bert_base_mlm",
    "bert_tiny_mlm",
    "cifar10_cnn",
    "deserialize_pytree",
    "gpt_small",
    "gpt_tiny",
    "higgs_mlp",
    "load_weights_file",
    "load_weights_file_with_provenance",
    "load_weights_meta",
    "mnist_cnn",
    "mnist_mlp",
    "params_from_jax",
    "params_to_jax",
    "publish_weights",
    "read_manifest",
    "resnet18",
    "resnet50",
    "resolve_device",
    "save_weights_file",
    "serialize_pytree",
    "weights_digest",
    "weights_provenance",
]
