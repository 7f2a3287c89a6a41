"""PyTorch port of distkeras_tpu for NVIDIA Hopper (H100).

This package exports what the port has so far: training through
``SingleTrainer`` and the asynchronous parameter-server trainers (DOWNPOUR,
ADAG, AEASGD, EAMSGD, DynSGD), batch inference and evaluation, the BERT/GPT
family and the MLP/CNN models, and the data transformers, with flash
attention forward and backward (CUDA C++) and the fused softmax
cross-entropy forward and backward (Triton) as hand-written kernels.
``distkeras_tpu`` is the reference it is held against; this package never
imports it, nor JAX.
"""

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
from distkeras_tpu_torch.training.trainers import (
    ADAG,
    AEASGD,
    DOWNPOUR,
    EAMSGD,
    AsynchronousDistributedTrainer,
    DynSGD,
    SingleTrainer,
    Trainer,
)
from distkeras_tpu_torch.utils.bridge import load_weights_file, params_from_jax
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = [
    "ADAG",
    "AEASGD",
    "AccuracyEvaluator",
    "AsynchronousDistributedTrainer",
    "BertConfig",
    "DOWNPOUR",
    "Dataset",
    "DenseTransformer",
    "DynSGD",
    "EAMSGD",
    "LabelIndexTransformer",
    "MinMaxTransformer",
    "Model",
    "ModelPredictor",
    "OneHotTransformer",
    "ReshapeTransformer",
    "SingleTrainer",
    "StandardScaleTransformer",
    "TrainedModel",
    "Trainer",
    "Transformer",
    "TransformerPipeline",
    "bert_base_mlm",
    "bert_tiny_mlm",
    "cifar10_cnn",
    "gpt_small",
    "gpt_tiny",
    "higgs_mlp",
    "load_weights_file",
    "mnist_cnn",
    "mnist_mlp",
    "params_from_jax",
    "resolve_device",
]
