"""PyTorch port of distkeras_tpu for NVIDIA Hopper (H100).

This package exports what the port has so far: training through
``SingleTrainer``, batch inference and evaluation of the BERT/GPT family,
with flash attention forward and backward (CUDA C++) and the fused softmax
cross-entropy forward and backward (Triton) as hand-written kernels. ``distkeras_tpu`` is the reference it is held against; this package
never imports it, nor JAX.
"""

from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.inference.evaluators import AccuracyEvaluator
from distkeras_tpu_torch.inference.predictors import ModelPredictor
from distkeras_tpu_torch.models.bert import (
    BertConfig,
    bert_base_mlm,
    bert_tiny_mlm,
    gpt_small,
    gpt_tiny,
)
from distkeras_tpu_torch.models.core import Model, TrainedModel
from distkeras_tpu_torch.training.trainers import SingleTrainer, Trainer
from distkeras_tpu_torch.utils.bridge import load_weights_file, params_from_jax
from distkeras_tpu_torch.utils.device import resolve_device

__all__ = [
    "AccuracyEvaluator",
    "BertConfig",
    "Dataset",
    "Model",
    "ModelPredictor",
    "SingleTrainer",
    "TrainedModel",
    "Trainer",
    "bert_base_mlm",
    "bert_tiny_mlm",
    "gpt_small",
    "gpt_tiny",
    "load_weights_file",
    "params_from_jax",
    "resolve_device",
]
