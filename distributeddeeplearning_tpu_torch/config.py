"""Run configuration of the port: the subset of the JAX package's
``TrainConfig``/``DataConfig``/``OptimizerConfig``
(``distributeddeeplearning_tpu/config.py``) that one-card training of the
causal LMs and the ResNets reads, with the same field names and defaults.

One default differs: ``TrainConfig.model`` is ``gpt2_small`` (the JAX
default is a ResNet). The token data is synthetic ids over the model's own
vocabulary (GPT-2's 50257, Llama's 32000), the image data synthetic NHWC
images of ``image_size`` with ``num_classes`` labels. Runs are counted in
steps, not epochs, so the warmup is 5% of the steps, as the JAX schedule
gives it without an epoch length.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer + schedule (SGD-momentum default)."""

    name: str = "sgd"             # sgd | adamw
    learning_rate: float = 0.1    # for the reference batch size (256)
    reference_batch: int = 256    # linear-scaling rule base
    momentum: float = 0.9
    weight_decay: float = 1e-4
    schedule: str = "warmup_cosine"  # constant | linear | warmup_cosine |
                                     # warmup_poly
    grad_clip_norm: Optional[float] = None
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    label_smoothing: float = 0.1  # image classification loss


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 128
    image_size: int = 224
    num_classes: int = 1000


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training run on one card."""

    model: str = "gpt2_small"
    global_batch_size: int = 32
    total_steps: Optional[int] = None
    dtype: str = "bfloat16"       # compute dtype; parameters stay float32
    seed: int = 0
    log_every: int = 100
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 5000
    resume: bool = True
    attention_impl: Optional[str] = None  # None = the model's default
    fused_bn: bool = False        # BatchNorm through the CUDA kernels (CNNs)
    fused_block: bool = False     # bottleneck 1x1 convs through the matmul+
                                  # BatchNorm kernels (ResNet-50/101/152)
    fused_conv3: bool = False     # with fused_block: stride-1 3x3s through
                                  # the conv+BatchNorm kernels
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
