"""DenseNet-BC family in PyTorch.

Counterpart of ``distributeddeeplearning_tpu/models/densenet.py``, with its
details: explicit padding 3 on the 7x7 stride-2 stem, max-pool 3/2/1, each
dense layer BN-ReLU-1x1 (4 x growth) then BN-ReLU-3x3 (growth) whose output
is concatenated onto its input along the channels, transitions
BN-ReLU-1x1 (halving the channels) then a 2x2 average pool, a final
BN-ReLU, the global mean and a float32 classifier. Convolutions are drawn
from N(0, 2/fan_out), the classifier from a fan-in truncated normal, as in
``models/resnet.py``. Every BatchNorm is flax's (momentum 0.9, eps 1e-5,
statistics in float32), composed plainly by ``resnet.BatchNormAct``: the
JAX DenseNet has no fused BatchNorm path, so neither has this one.
``bn_axis_name`` averages every BatchNorm's statistics across the ranks in
training, as in ``models/resnet.py``.

Module names follow the flax tree (``conv_stem``, ``bn_stem``,
``block{i}_layer{j}.{bn1,conv1,bn2,conv2}``, ``transition{i}_{bn,conv}``,
``bn_final``, ``classifier``), so ``utils/weights.py`` carries a JAX
checkpoint across unchanged.

Layout: NHWC images in, viewed as channels_last NCHW (no copy); every conv
output is channels_last, and the concatenation is an eager ``torch.cat`` on
the channel axis, which keeps that layout and copies both operands.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.models.layers import Dense
from distributeddeeplearning_tpu_torch.models.resnet import (
    _TRUNC_STD, BatchNormAct, Conv, set_bn_axis_name)


class DenseLayer(nn.Module):
    """BN-ReLU-1x1 bottleneck (4 x growth) -> BN-ReLU-3x3 (growth); returns
    the new features only."""

    def __init__(self, cin: int, growth_rate: int, *, dtype: torch.dtype):
        super().__init__()
        self.bn1 = BatchNormAct(cin, dtype=dtype)
        self.conv1 = Conv(cin, 4 * growth_rate, 1, dtype=dtype)
        self.bn2 = BatchNormAct(4 * growth_rate, dtype=dtype)
        self.conv2 = Conv(4 * growth_rate, growth_rate, 3, 1, 1, dtype=dtype)

    def forward(self, x):
        return self.conv2(self.bn2(self.conv1(self.bn1(x))))


class DenseNet(nn.Module):
    """ImageNet DenseNet-BC: NHWC images in, float32 logits out."""

    def __init__(self, block_sizes: Sequence[int], growth_rate: int = 32,
                 num_init_features: int = 64, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_stem = Conv(3, num_init_features, 7, 2, 3, dtype=dtype)
        self.bn_stem = BatchNormAct(num_init_features, dtype=dtype)
        features = num_init_features
        for i, num_layers in enumerate(block_sizes):
            for j in range(num_layers):
                setattr(self, f"block{i + 1}_layer{j + 1}",
                        DenseLayer(features, growth_rate, dtype=dtype))
                features += growth_rate
            if i != len(block_sizes) - 1:
                setattr(self, f"transition{i + 1}_bn",
                        BatchNormAct(features, dtype=dtype))
                setattr(self, f"transition{i + 1}_conv",
                        Conv(features, features // 2, 1, dtype=dtype))
                features //= 2
        self.bn_final = BatchNormAct(features, dtype=dtype)
        self.classifier = Dense(features, num_classes, dtype)
        std = math.sqrt(1.0 / features) / _TRUNC_STD
        nn.init.trunc_normal_(self.classifier.weight, 0.0, std, -2 * std,
                              2 * std)
        nn.init.zeros_(self.classifier.bias)
        set_bn_axis_name(self, bn_axis_name)

    def forward(self, x):
        """x: (B, H, W, 3) images -> (B, num_classes) float32 logits."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.bn_stem(self.conv_stem(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for name, child in self.named_children():
            if name.startswith("block"):
                x = torch.cat([x, child(x)], dim=1)
            elif name.endswith("_bn"):
                x = child(x)
            elif name.endswith("_conv"):
                x = F.avg_pool2d(child(x), 2, 2)
        x = self.bn_final(x).mean(dim=(2, 3))
        return self.classifier(x).float()


def _factory(block_sizes, growth_rate: int = 32,
             num_init_features: int = 64):
    def build(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
              bn_axis_name: Optional[str] = None) -> DenseNet:
        return DenseNet(block_sizes, growth_rate, num_init_features,
                        num_classes=num_classes, dtype=dtype,
                        bn_axis_name=bn_axis_name)
    return build


densenet121 = _factory([6, 12, 24, 16])
densenet169 = _factory([6, 12, 32, 32])
# The port's test entry: two blocks of two layers, growth 8, 16 features.
densenet_nano = _factory([2, 2], growth_rate=8, num_init_features=16)
