"""ResNet v1.5 family in PyTorch.

Counterpart of ``distributeddeeplearning_tpu/models/resnet.py``, with its
details: explicit padding 3 on the 7x7 stem and 1 on the 3x3s, max-pool
3/2/1, the stride of a downsampling bottleneck on its 3x3 (v1.5), zero-init
gamma on the last BatchNorm of each block, convolutions drawn from N(0,
2/fan_out) and the classifier from a fan-in truncated normal. Parameters
are float32 masters cast to the compute ``dtype`` at use, logits float32.
Module names follow the flax tree (``conv_stem``, ``bn_stem``,
``stage{i}_block{j}``, ``conv1..3``, ``bn1..3``, ``downsample_conv``,
``downsample_bn``, ``classifier``), so ``utils/weights.py`` carries a JAX
checkpoint across by renaming.

Layout: ``forward`` takes NHWC images (B, H, W, 3), as the JAX model and its
data do. ``permute(0, 3, 1, 2)`` makes them a channels_last NCHW view
without a copy, and the convolutions (``F.conv2d``, which the JAX package
also leaves to the compiler) take channels_last weights, so every conv
output is channels_last and its (N*H*W, C) view is free for the BatchNorm
kernels.

``fused_bn=True`` routes every BatchNorm [+ residual] [+ ReLU] through the
CUDA kernels of ``ops/fused_batchnorm.py`` in training. The default follows
flax ``nn.BatchNorm`` plainly: float32 statistics, the same biased running
update, the result cast to the compute dtype, then the residual add and the
ReLU. ``fused_block=True`` (bottleneck nets) builds every block as
``models/fused_block.py``'s ``FusedBottleneckBlock``, whose 1x1
convolutions carry the BatchNorm work through the matmul kernels of
``ops/fused_linear_bn.py``; ``fused_bn`` then governs the stem alone.
``fused_conv3=True`` (with ``fused_block`` only) also runs each stride-1
block's 3x3 through the kernels of ``ops/fused_conv_bn.py``. All create the
same variables.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.models.layers import Dense
from distributeddeeplearning_tpu_torch.ops.fused_batchnorm import (
    FusedBatchNormAct)

# flax's variance_scaling(1.0, "fan_in", "truncated_normal") draws from a
# normal truncated at two standard deviations, and divides the standard
# deviation by that distribution's own (0.87962566...) so the variance stays
# 1/fan_in.
_TRUNC_STD = 0.87962566103423978


class BatchNormAct(FusedBatchNormAct):
    """flax ``nn.BatchNorm`` [+ residual] [+ ReLU], composed plainly: the
    path without ``fused_bn``. Runs no kernel; any layout. Statistics and
    the affine run in at least float32 (float64 stays float64), as flax's
    ``_compute_stats`` promotes."""

    def forward(self, x, residual=None):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = (1, -1, 1, 1)
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            self.update_running(mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = ((xf - mean.view(shape)) * mul.view(shape)
             + self.bias.view(shape)).to(self.compute_dtype)
        if residual is not None:
            y = y + residual
        return F.relu(y) if self.relu else y


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: a float32 (out, in, kh, kw) master,
    cast at use to the compute dtype in channels_last layout."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, *, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel,
                                               dtype=torch.float32))
        nn.init.normal_(self.weight, 0.0,
                        math.sqrt(2.0 / (cout * kernel * kernel)))
        self.stride, self.padding = stride, padding
        self.compute_dtype = dtype

    def forward(self, x):
        w = self.weight.to(self.compute_dtype,
                           memory_format=torch.channels_last)
        return F.conv2d(x, w, stride=self.stride, padding=self.padding)


def _norm(fused: bool):
    return FusedBatchNormAct if fused else BatchNormAct


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with expansion 4 (ResNet-50/101/152)."""

    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype: torch.dtype, fused_bn: bool):
        super().__init__()
        norm, out = _norm(fused_bn), filters * 4
        self.conv1 = Conv(cin, filters, 1, dtype=dtype)
        self.bn1 = norm(filters, dtype=dtype)
        self.conv2 = Conv(filters, filters, 3, stride, 1, dtype=dtype)
        self.bn2 = norm(filters, dtype=dtype)
        self.conv3 = Conv(filters, out, 1, dtype=dtype)
        self.bn3 = norm(out, dtype=dtype, zero_init=True)
        if cin != out or stride != 1:
            self.downsample_conv = Conv(cin, out, 1, stride, dtype=dtype)
            self.downsample_bn = norm(out, relu=False, dtype=dtype)

    def forward(self, x):
        residual = x
        y = self.bn1(self.conv1(x))
        y = self.bn2(self.conv2(y))
        y = self.conv3(y)
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.bn3(y, residual)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 residual block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype: torch.dtype, fused_bn: bool):
        super().__init__()
        norm = _norm(fused_bn)
        self.conv1 = Conv(cin, filters, 3, stride, 1, dtype=dtype)
        self.bn1 = norm(filters, dtype=dtype)
        self.conv2 = Conv(filters, filters, 3, 1, 1, dtype=dtype)
        self.bn2 = norm(filters, dtype=dtype, zero_init=True)
        if cin != filters or stride != 1:
            self.downsample_conv = Conv(cin, filters, 1, stride, dtype=dtype)
            self.downsample_bn = norm(filters, relu=False, dtype=dtype)

    def forward(self, x):
        residual = x
        y = self.conv2(self.bn1(self.conv1(x)))
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return self.bn2(y, residual)


def _later(flag: str, value, slice_name: str) -> None:
    if value:
        raise NotImplementedError(f"{flag}={value!r} is not carried by the "
                                  f"port yet; it comes with {slice_name}")


class ResNet(nn.Module):
    """ImageNet ResNet: ``stage_sizes`` picks the depth; NHWC images in,
    float32 logits out."""

    def __init__(self, stage_sizes: Sequence[int], block: type,
                 num_classes: int = 1000, width: int = 64,
                 dtype: torch.dtype = torch.bfloat16, fused_bn: bool = False,
                 fused_block: bool = False, fused_conv3: bool = False,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        _later("bn_axis_name", bn_axis_name, "data parallelism "
               "(cross-replica BatchNorm statistics)")
        if fused_block and block is not BottleneckBlock:
            raise ValueError("fused_block requires bottleneck blocks "
                             "(resnet50/101/152); basic blocks have no 1x1 "
                             "convolutions to fuse")
        if fused_conv3 and not fused_block:
            raise ValueError("fused_conv3 extends fused_block (the 3x3 "
                             "kernel shares its statistics plumbing); pass "
                             "fused_block=True on a bottleneck net")
        # fused_bn reaches the blocks it applies to; with fused_block it
        # governs the stem alone.
        per_block = {"fused_bn": fused_bn}
        if fused_block:
            from distributeddeeplearning_tpu_torch.models.fused_block import (
                FusedBottleneckBlock)
            block = FusedBottleneckBlock
            per_block = {"conv3_fused": fused_conv3}
        self.dtype = dtype
        self.conv_stem = Conv(3, width, 7, 2, 3, dtype=dtype)
        self.bn_stem = _norm(fused_bn)(width, dtype=dtype)
        cin = width
        for i, num_blocks in enumerate(stage_sizes):
            for j in range(num_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                filters = width * 2 ** i
                setattr(self, f"stage{i + 1}_block{j + 1}",
                        block(cin, filters, stride, dtype=dtype,
                              **per_block))
                cin = filters * block.expansion
        self.classifier = Dense(cin, num_classes, dtype)
        std = math.sqrt(1.0 / cin) / _TRUNC_STD
        nn.init.trunc_normal_(self.classifier.weight, 0.0, std, -2 * std,
                              2 * std)
        nn.init.zeros_(self.classifier.bias)

    def forward(self, x):
        """x: (B, H, W, 3) images -> (B, num_classes) float32 logits."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.bn_stem(self.conv_stem(x))
        x = F.max_pool2d(x, 3, 2, 1)
        for name, child in self.named_children():
            if name.startswith("stage"):
                x = child(x)
        x = x.mean(dim=(2, 3))
        return self.classifier(x).float()


def _factory(stage_sizes, block, width: int = 64):
    def build(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
              fused_bn: bool = False, fused_block: bool = False,
              fused_conv3: bool = False,
              bn_axis_name: Optional[str] = None) -> ResNet:
        return ResNet(stage_sizes, block, num_classes, width=width,
                      dtype=dtype, fused_bn=fused_bn, fused_block=fused_block,
                      fused_conv3=fused_conv3, bn_axis_name=bn_axis_name)
    return build


resnet18 = _factory([2, 2, 2, 2], BasicBlock)
# Width-16 stand-ins of the JAX package for CPU-sized runs.
resnet18_thin = _factory([2, 2, 2, 2], BasicBlock, width=16)
resnet26_thin = _factory([2, 2, 2, 2], BottleneckBlock, width=16)
resnet34 = _factory([3, 4, 6, 3], BasicBlock)
resnet50 = _factory([3, 4, 6, 3], BottleneckBlock)
resnet101 = _factory([3, 4, 23, 3], BottleneckBlock)
resnet152 = _factory([3, 8, 36, 3], BottleneckBlock)
# The port's test entry: two stages of one bottleneck each, width 8.
resnet_nano = _factory([1, 1], BottleneckBlock, width=8)
