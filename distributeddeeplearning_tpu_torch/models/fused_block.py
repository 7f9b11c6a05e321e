"""Bottleneck block whose convolutions carry the BatchNorm work:
counterpart of ``distributeddeeplearning_tpu/models/fused_block.py``.

In training, through the matmul kernels of ``ops/fused_linear_bn.py``:

- conv1 computes bn1's sum and sum of squares in its epilogue;
- conv3 normalises conv2's raw output in its prologue (bn2's apply) and
  computes bn3's sums in its epilogue; bn2's backward reductions ride its
  backward products;
- the downsample's 1x1 computes its BatchNorm's sums in its epilogue.

With ``conv3_fused`` a stride-1 block's 3x3 runs through the kernels of
``ops/fused_conv_bn.py``: it takes conv1's raw output, applies bn1 (and
its ReLU) in its prologue and computes bn2's sums in its epilogue, so
neither bn1's applied activation nor a separate pass for bn2's statistics
exists. A stride-2 block keeps the path below, as the reference does.

What stays plain PyTorch, as it stays jnp/XLA in the reference: without
``conv3_fused`` (or at stride 2), bn1's apply (its output feeds the 3x3),
the 3x3 itself (``F.conv2d`` on channels_last) and bn2's statistics; and
always the downsample's apply and the block exit relu(bn3 apply +
shortcut). A BatchNorm's mean and biased variance come from its sums as
``max(E[y^2] - mean^2, 0)``, then flax's running update. Under cross-replica
BatchNorm (the block's BatchNorms' ``axis_name``) the mean and E[y^2] from
the kernels' sums are averaged over the ranks first, as the JAX block's
``_stats`` pmeans them; their gradients flow back through the same mean
into the backward kernels.

Parameters and buffers are ``BottleneckBlock``'s, under the same names, so
one checkpoint drives either block. Evaluation runs ``BottleneckBlock``'s
plain composition with the running statistics.
"""

from __future__ import annotations

import torch

from distributeddeeplearning_tpu_torch.models.resnet import (
    BatchNormAct, BottleneckBlock, Conv, moments)
from distributeddeeplearning_tpu_torch.ops.fused_batchnorm import as_rows
from distributeddeeplearning_tpu_torch.ops.fused_conv_bn import (
    bn_conv3x3_stats)
from distributeddeeplearning_tpu_torch.ops.fused_linear_bn import (
    bn_linear_stats, linear_stats)


def _matrix(conv: Conv) -> torch.Tensor:
    """A 1x1 convolution's weight in the compute dtype as (out, in)."""
    w = conv.weight.to(conv.compute_dtype)
    return w.view(w.shape[0], w.shape[1])


def _kernel3(conv: Conv) -> torch.Tensor:
    """A 3x3 convolution's weight in the compute dtype, channels_last."""
    return conv.weight.to(conv.compute_dtype,
                          memory_format=torch.channels_last)


def _batch_stats(bn: BatchNormAct, s, ss, m: int):
    """(mean, inv) of a BatchNorm from its sums over m rows (averaged over
    the ranks under its ``axis_name``), after flax's running update with
    (mean, biased var)."""
    mean, ex2 = moments(s / m, ss / m, bn.axis_name)
    var = (ex2 - mean * mean).clamp_min(0.0)
    bn.update_running(mean.detach(), var.detach())
    return mean, torch.rsqrt(var + bn.eps)


def _apply(y2d, mean, inv, bn: BatchNormAct):
    """(y - mean) * (inv * gamma) + beta in float32."""
    return (y2d.float() - mean) * (inv * bn.weight) + bn.bias


def _image(rows, n: int, h: int, w: int):
    """(N*H*W, C) rows as the channels_last (N, C, H, W) tensor they are."""
    return rows.view(n, h, w, rows.shape[1]).permute(0, 3, 1, 2)


class FusedBottleneckBlock(BottleneckBlock):
    """``BottleneckBlock`` with its 1x1 convolutions on kernels #8-#10 in
    training and, with ``conv3_fused`` at stride 1, its 3x3 on kernels
    #11-#13. Input: channels_last (N, C, H, W); output likewise."""

    def __init__(self, cin: int, filters: int, stride: int, *,
                 dtype: torch.dtype, conv3_fused: bool = False):
        # The block's own BatchNorms are plain: in training they only hold
        # variables; in eval they run the plain composition.
        super().__init__(cin, filters, stride, dtype=dtype, fused_bn=False)
        self.conv3_fused = conv3_fused

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        x = x.to(self.conv1.compute_dtype)
        n, _, h, w = x.shape
        x2d = as_rows(x)

        # conv1 with bn1's sums.
        y1, s1, ss1 = linear_stats(x2d, _matrix(self.conv1))
        mean1, inv1 = _batch_stats(self.bn1, s1, ss1, y1.shape[0])
        if self.conv3_fused and self.conv2.stride == 1:
            # The 3x3 takes raw y1: bn1's apply is its prologue, bn2's sums
            # its epilogue.
            y2, s2, ss2 = bn_conv3x3_stats(
                y1.view(n, h, w, -1), mean1, inv1, self.bn1.weight,
                self.bn1.bias, _kernel3(self.conv2), True, True)
            ho, wo = h, w
            y2d = y2.view(-1, y2.shape[-1])
            mean2, inv2 = _batch_stats(self.bn2, s2, ss2, y2d.shape[0])
        else:
            # bn1's apply materialises for the library 3x3; bn2's
            # statistics in one plain reduce.
            a1 = torch.relu(_apply(y1, mean1, inv1, self.bn1)).to(x.dtype)
            y2 = self.conv2(_image(a1, n, h, w))
            ho, wo = y2.shape[2], y2.shape[3]
            y2d = as_rows(y2)
            y2f = y2d.float()
            mean2, inv2 = _batch_stats(self.bn2, y2f.sum(dim=0),
                                       (y2f * y2f).sum(dim=0), y2d.shape[0])

        # bn2's apply is conv3's prologue, bn3's sums its epilogue.
        y3, s3, ss3 = bn_linear_stats(y2d, mean2, inv2, self.bn2.weight,
                                      self.bn2.bias, _matrix(self.conv3),
                                      True, True)
        mean3, inv3 = _batch_stats(self.bn3, s3, ss3, y3.shape[0])

        if hasattr(self, "downsample_conv"):
            stride = self.downsample_conv.stride
            xs = x if stride == 1 else x[:, :, ::stride, ::stride].contiguous(
                memory_format=torch.channels_last)
            yd, sd, ssd = linear_stats(as_rows(xs),
                                       _matrix(self.downsample_conv))
            meand, invd = _batch_stats(self.downsample_bn, sd, ssd,
                                       yd.shape[0])
            shortcut = _apply(yd, meand, invd, self.downsample_bn)
        else:
            shortcut = x2d.float()

        # Block exit: bn3's apply, the shortcut and the ReLU in one pass.
        # torch.relu passes no gradient at 0, as the unfused block's ReLU
        # (and flax's nn.relu) do: at init (gamma3 = beta3 = 0) the exit is
        # the shortcut, exactly 0 wherever the block's input is. The JAX
        # fused block's jnp.maximum would pass half there.
        out = torch.relu(_apply(y3, mean3, inv3, self.bn3) + shortcut)
        return _image(out.to(x.dtype), n, ho, wo)
