"""Layers the transformer families share: flax's float32 masters with a
separate compute dtype, and flax's dropout.

flax builds every layer of the JAX models with ``param_dtype=float32`` and
``dtype=<compute dtype>``: parameters stay float32 and are cast to the
compute dtype where they are used. These layers do the same, so a bf16
training step updates float32 weights, and a float32 model computes exactly
what ``nn.Linear``/``nn.LayerNorm`` would.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.ops.attention import draw_seed


class Dense(nn.Linear):
    """flax ``nn.Dense``: float32 weight (and bias) cast to the compute
    dtype at use; inputs arrive in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return F.linear(x, self.weight.to(self.compute_dtype), bias)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: statistics and the affine in float32 over
    float32 parameters, the result cast to the compute dtype."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__(dim, eps=eps, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


def dropout(x, rate: float, rng: Optional[torch.Generator]):
    """flax ``nn.Dropout`` in training: keep each element with probability
    ``1 - rate`` and divide the kept ones by it. The bits come from a
    generator on x's device seeded by one draw from ``rng``, so a run is
    reproducible from ``rng``'s seed alone. ``rng`` None means no dropout
    (evaluation); the models check that training passes one."""
    if rng is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(draw_seed(rng))
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                         device=x.device))


def training_rng(module: nn.Module, rate: float,
                 rng: Optional[torch.Generator]
                 ) -> Optional[torch.Generator]:
    """The generator the dropout sites of a forward draw from: ``rng`` in
    training mode with a positive rate (where it is required, as flax
    requires a ``dropout`` rng), else None."""
    if not module.training or rate == 0.0:
        return None
    if rng is None:
        raise ValueError(
            f"training with dropout_rate {rate} needs rng=: a torch.Generator "
            f"(on the CPU) that the dropout sites draw their seeds from")
    return rng
