"""Vision Transformer (ViT-B/16, ViT-L/16) in PyTorch.

Counterpart of ``distributeddeeplearning_tpu/models/vit.py``: a strided
patch-embedding convolution, the ``cls_token`` put before the patches, a
learned ``pos_embedding``, pre-LN blocks (LayerNorm eps 1e-6, exact GELU)
whose attention is ``bert.SelfAttention`` (non-causal, no padding: 197
tokens at 224 px with 16 px patches, which is no multiple of a kernel
tile), a final LayerNorm and a zero-initialised classifier on token 0.

The JAX model sizes its position table from the example input at init;
the port has no such init, so the table is sized from ``image_size`` at
construction. NHWC images in, (B, num_classes) float32 logits out.
Parameters are float32 masters, activations the compute ``dtype``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributeddeeplearning_tpu_torch.models import bert
from distributeddeeplearning_tpu_torch.models.layers import (
    Dense, LayerNorm, dropout, training_rng)
from distributeddeeplearning_tpu_torch.ops.attention import draw_seed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    num_classes: int = 1000
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    dropout_rate: float = 0.0     # DeiT-style default; the ViT paper's 0.1
    layer_norm_eps: float = 1e-6
    attention_impl: str = "dense"  # dense | flash (the CUDA kernels)
    remat: bool = False

    def as_bert_cfg(self) -> bert.BertConfig:
        """The attention-relevant slice, for reusing bert.SelfAttention."""
        return bert.BertConfig(
            hidden_size=self.hidden_size, num_heads=self.num_heads,
            dropout_rate=self.dropout_rate,
            attention_impl=self.attention_impl)


class ViTBlock(nn.Module):
    """Pre-LN transformer block: x + Attn(LN(x)); x + MLP(LN(x))."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.rate = cfg.dropout_rate
        self.attention_ln = LayerNorm(h, eps, dtype)
        self.attention = bert.SelfAttention(cfg.as_bert_cfg(), dtype)
        self.mlp_ln = LayerNorm(h, eps, dtype)
        self.intermediate = Dense(h, cfg.intermediate_size, dtype)
        self.mlp_output = Dense(cfg.intermediate_size, h, dtype)

    def forward(self, x, rng: Optional[torch.Generator] = None):
        y = self.attention(self.attention_ln(x), None, rng)
        x = x + dropout(y, self.rate, rng)
        y = F.gelu(self.intermediate(self.mlp_ln(x)))
        return x + dropout(self.mlp_output(y), self.rate, rng)


class VisionTransformer(nn.Module):
    """NHWC image of side ``image_size`` in, (B, num_classes) f32 logits
    out."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224):
        super().__init__()
        bert.check_carried(cfg.as_bert_cfg())
        if image_size % cfg.patch_size:
            raise ValueError(f"image_size {image_size} is not a multiple of "
                             f"the patch size {cfg.patch_size}")
        self.cfg = cfg
        self.compute_dtype = dtype
        h, p = cfg.hidden_size, cfg.patch_size
        tokens = (image_size // p) ** 2 + 1
        self.patch_embed = nn.Conv2d(3, h, p, stride=p, dtype=torch.float32)
        self.cls_token = nn.Parameter(torch.empty(1, h))
        self.pos_embedding = nn.Parameter(torch.empty(tokens, h))
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, dtype) for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(h, cfg.layer_norm_eps, dtype)
        self.classifier = Dense(h, cfg.num_classes, dtype)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The JAX model's initializers: a xavier-uniform patch kernel
        (fans over the (p, p, 3) receptive field and the width), N(0, 0.02)
        class token, positions and block kernels, a zero classifier, zero
        biases, unit LayerNorm scales."""
        conv = self.patch_embed
        p = self.cfg.patch_size
        fan_in, fan_out = 3 * p * p, self.cfg.hidden_size * p * p
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        nn.init.uniform_(conv.weight, -limit, limit)
        nn.init.zeros_(conv.bias)
        nn.init.normal_(self.cls_token, std=0.02)
        nn.init.normal_(self.pos_embedding, std=0.02)
        for m in self.modules():
            if isinstance(m, Dense):
                nn.init.normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)
        nn.init.zeros_(self.classifier.weight)

    def forward(self, x, *, rng: Optional[torch.Generator] = None):
        """``rng``: the CPU generator the dropout sites draw from, required
        in training mode with a positive ``dropout_rate``."""
        cfg = self.cfg
        rng = training_rng(self, cfg.dropout_rate, rng)
        dt = self.compute_dtype
        conv = self.patch_embed
        x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt),
                     conv.bias.to(dt), stride=cfg.patch_size)
        b, d = x.shape[:2]
        if x.shape[2] * x.shape[3] + 1 != self.pos_embedding.shape[0]:
            raise ValueError(
                f"{x.shape[2]}x{x.shape[3]} patches do not fit the position "
                f"table of {self.pos_embedding.shape[0] - 1}; build the "
                f"model with this image_size")
        x = x.flatten(2).transpose(1, 2)           # (B, h*w, D), row-major
        cls = self.cls_token.to(dt).expand(b, 1, d)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        x = dropout(x, cfg.dropout_rate, rng)
        for block in self.blocks:
            seed = None if rng is None else draw_seed(rng)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_block_forward, block, x, seed,
                               use_reentrant=False)
            else:
                x = _block_forward(block, x, seed)
        x = self.final_ln(x)
        return self.classifier(x[:, 0]).float()


def _block_forward(block: ViTBlock, x, seed: Optional[int]):
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    return block(x, rng)


def vit_b16(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
            image_size: int = 224, **overrides: Any) -> VisionTransformer:
    return VisionTransformer(ViTConfig(num_classes=num_classes, **overrides),
                             dtype=dtype, image_size=image_size)


def vit_l16(num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
            image_size: int = 224, **overrides: Any) -> VisionTransformer:
    return VisionTransformer(
        ViTConfig(num_classes=num_classes,
                  **{"hidden_size": 1024, "num_layers": 24, "num_heads": 16,
                     "intermediate_size": 4096, **overrides}),
        dtype=dtype, image_size=image_size)


def tiny_vit(num_classes: int = 10, dtype: torch.dtype = torch.float32,
             image_size: int = 32, **overrides: Any) -> VisionTransformer:
    """Test-sized ViT (8 px patches, 2 layers, 64 wide, 4 heads)."""
    return VisionTransformer(
        ViTConfig(num_classes=num_classes,
                  **{"patch_size": 8, "hidden_size": 64, "num_layers": 2,
                     "num_heads": 4, "intermediate_size": 128, **overrides}),
        dtype=dtype, image_size=image_size)
