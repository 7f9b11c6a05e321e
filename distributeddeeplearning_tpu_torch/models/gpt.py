"""GPT-2-style decoder-only causal LM in PyTorch.

Counterpart of ``distributeddeeplearning_tpu/models/gpt.py``: pre-LN
residual blocks, learned positions, tanh-GELU MLP, LM head tied to ``wte``,
f32 logits. Module and parameter names follow the flax tree, so
``utils/weights.py`` carries a JAX checkpoint across by renaming alone.

Two modes: the full sequence (``attention_impl`` dense or flash, causal over
a key-padding mask) and dense KV-cache decoding (``cache=``, see
models/decode_cache.py). Activations run in the parameters' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.models.decode_cache import (
    KVCache, live_mask)
from distributeddeeplearning_tpu_torch.ops.attention import (
    multihead_attention)


@dataclasses.dataclass(frozen=True)
class GptConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position: int = 1024
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-5
    attention_impl: str = "dense"   # dense | flash (the CUDA kernel)

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GptConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = nn.Linear(h, h, dtype=dtype)
        self.key = nn.Linear(h, h, dtype=dtype)
        self.value = nn.Linear(h, h, dtype=dtype)
        self.output = nn.Linear(h, h, dtype=dtype)

    def forward(self, x, pad_mask, *, cache: Optional[KVCache] = None,
                layer: int = 0):
        cfg = self.cfg
        b, s, _ = x.shape
        shape = (b, s, cfg.num_heads, cfg.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        if cache is not None:
            # Decode: the block attends over the live cache prefix. The
            # finfo.min fill (not -inf) keeps padded rows finite, as in JAX.
            keys, values = cache.append(layer, k, v)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, keys) \
                * cfg.head_dim ** -0.5
            scores = scores.float().masked_fill(
                ~live_mask(cache.index, s, x.device),
                torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", probs, values)
            out = out.reshape(b, s, cfg.hidden_size)
        else:
            out = multihead_attention(
                q, k, v, pad_mask, impl=cfg.attention_impl, causal=True,
                dtype=x.dtype, dropout_rate=cfg.dropout_rate,
                training=self.training)
        return self.output(out)


class DecoderBlock(nn.Module):
    """Pre-LN transformer block (GPT-2 ordering)."""

    def __init__(self, cfg: GptConfig, dtype: torch.dtype):
        super().__init__()
        h = cfg.hidden_size
        self.ln1 = nn.LayerNorm(h, eps=cfg.layer_norm_eps, dtype=dtype)
        self.attention = CausalSelfAttention(cfg, dtype)
        self.ln2 = nn.LayerNorm(h, eps=cfg.layer_norm_eps, dtype=dtype)
        self.mlp_in = nn.Linear(h, cfg.intermediate_size, dtype=dtype)
        self.mlp_out = nn.Linear(cfg.intermediate_size, h, dtype=dtype)

    def forward(self, x, pad_mask, *, cache: Optional[KVCache] = None,
                layer: int = 0):
        x = x + self.attention(self.ln1(x), pad_mask, cache=cache,
                               layer=layer)
        # GPT-2 uses the tanh approximation.
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + self.mlp_out(h)


class GptLM(nn.Module):
    """Decoder-only LM; returns (B, S, vocab) f32 logits (tied head)."""

    def __init__(self, cfg: GptConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size,
                                            dtype=dtype))
        self.wpe = nn.Parameter(torch.empty(cfg.max_position,
                                            cfg.hidden_size, dtype=dtype))
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, dtype) for _ in range(cfg.num_layers))
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                 dtype=dtype)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The JAX model's initializers: N(0, 0.02) kernels and token
        table, N(0, 0.01) positions, zero biases, unit LayerNorm scales."""
        nn.init.normal_(self.wte, std=0.02)
        nn.init.normal_(self.wpe, std=0.01)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    def init_cache(self, batch: int) -> KVCache:
        cfg = self.cfg
        return KVCache.zeros(
            cfg.num_layers,
            (batch, cfg.max_position, cfg.num_heads, cfg.head_dim),
            dtype=self.wte.dtype, device=self.wte.device)

    def forward(self, input_ids, attention_mask=None, *,
                cache: Optional[KVCache] = None):
        cfg = self.cfg
        b, s = input_ids.shape
        start = cache.index if cache is not None else 0
        if start + s > cfg.max_position:
            raise ValueError(
                f"positions up to {start + s} exceed max_position "
                f"{cfg.max_position}; build the model with seq_len="
                f"{start + s}")
        pad_mask = (None if attention_mask is None
                    else attention_mask.bool())
        pos = torch.arange(start, start + s, device=input_ids.device)
        x = F.embedding(input_ids, self.wte) + F.embedding(pos, self.wpe)
        for i, block in enumerate(self.layers):
            x = block(x, pad_mask, cache=cache, layer=i)
        if cache is not None:
            cache.advance(s)
        x = self.ln_f(x)
        return (x @ self.wte.t()).float()


def _fit_positions(cfg: GptConfig, seq_len: Optional[int]) -> GptConfig:
    if seq_len and seq_len > cfg.max_position:
        cfg = dataclasses.replace(cfg, max_position=seq_len)
    return cfg


def gpt2_small(vocab_size: int = 50257, dtype: torch.dtype = torch.bfloat16,
               seq_len: Optional[int] = None, **overrides: Any) -> GptLM:
    """GPT-2 124M geometry (12L/768H/12 heads, 1024 positions)."""
    cfg = GptConfig(vocab_size=vocab_size, **overrides)
    return GptLM(_fit_positions(cfg, seq_len), dtype=dtype)


def gpt2_medium(vocab_size: int = 50257, dtype: torch.dtype = torch.bfloat16,
                seq_len: Optional[int] = None, **overrides: Any) -> GptLM:
    cfg = GptConfig(vocab_size=vocab_size,
                    **{"hidden_size": 1024, "num_layers": 24, "num_heads": 16,
                       **overrides})
    return GptLM(_fit_positions(cfg, seq_len), dtype=dtype)


def tiny_gpt(vocab_size: int = 1024, dtype: torch.dtype = torch.float32,
             seq_len: Optional[int] = None, **overrides: Any) -> GptLM:
    cfg = GptConfig(vocab_size=vocab_size,
                    **{"hidden_size": 64, "num_layers": 2, "num_heads": 4,
                       "max_position": 128, **overrides})
    return GptLM(_fit_positions(cfg, seq_len), dtype=dtype)
