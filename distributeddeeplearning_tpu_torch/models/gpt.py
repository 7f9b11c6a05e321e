"""GPT-2-style decoder-only causal LM in PyTorch.

Counterpart of ``distributeddeeplearning_tpu/models/gpt.py``: pre-LN
residual blocks, learned positions, tanh-GELU MLP, LM head tied to ``wte``,
f32 logits. Module and parameter names follow the flax tree, so
``utils/weights.py`` carries a JAX checkpoint across by renaming alone.

Two modes: the full sequence (``attention_impl`` dense or flash, causal over
a key-padding mask) and dense KV-cache decoding (``cache=``, see
models/decode_cache.py). Parameters are float32 masters; activations run in
the compute ``dtype`` (models/layers.py), as flax's ``param_dtype=float32,
dtype=...``. In training mode (``model.train()``) the embedding, both
residual branches and the attention probabilities take dropout at
``dropout_rate``, with randomness drawn from ``rng=``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributeddeeplearning_tpu_torch.models.decode_cache import (
    KVCache, live_mask)
from distributeddeeplearning_tpu_torch.models.layers import (
    Dense, LayerNorm, dropout, training_rng)
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
        self.query = Dense(h, h, dtype)
        self.key = Dense(h, h, dtype)
        self.value = Dense(h, h, dtype)
        self.output = Dense(h, h, dtype)

    def forward(self, x, pad_mask, *, cache: Optional[KVCache] = None,
                layer: int = 0, rng: Optional[torch.Generator] = None):
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
                dropout_rng=rng, training=rng is not None)
        return self.output(out)


class DecoderBlock(nn.Module):
    """Pre-LN transformer block (GPT-2 ordering)."""

    def __init__(self, cfg: GptConfig, dtype: torch.dtype):
        super().__init__()
        h = cfg.hidden_size
        self.rate = cfg.dropout_rate
        self.ln1 = LayerNorm(h, cfg.layer_norm_eps, dtype)
        self.attention = CausalSelfAttention(cfg, dtype)
        self.ln2 = LayerNorm(h, cfg.layer_norm_eps, dtype)
        self.mlp_in = Dense(h, cfg.intermediate_size, dtype)
        self.mlp_out = Dense(cfg.intermediate_size, h, dtype)

    def forward(self, x, pad_mask, *, cache: Optional[KVCache] = None,
                layer: int = 0, rng: Optional[torch.Generator] = None):
        h = self.attention(self.ln1(x), pad_mask, cache=cache, layer=layer,
                           rng=rng)
        x = x + dropout(h, self.rate, rng)
        # GPT-2 uses the tanh approximation.
        h = F.gelu(self.mlp_in(self.ln2(x)), approximate="tanh")
        return x + dropout(self.mlp_out(h), self.rate, rng)


class GptLM(nn.Module):
    """Decoder-only LM; returns (B, S, vocab) f32 logits (tied head).
    ``dtype`` is the compute dtype; parameters are float32."""

    def __init__(self, cfg: GptConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.wte = nn.Parameter(torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.wpe = nn.Parameter(torch.empty(cfg.max_position,
                                            cfg.hidden_size))
        self.layers = nn.ModuleList(
            DecoderBlock(cfg, dtype) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, dtype)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The JAX model's initializers: N(0, 0.02) kernels and token
        table, N(0, 0.01) positions, zero biases, unit LayerNorm scales."""
        nn.init.normal_(self.wte, std=0.02)
        nn.init.normal_(self.wpe, std=0.01)
        for m in self.modules():
            if isinstance(m, Dense):
                nn.init.normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    def init_cache(self, batch: int) -> KVCache:
        cfg = self.cfg
        return KVCache.zeros(
            cfg.num_layers,
            (batch, cfg.max_position, cfg.num_heads, cfg.head_dim),
            dtype=self.compute_dtype, device=self.wte.device)

    def forward(self, input_ids, attention_mask=None, *,
                cache: Optional[KVCache] = None,
                rng: Optional[torch.Generator] = None):
        """``rng``: the CPU generator the dropout sites draw from, required
        in training mode with a positive ``dropout_rate``."""
        cfg = self.cfg
        rng = training_rng(self, cfg.dropout_rate, rng)
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
        # Summed in f32, then cast, as the JAX model does.
        x = (F.embedding(input_ids, self.wte)
             + F.embedding(pos, self.wpe)).to(self.compute_dtype)
        x = dropout(x, cfg.dropout_rate, rng)
        for i, block in enumerate(self.layers):
            x = block(x, pad_mask, cache=cache, layer=i, rng=rng)
        if cache is not None:
            cache.advance(s)
        x = self.ln_f(x)
        return (x @ self.wte.to(self.compute_dtype).t()).float()


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
