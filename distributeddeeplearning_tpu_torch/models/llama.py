"""Llama-family decoder-only causal LM in PyTorch.

Counterpart of ``distributeddeeplearning_tpu/models/llama.py``: RMSNorm,
half-split rotary embeddings, SwiGLU MLP, grouped-query attention, no
biases, untied LM head, f32 logits. Module and parameter names follow the
flax tree (``utils/weights.py``).

Full-sequence mode repeats each KV head over its query group for the shared
attention impls (outside the flash kernels, so autograd sums each group's
K/V gradients); decode mode caches K/V at kv-head width (the GQA saving)
and attends with a grouped einsum; paged mode (``paged=`` and ``pools=``,
serve/kv_cache.py) rotates each serve slot at its own positions and
attends over its pages. Parameters are float32 masters and
activations run in the compute ``dtype`` (models/layers.py). In training
mode the residual branches and attention probabilities take dropout at
``dropout_rate`` (0 by default, the Llama recipe), drawn from ``rng=``.
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
    Dense, dropout, training_rng)
from distributeddeeplearning_tpu_torch.ops.attention import (
    multihead_attention)
from distributeddeeplearning_tpu_torch.serve import kv_cache as paged_kv


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32          # < num_heads = grouped-query attention
    intermediate_size: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dropout_rate: float = 0.0
    attention_impl: str = "dense"   # dense | flash (the CUDA kernel)
    # KV-cache length for decode mode (RoPE has no position table, so this
    # is the only static sequence bound generation needs).
    decode_cache_len: int = 2048

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: f32 statistics, x * (rsqrt(mean(x^2) + eps) *
    scale) over a float32 scale, cast back to x's (the compute) dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(var + self.eps)
                      * self.weight.float())).to(x.dtype)


def apply_rope(x, *, theta: float, offset: int = 0,
               positions: Optional[torch.Tensor] = None):
    """Rotary embedding, half-split (rotate_half) convention: x (B, S, H, D)
    rotated by (offset + index) along dim 1, or by ``positions``, a (B, S)
    tensor when every row sits at its own position (paged decode: each
    serve slot's length). Both give the same angles where they meet. The
    rotation runs in f32 whatever the storage dtype."""
    b, s, h, d = x.shape
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    pos = (positions.float() if positions is not None
           else offset + torch.arange(s, dtype=torch.float32,
                                      device=x.device))
    ang = pos[..., None] * freqs                # (S, D/2) or (B, S, D/2)
    if ang.dim() == 2:
        ang = ang[None]                         # shared across the batch
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.hidden_size, cfg.head_dim
        self.q_proj = Dense(h, cfg.num_heads * d, dtype, bias=False)
        self.k_proj = Dense(h, cfg.num_kv_heads * d, dtype, bias=False)
        self.v_proj = Dense(h, cfg.num_kv_heads * d, dtype, bias=False)
        self.o_proj = Dense(cfg.num_heads * d, h, dtype, bias=False)

    def forward(self, x, pad_mask, *, cache: Optional[KVCache] = None,
                layer: int = 0, rng: Optional[torch.Generator] = None,
                paged=None, pools=None):
        cfg = self.cfg
        b, s, _ = x.shape
        d, kvh = cfg.head_dim, cfg.num_kv_heads
        rep = cfg.num_heads // kvh
        q = self.q_proj(x).view(b, s, cfg.num_heads, d)
        k = self.k_proj(x).view(b, s, kvh, d)
        v = self.v_proj(x).view(b, s, kvh, d)
        if paged is not None:
            # Each slot rotates at its own absolute positions before its
            # K/V go into the pool, as the dense branch does before caching.
            pos = paged.lengths[:, None] + torch.arange(s, device=x.device)
            q = apply_rope(q, theta=cfg.rope_theta, positions=pos)
            k = apply_rope(k, theta=cfg.rope_theta, positions=pos)
            return self.o_proj(paged_kv.paged_attention(
                q, k, v, pools.keys[layer], pools.values[layer], paged))
        # Decode rotates at absolute positions (the cache index) before
        # caching.
        offset = cache.index if cache is not None else 0
        q = apply_rope(q, theta=cfg.rope_theta, offset=offset)
        k = apply_rope(k, theta=cfg.rope_theta, offset=offset)
        if cache is not None:
            keys, values = cache.append(layer, k, v)
            qg = q.reshape(b, s, kvh, rep, d)
            scores = torch.einsum("bqgrd,bkgd->bgrqk", qg, keys) * d ** -0.5
            scores = scores.float().masked_fill(
                ~live_mask(cache.index, s, x.device),
                torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bgrqk,bkgd->bqgrd", probs, values)
            out = out.reshape(b, s, cfg.num_heads * d)
        else:
            if rep > 1:
                # GQA: each KV head serves `rep` consecutive query heads
                # (jnp.repeat semantics, not Tensor.repeat).
                k = torch.repeat_interleave(k, rep, dim=2)
                v = torch.repeat_interleave(v, rep, dim=2)
            out = multihead_attention(
                q, k, v, pad_mask, impl=cfg.attention_impl, causal=True,
                dtype=x.dtype, dropout_rate=cfg.dropout_rate,
                dropout_rng=rng, training=rng is not None)
        return self.o_proj(out)


class LlamaBlock(nn.Module):
    """Pre-RMSNorm block: x + Attn(norm(x)); x + SwiGLU(norm(x))."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.rate = cfg.dropout_rate
        self.attention_norm = RMSNorm(h, cfg.rms_eps)
        self.attention = LlamaAttention(cfg, dtype)
        self.mlp_norm = RMSNorm(h, cfg.rms_eps)
        self.gate_proj = Dense(h, f, dtype, bias=False)
        self.up_proj = Dense(h, f, dtype, bias=False)
        self.down_proj = Dense(f, h, dtype, bias=False)

    def forward(self, x, pad_mask, *, cache: Optional[KVCache] = None,
                layer: int = 0, rng: Optional[torch.Generator] = None,
                paged=None, pools=None):
        h = self.attention(self.attention_norm(x), pad_mask, cache=cache,
                           layer=layer, rng=rng, paged=paged, pools=pools)
        x = x + dropout(h, self.rate, rng)
        h = self.mlp_norm(x)
        h = self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))
        return x + dropout(h, self.rate, rng)


class LlamaLM(nn.Module):
    """Decoder-only LM; returns (B, S, vocab) f32 logits (untied head).
    ``dtype`` is the compute dtype; parameters are float32."""

    def __init__(self, cfg: LlamaConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        self.embed_tokens = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size))
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, dtype) for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, dtype,
                             bias=False)
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The JAX model's initializers: N(0, 0.02) kernels and embedding,
        unit norm scales."""
        nn.init.normal_(self.embed_tokens, std=0.02)
        for m in self.modules():
            if isinstance(m, Dense):
                nn.init.normal_(m.weight, std=0.02)

    def init_cache(self, batch: int) -> KVCache:
        cfg = self.cfg
        return KVCache.zeros(
            cfg.num_layers,
            (batch, cfg.decode_cache_len, cfg.num_kv_heads, cfg.head_dim),
            dtype=self.compute_dtype, device=self.embed_tokens.device)

    def forward(self, input_ids, attention_mask=None, *,
                cache: Optional[KVCache] = None,
                rng: Optional[torch.Generator] = None,
                paged=None, pools=None):
        """``rng``: the CPU generator the dropout sites draw from, required
        in training mode with a positive ``dropout_rate``. ``paged``: a
        ``PagedState`` (one token a slot) or ``PagedBlockState`` over
        ``pools``, in place of ``cache``."""
        if paged is not None:
            paged_kv.check_paged_call(self, input_ids.shape[1], paged, pools,
                                      cache)
        rng = training_rng(self, self.cfg.dropout_rate, rng)
        pad_mask = (None if attention_mask is None
                    else attention_mask.bool())
        x = F.embedding(input_ids, self.embed_tokens).to(self.compute_dtype)
        for i, block in enumerate(self.layers):
            x = block(x, pad_mask, cache=cache, layer=i, rng=rng,
                      paged=paged, pools=pools)
        if cache is not None:
            cache.advance(input_ids.shape[1])
        return self.lm_head(self.final_norm(x)).float()


def llama2_7b(vocab_size: int = 32000, dtype: torch.dtype = torch.bfloat16,
              seq_len: Optional[int] = None, **overrides: Any) -> LlamaLM:
    """Llama-2-7B geometry (32L/4096H/32 heads, SwiGLU 11008)."""
    del seq_len  # RoPE: no position table, any sequence length
    return LlamaLM(LlamaConfig(vocab_size=vocab_size, **overrides),
                   dtype=dtype)


def tinyllama_1b(vocab_size: int = 32000, dtype: torch.dtype = torch.bfloat16,
                 seq_len: Optional[int] = None, **overrides: Any) -> LlamaLM:
    """TinyLlama-1.1B geometry (22L/2048H/32 heads, 4 KV heads, 5632)."""
    del seq_len
    return LlamaLM(
        LlamaConfig(vocab_size=vocab_size,
                    **{"hidden_size": 2048, "num_layers": 22, "num_heads": 32,
                       "num_kv_heads": 4, "intermediate_size": 5632,
                       **overrides}), dtype=dtype)


def tiny_llama(vocab_size: int = 1024, dtype: torch.dtype = torch.float32,
               seq_len: Optional[int] = None, **overrides: Any) -> LlamaLM:
    """Test-sized llama (GQA 4 heads / 2 KV heads)."""
    del seq_len
    return LlamaLM(
        LlamaConfig(vocab_size=vocab_size,
                    **{"hidden_size": 64, "num_layers": 2, "num_heads": 4,
                       "num_kv_heads": 2, "intermediate_size": 128,
                       **overrides}), dtype=dtype)
