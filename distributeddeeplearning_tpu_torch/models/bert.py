"""BERT encoder and masked-LM head in PyTorch.

Counterpart of ``distributeddeeplearning_tpu/models/bert.py``: word,
position and type embeddings summed in float32 and normalised, post-LN
encoder layers (exact GELU, LayerNorm eps 1e-12) whose self-attention runs
non-causally under a key-padding mask (``ops/attention.py``: dense, or the
flash kernels), and the MLM head: transform, GELU, LayerNorm and the
decoder tied to the word embeddings (``h @ word_embeddings.T``) plus
``mlm_bias``. With ``masked_positions`` (B, P) only those positions go
through the head (the gather head). Module and parameter names follow the
flax tree, so ``utils/weights.py`` carries a JAX checkpoint across by
renaming alone.

Parameters are float32 masters; activations run in the compute ``dtype``
(models/layers.py), as flax's ``param_dtype=float32, dtype=...``. In
training mode the embeddings, both residual branches and the attention
probabilities take dropout at ``dropout_rate``, with randomness drawn from
``rng=``: each layer draws one seed from it for a generator of its own, so
a layer under ``remat`` (``torch.utils.checkpoint``) drops the same values
when its forward is recomputed.

The mixture-of-experts FFN, the pipelined encoder and ring attention of
the JAX model come with later slices of the port and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributeddeeplearning_tpu_torch.models.layers import (
    Dense, LayerNorm, dropout, training_rng)
from distributeddeeplearning_tpu_torch.ops.attention import (
    draw_seed, multihead_attention)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12
    attention_impl: str = "dense"   # dense | flash (the CUDA kernels)
    # Carried only to be refused: MoE layers and pipeline stages come with
    # later slices (``check_carried``).
    num_experts: int = 0
    pipeline_stages: int = 1
    # Recompute each encoder layer's activations in the backward pass.
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def check_carried(cfg: BertConfig) -> None:
    """Raise on a BERT configuration the port does not carry yet, naming
    the slice that brings it."""
    if cfg.num_experts > 0:
        raise ValueError(
            f"BERT with num_experts={cfg.num_experts}: the mixture-of-"
            f"experts FFN (expert parallelism) comes with a later slice of "
            f"the port (mixture-of-experts models)")
    if cfg.pipeline_stages > 1:
        raise ValueError(
            f"BERT with pipeline_stages={cfg.pipeline_stages}: the "
            f"pipelined encoder comes with a later slice of the port "
            f"(pipeline parallelism)")
    if cfg.attention_impl in ("ring", "zigzag"):
        raise ValueError(
            f"BERT with attention_impl={cfg.attention_impl!r}: ring "
            f"attention shards the sequence over the 'seq' mesh axis, which "
            f"comes with the sequence-parallel slice; use 'dense' or "
            f"'flash'")


class SelfAttention(nn.Module):
    """Separate ``query``, ``key`` and ``value`` projections, whose (B, S,
    H*D) outputs are viewed as (B, S, H, D) heads without a copy, then the
    non-causal attention and the ``output`` projection."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.query = Dense(h, h, dtype)
        self.key = Dense(h, h, dtype)
        self.value = Dense(h, h, dtype)
        self.output = Dense(h, h, dtype)

    def forward(self, x, pad_mask, rng: Optional[torch.Generator] = None):
        cfg = self.cfg
        b, s, _ = x.shape
        shape = (b, s, cfg.num_heads, cfg.head_dim)
        q = self.query(x).view(shape)
        k = self.key(x).view(shape)
        v = self.value(x).view(shape)
        out = multihead_attention(
            q, k, v, pad_mask, impl=cfg.attention_impl, causal=False,
            dtype=x.dtype, dropout_rate=cfg.dropout_rate, dropout_rng=rng,
            training=rng is not None)
        return self.output(out)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer: LN(x + Attn(x)), then LN(x + MLP(x))."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype):
        super().__init__()
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.rate = cfg.dropout_rate
        self.attention = SelfAttention(cfg, dtype)
        self.attention_ln = LayerNorm(h, eps, dtype)
        self.intermediate = Dense(h, cfg.intermediate_size, dtype)
        self.mlp_output = Dense(cfg.intermediate_size, h, dtype)
        self.mlp_ln = LayerNorm(h, eps, dtype)

    def forward(self, x, pad_mask, rng: Optional[torch.Generator] = None):
        attn = dropout(self.attention(x, pad_mask, rng), self.rate, rng)
        x = self.attention_ln(x + attn)
        h = F.gelu(self.intermediate(x))
        h = dropout(self.mlp_output(h), self.rate, rng)
        return self.mlp_ln(x + h)


class BertMLM(nn.Module):
    """Encoder, transform and tied decoder; returns f32 logits of shape
    (B, S, vocab), or (B, P, vocab) when ``masked_positions`` (B, P) selects
    the gather head. ``dtype`` is the compute dtype; parameters are
    float32."""

    def __init__(self, cfg: BertConfig, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        check_carried(cfg)
        self.cfg = cfg
        self.compute_dtype = dtype
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, h))
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_position, h))
        self.type_embeddings = nn.Parameter(
            torch.empty(cfg.type_vocab_size, h))
        self.embeddings_ln = LayerNorm(h, eps, dtype)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, dtype) for _ in range(cfg.num_layers))
        self.mlm_transform = Dense(h, h, dtype)
        self.mlm_ln = LayerNorm(h, eps, dtype)
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        """The JAX model's initializers: N(0, 0.02) tables and kernels,
        zero biases (``mlm_bias`` too), unit LayerNorm scales."""
        for table in (self.word_embeddings, self.position_embeddings,
                      self.type_embeddings):
            nn.init.normal_(table, std=0.02)
        nn.init.zeros_(self.mlm_bias)
        for m in self.modules():
            if isinstance(m, Dense):
                nn.init.normal_(m.weight, std=0.02)
                nn.init.zeros_(m.bias)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                masked_positions=None, *,
                rng: Optional[torch.Generator] = None):
        """``attention_mask`` (B, S) nonzero = a real token (None: all);
        ``rng``: the CPU generator the dropout sites draw from, required in
        training mode with a positive ``dropout_rate``."""
        cfg = self.cfg
        rng = training_rng(self, cfg.dropout_rate, rng)
        b, s = input_ids.shape
        if s > cfg.max_position:
            raise ValueError(
                f"sequence length {s} exceeds max_position "
                f"{cfg.max_position}; build the model with seq_len={s}")
        pad_mask = (None if attention_mask is None
                    else attention_mask.bool())
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        # Summed in f32, then cast, as the JAX model does.
        x = (F.embedding(input_ids, self.word_embeddings)
             + self.position_embeddings[None, :s]
             + F.embedding(token_type_ids, self.type_embeddings))
        x = self.embeddings_ln(x.to(self.compute_dtype))
        x = dropout(x, cfg.dropout_rate, rng)
        for layer in self.layers:
            seed = None if rng is None else draw_seed(rng)
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(_layer_forward, layer, x, pad_mask, seed,
                               use_reentrant=False)
            else:
                x = _layer_forward(layer, x, pad_mask, seed)
        if masked_positions is not None:
            # Every head op is per position, so gathering before the head
            # equals gathering the dense logits after it.
            x = torch.take_along_dim(x, masked_positions.long()[..., None],
                                     dim=1)
        h = F.gelu(self.mlm_transform(x))
        h = self.mlm_ln(h)
        logits = h @ self.word_embeddings.to(self.compute_dtype).t()
        return logits.float() + self.mlm_bias


def _layer_forward(layer: EncoderLayer, x, pad_mask, seed: Optional[int]):
    """``layer`` on x with dropout drawn from a generator seeded by
    ``seed`` (None: no dropout), made here so a recompute draws alike."""
    rng = None if seed is None else torch.Generator().manual_seed(seed)
    return layer(x, pad_mask, rng)


def _fit_positions(cfg: BertConfig, seq_len: Optional[int]) -> BertConfig:
    """Grow the position table when the run's sequence outsizes it; the
    canonical table (and so the canonical parameter count) is kept
    otherwise."""
    if seq_len and seq_len > cfg.max_position:
        cfg = dataclasses.replace(cfg, max_position=seq_len)
    return cfg


def bert_base_mlm(vocab_size: int = 30522,
                  dtype: torch.dtype = torch.bfloat16,
                  seq_len: Optional[int] = None, **overrides: Any) -> BertMLM:
    """BERT-base geometry (12L/768H/12 heads, 3072 MLP, 512 positions)."""
    cfg = BertConfig(vocab_size=vocab_size, **overrides)
    return BertMLM(_fit_positions(cfg, seq_len), dtype=dtype)


def bert_large_mlm(vocab_size: int = 30522,
                   dtype: torch.dtype = torch.bfloat16,
                   seq_len: Optional[int] = None,
                   **overrides: Any) -> BertMLM:
    cfg = BertConfig(vocab_size=vocab_size,
                     **{"hidden_size": 1024, "num_layers": 24,
                        "num_heads": 16, "intermediate_size": 4096,
                        **overrides})
    return BertMLM(_fit_positions(cfg, seq_len), dtype=dtype)


def tiny_bert_mlm(vocab_size: int = 1024, dtype: torch.dtype = torch.float32,
                  seq_len: Optional[int] = None,
                  **overrides: Any) -> BertMLM:
    """Test-sized BERT (2 layers, 64 wide, 4 heads)."""
    cfg = BertConfig(vocab_size=vocab_size,
                     **{"hidden_size": 64, "num_layers": 2, "num_heads": 4,
                        "intermediate_size": 128, "max_position": 128,
                        **overrides})
    return BertMLM(_fit_positions(cfg, seq_len), dtype=dtype)
