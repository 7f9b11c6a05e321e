"""The one attention-impl dispatch shared by the transformer families
(models/gpt.py, models/llama.py).

Counterpart of ``distributeddeeplearning_tpu/ops/attention.py``:
dropout(softmax(QK^T * d^-1/2 + mask)) V with a key-padding mask, optionally
causal.

- ``dense``: materialized (S, S) scores, f32 softmax.
- ``flash``: the CUDA flash kernels (ops/flash_attention.py), forward and
  backward; their plain versions on CPU tensors.
- ``ring`` / ``zigzag`` need the ``seq`` mesh axis and come with the
  sequence-parallel slice.

Attention-probability dropout, in training only, uses one counter-based
hash mask keyed on global (batch·head, query, key) coordinates
(ops/hash_dropout.py): dense materializes it, flash regenerates it inside
its kernels, and both realize the same mask for the same seed.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from distributeddeeplearning_tpu_torch.ops.flash_attention import (
    flash_attention)
from distributeddeeplearning_tpu_torch.ops.hash_dropout import (
    dense_keep_mask)
from distributeddeeplearning_tpu_torch.ops.masks import block_causal_mask


def draw_seed(rng: torch.Generator) -> int:
    """An int32 dropout seed drawn from ``rng`` (a host read when ``rng``
    lives on the CPU, so drawing never waits for the device)."""
    return int(torch.randint(-2 ** 31, 2 ** 31, (), generator=rng,
                             device=rng.device))


def multihead_attention(q, k, v, pad_mask, *, impl: str, causal: bool,
                        dtype: torch.dtype, dropout_rate: float = 0.0,
                        dropout_rng: Optional[Union[int, torch.Generator]]
                        = None, training: bool = False):
    """q/k/v: (B, S, H, D); pad_mask: (B, S) bool (True = attend) or None.

    Returns (B, S, H*D) in ``dtype``. ``dropout_rate`` is the
    attention-probability dropout rate, applied only when ``training``;
    ``dropout_rng`` is required then: an explicit int32 seed, or a
    ``torch.Generator`` from which one is drawn.
    """
    b, s, h, d = q.shape
    if pad_mask is None:
        pad_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    pad_mask = pad_mask.bool()

    rate = float(dropout_rate) if training else 0.0
    seed = None
    if rate > 0.0:
        if dropout_rng is None:
            raise ValueError(
                f"attention-probability dropout (dropout_rate "
                f"{dropout_rate}) needs dropout_rng: an int32 seed or a "
                f"torch.Generator")
        seed = (draw_seed(dropout_rng)
                if isinstance(dropout_rng, torch.Generator)
                else int(dropout_rng))

    if impl == "flash":
        out = flash_attention(q, k, v, pad_mask, causal=causal,
                              dropout_rate=rate, dropout_seed=seed)
    elif impl in ("ring", "zigzag"):
        raise NotImplementedError(
            f"attention_impl={impl!r} shards the sequence over the 'seq' "
            f"mesh axis, which comes with the sequence-parallel slice; use "
            f"'dense' or 'flash'")
    elif impl == "dense":
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
        keep = pad_mask[:, None, None, :]
        if causal:
            keep = keep & block_causal_mask(0, 0, s, s, device=q.device)
        scores = scores.float().masked_fill(~keep,
                                            torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1).to(dtype)
        if rate > 0.0:
            km = dense_keep_mask(seed, b, h, s, s, rate, device=q.device)
            probs = torch.where(km, probs * (1.0 / (1.0 - rate)),
                                torch.zeros((), dtype=probs.dtype,
                                            device=q.device))
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    else:
        raise ValueError(f"unknown attention_impl {impl!r}")
    return out.reshape(b, s, h * d)
