"""The one attention-impl dispatch shared by the transformer families
(models/gpt.py, models/llama.py).

Counterpart of ``distributeddeeplearning_tpu/ops/attention.py``:
softmax(QK^T * d^-1/2 + mask) V with a key-padding mask, optionally causal.

- ``dense``: materialized (S, S) scores, f32 softmax.
- ``flash``: the CUDA flash forward kernel (ops/flash_attention.py); its
  plain version on CPU tensors.
- ``ring`` / ``zigzag`` need the ``seq`` mesh axis and come with the
  sequence-parallel slice.

Attention-probability dropout is training-only and comes with the training
slice: a positive rate in training mode raises.
"""

from __future__ import annotations

import torch

from distributeddeeplearning_tpu_torch.ops.flash_attention import (
    flash_attention)
from distributeddeeplearning_tpu_torch.ops.masks import block_causal_mask


def multihead_attention(q, k, v, pad_mask, *, impl: str, causal: bool,
                        dtype: torch.dtype, dropout_rate: float = 0.0,
                        training: bool = False):
    """q/k/v: (B, S, H, D); pad_mask: (B, S) bool (True = attend) or None.

    Returns (B, S, H*D) in ``dtype``.
    """
    b, s, h, d = q.shape
    if training and dropout_rate > 0.0:
        raise NotImplementedError(
            f"attention-probability dropout (rate {dropout_rate}) is "
            f"training-only and comes with the training slice; call the "
            f"model in eval mode")
    if pad_mask is None:
        pad_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    pad_mask = pad_mask.bool()

    if impl == "flash":
        out = flash_attention(q, k, v, pad_mask, causal=causal)
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
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    else:
        raise ValueError(f"unknown attention_impl {impl!r}")
    return out.reshape(b, s, h * d)
