"""Attention-mask helpers shared by the plain attention paths.

Counterpart of ``distributeddeeplearning_tpu/ops/masks.py``; the dense impl
and the plain flash version take their causal triangle from here. The CUDA
flash kernel applies the same triangle with a bounds check per score.
"""

from __future__ import annotations

import torch


def block_causal_mask(q_block: int, k_block: int, sq: int, sk: int, *,
                      device=None) -> torch.Tensor:
    """(sq, sk) bool: global kv position <= global q position, for the
    query block at index ``q_block`` (rows sized sq) against the key block
    at index ``k_block`` (cols sized sk)."""
    qpos = q_block * sq + torch.arange(sq, device=device)[:, None]
    kpos = k_block * sk + torch.arange(sk, device=device)[None, :]
    return kpos <= qpos
