"""Counter-based dropout masks for attention probabilities.

Counterpart of ``distributeddeeplearning_tpu/ops/hash_dropout.py``, bit for
bit. ``keep(b·h, row, col)`` is a pure hash of the global coordinates and a
per-call seed, so the flash backward kernels regenerate the forward's mask
from their tile indices, and the dense and flash impls realize the same mask
for the same seed.

Torch has no full uint32 arithmetic, so the hash runs on int64 tensors that
hold uint32 values: every product is split into 16-bit halves so that it
never leaves int64, and its low 32 bits are kept. The CUDA kernels
(``csrc/flash_attention_{fwd,bwd}.cu``) compute the same function with
native ``uint32_t`` arithmetic.
"""

from __future__ import annotations

import torch

# Odd 32-bit constants for the coordinate combine and the murmur3 finalizer
# multipliers (the JAX module's).
_C_ROW = 0x9E3779B9
_C_COL = 0x85EBCA6B
_C_BH = 0xC2B2AE35
_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_U32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for int64 h in [0, 2^32): each partial product
    stays below 2^49."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer: full avalanche on uint32."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int64) & _U32


def _keep(h: torch.Tensor, rate: float) -> torch.Tensor:
    """h (uint32 values) -> the uniform float32(h) * 2^-32 in float32,
    compared with float32(rate)."""
    u = h.to(torch.float32) * torch.tensor(2.0 ** -32, dtype=torch.float32)
    return u >= torch.tensor(rate, dtype=torch.float32)


def keep_mask(seed: int, bh, rows, cols, rate: float) -> torch.Tensor:
    """Boolean keep-mask: True with probability ``1 - rate``.

    seed: an int32 (or uint32) whose bits are taken as uint32; bh/rows/cols:
    broadcastable integer tensors of GLOBAL batch·head / query / key
    coordinates, as the JAX function takes them.
    """
    h = (_mul32(_u32(rows), _C_ROW) ^ _mul32(_u32(cols), _C_COL)
         ^ _mul32(_u32(bh), _C_BH))
    return _keep(_mix32(h ^ (int(seed) & _U32)), rate)


def dense_keep_mask(seed: int, b: int, h: int, s_q: int, s_k: int,
                    rate: float, *, device=None, bh_offsets=None
                    ) -> torch.Tensor:
    """(B, H, Sq, Sk) keep-mask in global coordinates: the materialized form
    for the dense impl and the plain flash versions. ``bh_offsets`` =
    (b_start, h_start, h_total) places this (batch, head) range in a larger
    global one, as the flash kernels' offsets do; None is the identity.

    Built one (batch, head) plane at a time over the shared row/column
    term, so the int64 temporaries stay (Sq, Sk) at any batch and head
    count."""
    b_start, h_start, h_total = bh_offsets or (0, 0, h)
    rows = torch.arange(s_q, device=device)[:, None]
    cols = torch.arange(s_k, device=device)[None, :]
    rc = _mul32(rows, _C_ROW) ^ _mul32(cols, _C_COL)
    out = torch.empty((b, h, s_q, s_k), dtype=torch.bool, device=device)
    for bi in range(b):
        for hi in range(h):
            bh = (b_start + bi) * h_total + h_start + hi
            term = ((bh * _C_BH) ^ int(seed)) & _U32
            out[bi, hi] = _keep(_mix32(rc ^ term), rate)
    return out
