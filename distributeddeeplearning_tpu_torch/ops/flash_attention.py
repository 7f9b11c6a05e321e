"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``distributeddeeplearning_tpu/ops/flash_attention.py``. The
Pallas forward kernel ``_fwd_kernel`` becomes the hand-written Hopper kernel
``csrc/flash_attention_fwd.cu`` (see the note at its top for what bounds it
and what its design does about that). The backward kernels and in-kernel
dropout belong to the training slice.

Dispatch follows the tensor: a CPU tensor takes :func:`flash_attention_reference`,
a CUDA tensor launches the kernel or raises. Nothing falls back.

``launches`` counts kernel launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.ops._build import load_library
from distributeddeeplearning_tpu_torch.ops.masks import block_causal_mask

SOURCE = "flash_attention_fwd.cu"
_NEG = -1e30  # masked-score value of the TPU kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535

launches = 0


def flash_attention_reference(q, k, v, kv_mask=None, causal: bool = False):
    """Plain PyTorch flash semantics: returns (o, lse).

    q/k/v (B, S, H, D); kv_mask (B, S) nonzero = attend, or None. Masked
    scores are -1e30 and their probabilities zeroed, so a fully masked row
    gives o = 0 and lse = 0 (the dense impl would average it uniformly
    instead). Scores and sums are f32; p is rounded to v's dtype before the
    P.V product, as the TPU kernel feeds its matrix unit. o is in q's dtype,
    lse (B, H, S) f32.
    """
    b, s, h, d = q.shape
    if kv_mask is None:
        kv_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    valid = (kv_mask != 0)[:, None, None, :]
    if causal:
        valid = valid & block_causal_mask(0, 0, s, s, device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    scores = scores.masked_fill(~valid, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = l.clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = (o / safe_l).transpose(1, 2).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l), 0.0)[..., 0]
    return o, lse


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = load_library(SOURCE).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _error_string(code: int) -> str:
    fn = load_library(SOURCE).flash_attention_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def flash_attention_cuda(q, k, v, kv_mask, causal: bool):
    """Launch the CUDA kernel: (o, lse) as :func:`flash_attention_reference`.

    Takes exactly what the kernel takes and raises on anything else: q/k/v
    (B, S, H, D) CUDA tensors of one dtype (float32 or bfloat16) with a
    contiguous head dim and D in {64, 128}; kv_mask contiguous int32 (B, S).
    Launches on the current stream without synchronising.
    """
    global launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, S, H, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: the "
                        f"kernel takes one of {list(_DTYPES)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel is built for {_HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("q/k/v need a contiguous head dim (stride 1)")
    if (kv_mask.dtype != torch.int32 or kv_mask.shape != (b, s)
            or not kv_mask.is_contiguous()):
        raise ValueError(f"kv_mask must be contiguous int32 {(b, s)}; got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid's {_MAX_GRID_Y}")
    dev = q.device
    for name, x in (("q", q), ("k", k), ("v", v), ("kv_mask", kv_mask)):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernel needs every "
                             f"operand on one CUDA device ({dev})")
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    if b * s * h == 0:
        return o, lse
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3])
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_mask.data_ptr(),
                o.data_ptr(), lse.data_ptr(), ctypes.addressof(strides),
                b, s, h, d, _DTYPES[q.dtype], int(causal), d ** -0.5, stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{rc} ({_error_string(rc)})")
    launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, kv_mask=None, *, causal: bool = False):
    """(o, lse): the kernel for CUDA tensors, the plain version for CPU ones.

    q/k/v (B, S, H, D); kv_mask (B, S) nonzero = attend, or None for all
    valid. o (B, S, H, D) in q's dtype, lse (B, H, S) f32.
    """
    b, s = q.shape[:2]
    if kv_mask is None:
        kv_mask = torch.ones((b, s), dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, causal)
    return flash_attention_cuda(q, k, v, kv_mask.to(torch.int32).contiguous(),
                                causal)


def flash_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False):
    """Fused attention with a key-padding mask; ``causal=True`` adds the
    autoregressive triangle (and skips key tiles above the diagonal).
    q/k/v (B, S, H, D) -> (B, S, H, D) in q's dtype."""
    return flash_attention_fwd(q, k, v, kv_mask, causal=causal)[0]
