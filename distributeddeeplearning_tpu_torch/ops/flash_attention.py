"""Flash attention: the CUDA kernels' wrappers, their plain versions and the
autograd function that joins them.

Counterpart of ``distributeddeeplearning_tpu/ops/flash_attention.py``. The
Pallas kernels become hand-written Hopper kernels (see the notes at the top
of each source for what bounds them and what their design does about that):

- ``_fwd_kernel`` -> ``csrc/flash_attention_fwd.cu`` (o and the row lse);
- ``_dq_kernel`` and ``_dkv_kernel`` -> ``csrc/flash_attention_bwd.cu``.

All three are bound by their S^2 * D products at training lengths. In bf16
they run those on the tensor cores (wgmma, one warpgroup per 64-row tile,
p_drop and ds fed from registers), stage bf16 tiles through a cp.async
ring and schedule the heaviest causal tiles first; every row of
q, k, v and do must start on 16 bytes. In f32 (sampling, and the f32
reference steps) they stay f32 FMAs on the CUDA cores, so the outputs and
gradients keep f32 accuracy.

Attention-probability dropout runs inside the kernels through the
counter-based hash of ``ops/hash_dropout.py``: the backward kernels
regenerate the forward's mask, and no (S, S) mask exists on the kernel path.

Dispatch follows the tensor: a CPU tensor takes the plain version
(:func:`flash_attention_reference`, :func:`flash_attention_bwd_reference`),
a CUDA tensor launches the kernel or raises. Nothing falls back.

``launches``, ``dq_launches`` and ``dkv_launches`` count kernel launches, so
a run can show that its path went through each kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.ops._build import load_library
from distributeddeeplearning_tpu_torch.ops.hash_dropout import (
    dense_keep_mask)
from distributeddeeplearning_tpu_torch.ops.masks import block_causal_mask

SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
_NEG = -1e30  # masked-score value of the TPU kernels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_GRID_Y = 65535

launches = 0       # flash_attention_fwd.cu
dq_launches = 0    # flash_attention_bwd.cu, the dq kernel
dkv_launches = 0   # flash_attention_bwd.cu, the dk/dv kernel


def _dropout(rate: float, seed, heads: int, bh_offsets) -> tuple:
    """(rate, inv_keep, seed bits, b_start, h_start, h_total) as the kernels
    take them; raises on a positive rate without a seed, as JAX does."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate {rate} must lie in [0, 1)")
    if rate > 0.0 and seed is None:
        raise ValueError("flash_attention: dropout_rate > 0 needs a "
                         "dropout_seed (int32 scalar)")
    b_start, h_start, h_total = (bh_offsets if bh_offsets is not None
                                 else (0, 0, heads))
    return (rate, 1.0 / (1.0 - rate), int(seed or 0) & 0xFFFFFFFF,
            int(b_start), int(h_start), int(h_total))


def _scores_and_valid(q, k, kv_mask, causal: bool):
    """(B, H, S, S) f32 scaled scores masked to -1e30, and the valid mask."""
    b, s, h, d = q.shape
    if kv_mask is None:
        kv_mask = torch.ones((b, s), dtype=torch.bool, device=q.device)
    valid = (kv_mask != 0)[:, None, None, :]
    if causal:
        valid = valid & block_causal_mask(0, 0, s, s, device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
    return scores.masked_fill(~valid, _NEG), valid


def _keep(q, rate: float, seed, bh_offsets):
    """The (B, H, S, S) keep-mask of this call, or None without dropout."""
    if rate <= 0.0:
        return None
    b, s, h, _ = q.shape
    return dense_keep_mask(seed, b, h, s, s, rate, device=q.device,
                           bh_offsets=bh_offsets)


def flash_attention_reference(q, k, v, kv_mask=None, causal: bool = False,
                              dropout_rate: float = 0.0, dropout_seed=None,
                              bh_offsets=None):
    """Plain PyTorch flash semantics: returns (o, lse).

    q/k/v (B, S, H, D); kv_mask (B, S) nonzero = attend, or None. Masked
    scores are -1e30 and their probabilities zeroed, so a fully masked row
    gives o = 0 and lse = 0 (the dense impl would average it uniformly
    instead). Scores and sums are f32; l sums the undropped p, and the
    P.V product takes keep ? p / (1 - rate) : 0 rounded to v's dtype, as the
    TPU kernel feeds its matrix unit. o is in q's dtype, lse (B, H, S) f32.
    """
    rate, inv_keep, *_ = _dropout(dropout_rate, dropout_seed, q.shape[2],
                                  bh_offsets)
    scores, valid = _scores_and_valid(q, k, kv_mask, causal)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep(q, rate, dropout_seed, bh_offsets)
    if keep is not None:
        p = torch.where(keep, p * inv_keep, 0.0)
    safe_l = l.clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = (o / safe_l).transpose(1, 2).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l), 0.0)[..., 0]
    return o, lse


def _delta(do, o):
    """sum(do * o) over the head dim in f32, (B, H, S) contiguous: plain
    torch on both paths, as the TPU wrapper computes it outside its kernels."""
    return (do.float() * o.float()).sum(dim=-1).transpose(1, 2).contiguous()


def _bwd_terms(q, k, v, kv_mask, lse, do, delta, causal, rate, seed,
               bh_offsets):
    """(p_drop, ds), (B, H, S, S) f32: p = exp(s - lse) recomputed from the
    forward's lse, dp = do.v^T, both dropped by the regenerated mask, and
    ds = p * (dp - delta) * scale."""
    rate, inv_keep, *_ = _dropout(rate, seed, q.shape[2], bh_offsets)
    scores, _ = _scores_and_valid(q, k, kv_mask, causal)
    p = torch.exp(scores - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    keep = _keep(q, rate, seed, bh_offsets)
    p_drop = p
    if keep is not None:
        dp = torch.where(keep, dp * inv_keep, 0.0)
        p_drop = torch.where(keep, p * inv_keep, 0.0)
    return p_drop, p * (dp - delta[..., None]) * q.shape[-1] ** -0.5


def _dq(ds, q, k):
    """ds rounded to k's dtype, then ds.k in f32, in q's dtype."""
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def _dkv(p_drop, ds, q, k, v, do):
    """ds rounded to q's dtype and p_drop to do's, then ds^T.q and
    p_drop^T.do in f32, in k's and v's dtypes."""
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p_drop.to(do.dtype).float(),
                      do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_dq_reference(q, k, v, kv_mask, lse, do, delta,
                                 causal: bool = False,
                                 dropout_rate: float = 0.0,
                                 dropout_seed=None, bh_offsets=None):
    """Plain PyTorch version of the dq kernel: dq from the forward's lse and
    ``delta`` (:func:`_delta`)."""
    _, ds = _bwd_terms(q, k, v, kv_mask, lse, do, delta, causal,
                       dropout_rate, dropout_seed, bh_offsets)
    return _dq(ds, q, k)


def flash_attention_dkv_reference(q, k, v, kv_mask, lse, do, delta,
                                  causal: bool = False,
                                  dropout_rate: float = 0.0,
                                  dropout_seed=None, bh_offsets=None):
    """Plain PyTorch version of the dk/dv kernel: (dk, dv)."""
    p_drop, ds = _bwd_terms(q, k, v, kv_mask, lse, do, delta, causal,
                            dropout_rate, dropout_seed, bh_offsets)
    return _dkv(p_drop, ds, q, k, v, do)


def flash_attention_bwd_reference(q, k, v, kv_mask, o, lse, do,
                                  causal: bool = False,
                                  dropout_rate: float = 0.0,
                                  dropout_seed=None, bh_offsets=None):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv).

    Recomputes p = exp(s - lse) from the forward's lse, regenerates the
    dropout mask, and rounds where the TPU kernels do: ds to k's (and q's)
    dtype before ds.k and ds^T.q, p_drop to do's dtype before p_drop^T.do.
    Products accumulate in f32; the gradients come back in q/k/v's dtypes.
    """
    p_drop, ds = _bwd_terms(q, k, v, kv_mask, lse, do, _delta(do, o), causal,
                            dropout_rate, dropout_seed, bh_offsets)
    return (_dq(ds, q, k), *_dkv(p_drop, ds, q, k, v, do))


@functools.lru_cache(maxsize=None)
def _fn(source: str, name: str, pointers: int):
    """A C entry point of ``csrc/<source>``: ``pointers`` void* arguments,
    then B, S, H, D, dtype, causal, scale, the dropout arguments and the
    stream, as every flash entry point takes them."""
    fn = getattr(load_library(source), name)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 3 + [ctypes.c_uint32]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _error_string(source: str, code: int) -> str:
    fn = load_library(source).flash_attention_error_string
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return fn(code).decode()


def _check(q, k, v, kv_mask, **more) -> None:
    """Raise on anything the kernels do not take: q/k/v and ``more`` (B, S,
    H, D) CUDA tensors of one dtype (float32 or bfloat16) with a contiguous
    head dim and D in {64, 128}; kv_mask contiguous int32 (B, S)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one (B, S, H, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    tensors = {"q": q, "k": k, "v": v, **more}
    if q.dtype not in _DTYPES or any(x.dtype != q.dtype
                                     for x in tensors.values()):
        raise TypeError(f"dtypes {[str(x.dtype) for x in tensors.values()]}: "
                        f"the kernels take one of {list(_DTYPES)}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernels are built for "
                         f"{_HEAD_DIMS}")
    for name, x in more.items():
        if x.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, not "
                             f"{tuple(q.shape)}")
    if any(x.stride(-1) != 1 for x in tensors.values()):
        raise ValueError("q/k/v need a contiguous head dim (stride 1)")
    if (kv_mask.dtype != torch.int32 or kv_mask.shape != (b, s)
            or not kv_mask.is_contiguous()):
        raise ValueError(f"kv_mask must be contiguous int32 {(b, s)}; got "
                         f"{kv_mask.dtype} {tuple(kv_mask.shape)}")
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B*H = {b * h} exceeds the grid's {_MAX_GRID_Y}")
    dev = q.device
    for name, x in {**tensors, "kv_mask": kv_mask}.items():
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {x.device}; the kernel needs every "
                             f"operand on one CUDA device ({dev})")


def _strides(*tensors) -> ctypes.Array:
    """(batch, seq, head) element strides of each tensor in turn."""
    flat = [st for x in tensors for st in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _launch(source: str, name: str, pointers, strides, shape, dtype,
            causal: bool, drop: tuple, device) -> None:
    b, s, h, d = shape
    rate, inv_keep, seed, b_start, h_start, h_total = drop
    fn = _fn(source, name, len(pointers) + 1)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*pointers, ctypes.addressof(strides), b, s, h, d,
                _DTYPES[dtype], int(causal), d ** -0.5, rate, inv_keep, seed,
                b_start, h_start, h_total, stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({_error_string(source, rc)})")


def flash_attention_cuda(q, k, v, kv_mask, causal: bool,
                         dropout_rate: float = 0.0, dropout_seed=None,
                         bh_offsets=None):
    """Launch the forward kernel: (o, lse) as :func:`flash_attention_reference`.

    Takes exactly what the kernel takes and raises on anything else (see
    :func:`_check`; in bf16 also on a row of q, k or v off 16 bytes).
    Launches on the current stream without synchronising.
    """
    global launches
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v)
    _check(q, k, v, kv_mask)
    drop = _dropout(dropout_rate, dropout_seed, q.shape[2], bh_offsets)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if b * s * h == 0:
        return o, lse
    _launch(SOURCE, "flash_attention_fwd",
            [x.data_ptr() for x in (q, k, v, kv_mask, o, lse)],
            _strides(q, k, v, o), q.shape, q.dtype, causal, drop, q.device)
    launches += 1
    return o, lse


def _check_rows_aligned(**tensors) -> None:
    """Raise unless every (batch, seq, head) row of each bf16 tensor starts
    on 16 bytes: the tensor-core kernels copy rows into shared memory with
    cp.async, 16 bytes a thread. Strides of size-1 dims are never followed,
    so they are not checked."""
    for name, x in tensors.items():
        strides = [st for st, n in zip(x.stride()[:3], x.shape[:3]) if n > 1]
        if x.data_ptr() % 16 or any(st % 8 for st in strides):
            raise ValueError(
                f"{name}: the bf16 flash kernels need every row on 16 "
                f"bytes (data_ptr % 16 == 0, batch/seq/head strides % 8 == "
                f"0); got data_ptr % 16 = {x.data_ptr() % 16}, strides "
                f"{tuple(x.stride())}")


def _check_bwd(q, k, v, kv_mask, lse, do, delta) -> None:
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v, do=do)
    _check(q, k, v, kv_mask, do=do)
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, x in (("lse", lse), ("delta", delta)):
        if (x.dtype != torch.float32 or x.shape != want
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name} must be contiguous f32 (B, H, S) = "
                             f"{want} on {q.device}; got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def flash_attention_dq_cuda(q, k, v, kv_mask, lse, do, delta, causal: bool,
                            dropout_rate: float = 0.0, dropout_seed=None,
                            bh_offsets=None):
    """Launch the dq kernel: dq as :func:`flash_attention_dq_reference`.
    Raises on what the kernel does not take (in bf16 also on a row of q, k,
    v or do off 16 bytes); launches on the current stream without
    synchronising."""
    global dq_launches
    _check_bwd(q, k, v, kv_mask, lse, do, delta)
    drop = _dropout(dropout_rate, dropout_seed, q.shape[2], bh_offsets)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    if q.numel() == 0:
        return dq
    _launch(BWD_SOURCE, "flash_attention_dq",
            [x.data_ptr() for x in (q, k, v, kv_mask, do, lse, delta, dq)],
            _strides(q, k, v, do, dq, dq), q.shape, q.dtype, causal, drop,
            q.device)
    dq_launches += 1
    return dq


def flash_attention_dkv_cuda(q, k, v, kv_mask, lse, do, delta, causal: bool,
                             dropout_rate: float = 0.0, dropout_seed=None,
                             bh_offsets=None):
    """Launch the dk/dv kernel: (dk, dv) as
    :func:`flash_attention_dkv_reference`."""
    global dkv_launches
    _check_bwd(q, k, v, kv_mask, lse, do, delta)
    drop = _dropout(dropout_rate, dropout_seed, q.shape[2], bh_offsets)
    dk, dv = (torch.empty_like(x, memory_format=torch.contiguous_format)
              for x in (k, v))
    if q.numel() == 0:
        return dk, dv
    _launch(BWD_SOURCE, "flash_attention_dkv",
            [x.data_ptr()
             for x in (q, k, v, kv_mask, do, lse, delta, dk, dv)],
            _strides(q, k, v, do, dk, dv), q.shape, q.dtype, causal, drop,
            q.device)
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, kv_mask, o, lse, do, causal: bool,
                             dropout_rate: float = 0.0, dropout_seed=None,
                             bh_offsets=None):
    """Launch the dq and dk/dv kernels: (dq, dk, dv) as
    :func:`flash_attention_bwd_reference`; ``o`` and ``lse`` are the
    forward's."""
    _check(q, k, v, kv_mask, o=o)
    delta = _delta(do, o)
    args = (q, k, v, kv_mask, lse, do, delta, causal, dropout_rate,
            dropout_seed, bh_offsets)
    return (flash_attention_dq_cuda(*args), *flash_attention_dkv_cuda(*args))


def _int_mask(q, kv_mask):
    b, s = q.shape[:2]
    if kv_mask is None:
        return torch.ones((b, s), dtype=torch.int32, device=q.device)
    return kv_mask.to(torch.int32).contiguous()


def flash_attention_fwd(q, k, v, kv_mask=None, *, causal: bool = False,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        bh_offsets=None):
    """(o, lse): the kernel for CUDA tensors, the plain version for CPU ones.

    q/k/v (B, S, H, D); kv_mask (B, S) nonzero = attend, or None for all
    valid. o (B, S, H, D) in q's dtype, lse (B, H, S) f32.
    """
    kv_mask = _int_mask(q, kv_mask)
    fn = (flash_attention_reference if q.device.type == "cpu"
          else flash_attention_cuda)
    return fn(q, k, v, kv_mask, causal, dropout_rate, dropout_seed,
              bh_offsets)


def flash_attention_bwd(q, k, v, kv_mask, o, lse, do, *, causal: bool = False,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        bh_offsets=None):
    """(dq, dk, dv): the kernels for CUDA tensors, the plain version for CPU
    ones. ``o`` and ``lse`` are the forward's; ``do`` the gradient of o."""
    kv_mask = _int_mask(q, kv_mask)
    fn = (flash_attention_bwd_reference if q.device.type == "cpu"
          else flash_attention_bwd_cuda)
    if do.stride(-1) != 1:
        do = do.contiguous()
    return fn(q, k, v, kv_mask, o, lse, do, causal, dropout_rate,
              dropout_seed, bh_offsets)


class _FlashAttention(torch.autograd.Function):
    """o = flash(q, k, v); its backward runs the dq and dk/dv kernels from
    the saved o and lse, as the TPU package's custom VJP does."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, dropout_rate, dropout_seed,
                bh_offsets):
        o, lse = flash_attention_fwd(q, k, v, kv_mask, causal=causal,
                                     dropout_rate=dropout_rate,
                                     dropout_seed=dropout_seed,
                                     bh_offsets=bh_offsets)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.attrs = (causal, dropout_rate, dropout_seed, bh_offsets)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        causal, rate, seed, offsets = ctx.attrs
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, o, lse, do,
                                         causal=causal, dropout_rate=rate,
                                         dropout_seed=seed,
                                         bh_offsets=offsets)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None, *,
                    causal: bool = False, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None, bh_offsets=None):
    """Fused attention with a key-padding mask; ``causal=True`` adds the
    autoregressive triangle (and skips key tiles above the diagonal).
    q/k/v (B, S, H, D) -> (B, S, H, D) in q's dtype, differentiable in
    q/k/v through the backward kernels.

    ``dropout_rate`` > 0 applies attention-probability dropout inside the
    kernels; ``dropout_seed`` (an int32, required then) keys the hash mask.
    ``bh_offsets`` = (b_start, h_start, h_total) places this call's (batch,
    head) range in global coordinates; None is the unsharded identity.
    """
    return _FlashAttention.apply(q, k, v, _int_mask(q, kv_mask), causal,
                                 float(dropout_rate), dropout_seed,
                                 bh_offsets)
