"""Matmul with a BatchNorm prologue and a statistics epilogue: the CUDA
kernels' wrappers, their plain versions and the autograd function that
joins them.

Counterpart of ``distributeddeeplearning_tpu/ops/fused_linear_bn.py``, the
bottleneck's 1x1 convolutions as matmuls over M = N*H*W rows. The three
Pallas kernels become hand-written Hopper kernels in
``csrc/fused_linear_bn.cu`` (see the note at its top for what bounds them
and what the design does about it):

- ``_fwd_kernel``    -> :func:`linear_bn_fwd`: y = a @ w^T with a =
  relu((x - mu) * (inv * gamma) + beta) (a = x with ``bn`` off), and the
  columns' sum(y) and sum(y^2) over y as stored;
- ``_bwd_dx_kernel`` -> :func:`linear_bn_bwd_dx`: dY = dy + ds + 2 y dss,
  da = dY @ w, and with ``bn`` dx, dbeta and dgamma through the prologue;
- ``_bwd_dw_kernel`` -> :func:`linear_bn_bwd_dw`: dw = dY^T @ a. In bf16
  it runs on the tensor cores (wgmma, TMA copies into swizzled shared
  memory, persistent blocks over fixed chunks of M); #8, #9 and every f32
  instance run on the mma.sync / FMA tile product of ``csrc/bn_gemm.cuh``.

Layouts: x is (M, K) and y (M, N), row-major: the (N*H*W, C) view of a
channels_last activation. The weight is the port's (N, K, 1, 1) convolution
weight viewed as (N, K) (the JAX package's (K, N) kernel transposed), and dw
comes back in that layout. The per-channel vectors are float32: mu, inv,
gamma, beta of the K input channels, ds and dss (the cotangents of the two
sums) of the N output channels. Every wrapper checks this and raises rather
than copying. Dispatch follows the tensor: a CPU tensor takes the plain
version (``*_reference``), a CUDA tensor launches the kernel or raises.
Nothing falls back.

``fwd_launches``, ``bwd_dx_launches`` and ``bwd_dw_launches`` count the
wrapper calls that launched a kernel (one count a call, though each also
launches a second, summing kernel).

The JAX wrappers' ``_tiles`` and their shard_map twins are TPU tiling and
tracing devices, not semantics, and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.ops._build import load_library

SOURCE = "fused_linear_bn.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

fwd_launches = 0     # linear_bn_fwd
bwd_dx_launches = 0  # linear_bn_bwd_dx
bwd_dw_launches = 0  # linear_bn_bwd_dw


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in PyTorch, in the same order
# ---------------------------------------------------------------------------

def _prologue(x, mu, inv, gamma, beta, relu: bool, bn: bool):
    """a = relu((x - mu) * (inv * gamma) + beta) in float32, rounded to
    x's dtype; x itself with ``bn`` off."""
    if not bn:
        return x
    a = (x.float() - mu) * (inv * gamma) + beta
    if relu:
        a = a.clamp_min(0.0)
    return a.to(x.dtype)


def _dy_total(dy, y, ds, dss):
    """dY = dy + ds + 2 y dss in float32, rounded to dy's dtype."""
    return (dy.float() + ds + 2.0 * y.float() * dss).to(dy.dtype)


def _col_sum(t: torch.Tensor) -> torch.Tensor:
    """A column sum of float32 terms taken in float64 and rounded to
    float32 once, as the kernels take their statistics."""
    return t.double().sum(dim=0).float()


def linear_bn_fwd_reference(x, mu, inv, gamma, beta, w, *, relu: bool,
                            bn: bool):
    """(y, sum(y), sum(y^2)): y = a @ w^T accumulated in float32 and
    rounded to x's dtype, the sums over y as stored."""
    a = _prologue(x, mu, inv, gamma, beta, relu, bn)
    y = (a.float() @ w.float().t()).to(x.dtype)
    yd = y.double()
    return y, _col_sum(yd), _col_sum(yd * yd)


def linear_bn_bwd_dx_reference(dy, y, ds, dss, w, x, mu, inv, gamma, beta,
                               *, relu: bool, bn: bool):
    """(dx, dbeta, dgamma): da = dY @ w in float32; with ``bn`` dz = da
    masked by xh * gamma + beta > 0 (``relu``), dx = dz * (gamma * inv) in
    x's dtype, dbeta = sum(dz), dgamma = sum(dz * xh) with xh = (x - mu) *
    inv. Without ``bn``, dx = da and the sums are None."""
    da = _dy_total(dy, y, ds, dss).float() @ w.float()
    if not bn:
        return da.to(x.dtype), None, None
    xh = (x.float() - mu) * inv
    dz = torch.where(xh * gamma + beta > 0, da, 0.0) if relu else da
    dx = (dz * (gamma * inv)).to(x.dtype)
    return dx, _col_sum(dz), _col_sum(dz.double() * xh)


def linear_bn_bwd_dw_reference(x, mu, inv, gamma, beta, dy, y, ds, dss, *,
                               relu: bool, bn: bool):
    """dw = dY^T @ a, (N, K), accumulated in float32 and rounded to dy's
    dtype."""
    a = _prologue(x, mu, inv, gamma, beta, relu, bn)
    dyt = _dy_total(dy, y, ds, dss)
    return (dyt.float().t() @ a.float()).to(dy.dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check(k: int, n: int, mats: dict, vecs: dict) -> None:
    """Raise on what the kernels (and, for the layout, the plain versions)
    do not take. K and N multiples of 8; ``mats``: {name: (tensor, (rows,
    cols))}, one dtype (float32 or bfloat16), each row-major; ``vecs``:
    {name: (tensor, length)}, float32 and contiguous. All on one device; on
    a CUDA device every operand 16-byte aligned."""
    if k % 8 or n % 8:
        raise ValueError(f"K = {k}, N = {n}: the kernels load 16 bytes a "
                         f"thread and need multiples of 8")
    first = next(iter(mats.values()))[0]
    if first.dtype not in _DTYPES:
        raise TypeError(f"dtype {first.dtype}: the kernels take one of "
                        f"{list(_DTYPES)}")
    for name, (t, shape) in mats.items():
        if t.dim() != 2 or tuple(t.shape) != shape or t.dtype != first.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}; expected "
                             f"{first.dtype} {shape}")
        rows, cols = shape
        if t.stride(1) != 1 or (rows > 1 and t.stride(0) != cols):
            raise ValueError(
                f"{name} has strides {t.stride()}: the matmul kernels take "
                f"row-major operands (the (N*H*W, C) view of a channels_last "
                f"tensor, the (N, K) view of a 1x1 weight) and do not copy")
    for name, (v, length) in vecs.items():
        if v.dtype != torch.float32 or tuple(v.shape) != (length,) \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 ({length},); "
                             f"got {v.dtype} {tuple(v.shape)}")
    tensors = {n: t for n, (t, _) in {**mats, **vecs}.items()}
    dev = first.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"the matmul kernels run on CUDA tensors (and their "
                         f"plain versions on CPU ones), not {dev}")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _bn_vecs(k: int, bn: bool, **vecs) -> dict:
    """The prologue's vectors to check: all of length K with ``bn``, none
    without (they are not read)."""
    return {n: (v, k) for n, v in vecs.items()} if bn else {}


@functools.lru_cache(maxsize=None)
def _fn(name: str, argtypes: tuple, restype=ctypes.c_int):
    """The C entry point ``name`` of ``csrc/fused_linear_bn.cu``."""
    fn = getattr(load_library(SOURCE), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _run(name: str, argtypes: tuple, *args) -> None:
    fn = _fn(name, argtypes + (_P,))
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc:
        err = _fn("flbn_error_string", (_I,), ctypes.c_char_p)
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def _f32(n: int, like: torch.Tensor, *lead: int) -> torch.Tensor:
    return torch.empty((*lead, n), dtype=torch.float32, device=like.device)


def linear_bn_fwd_cuda(x, mu, inv, gamma, beta, w, *, relu: bool, bn: bool):
    """Launch kernel #8: (y, sum, sumsq) as :func:`linear_bn_fwd_reference`."""
    global fwd_launches
    (m, k), n = x.shape, w.shape[0]
    splits = _fn("flbn_row_splits", (_L, _I))(m, n)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    work = torch.empty((2, splits, n), dtype=torch.float64, device=x.device)
    s, ss = _f32(n, x), _f32(n, x)
    with torch.cuda.device(x.device):
        _run("flbn_fwd", (_P,) * 10 + (_L, _I, _I, _I, _I, _I, _I),
             x.data_ptr(), w.data_ptr(), _ptr(mu), _ptr(inv), _ptr(gamma),
             _ptr(beta), y.data_ptr(), work.data_ptr(), s.data_ptr(),
             ss.data_ptr(), m, k, n, _DTYPES[x.dtype], int(relu), int(bn),
             splits)
    fwd_launches += 1
    return y, s, ss


def linear_bn_bwd_dx_cuda(dy, y, ds, dss, w, x, mu, inv, gamma, beta, *,
                          relu: bool, bn: bool):
    """Launch kernel #9: (dx, dbeta, dgamma) as
    :func:`linear_bn_bwd_dx_reference`."""
    global bwd_dx_launches
    (m, k), n = x.shape, w.shape[0]
    splits = _fn("flbn_row_splits", (_L, _I))(m, k)
    dx = torch.empty_like(x)
    work = torch.empty((2, splits, k), dtype=torch.float64,
                       device=x.device) if bn else None
    db, dg = (_f32(k, x), _f32(k, x)) if bn else (None, None)
    with torch.cuda.device(x.device):
        _run("flbn_bwd_dx", (_P,) * 14 + (_L, _I, _I, _I, _I, _I, _I),
             dy.data_ptr(), y.data_ptr(), ds.data_ptr(), dss.data_ptr(),
             w.data_ptr(), x.data_ptr(), _ptr(mu), _ptr(inv), _ptr(gamma),
             _ptr(beta), dx.data_ptr(), _ptr(work), _ptr(db), _ptr(dg), m, k,
             n, _DTYPES[x.dtype], int(relu), int(bn), splits)
    bwd_dx_launches += 1
    return dx, db, dg


def dw_splits(m: int, k: int, n: int, dtype: torch.dtype) -> int:
    """The number of chunks of M that kernel #10 sums separately (and then
    in order) at this shape; in bf16 it follows the card's SM count."""
    return _fn("flbn_dw_splits", (_L, _I, _I, _I))(m, k, n, _DTYPES[dtype])


def linear_bn_bwd_dw_cuda(x, mu, inv, gamma, beta, dy, y, ds, dss, *,
                          relu: bool, bn: bool):
    """Launch kernel #10: dw as :func:`linear_bn_bwd_dw_reference`."""
    global bwd_dw_launches
    (m, k), n = x.shape, dy.shape[1]
    dtype = _DTYPES[x.dtype]
    splits = dw_splits(m, k, n, x.dtype)
    work = _f32(k, x, splits, n)
    dw = torch.empty((n, k), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _run("flbn_bwd_dw", (_P,) * 11 + (_L, _I, _I, _I, _I, _I, _I),
             x.data_ptr(), _ptr(mu), _ptr(inv), _ptr(gamma), _ptr(beta),
             dy.data_ptr(), y.data_ptr(), ds.data_ptr(), dss.data_ptr(),
             work.data_ptr(), dw.data_ptr(), m, k, n, dtype, int(relu),
             int(bn), splits)
    bwd_dw_launches += 1
    return dw


# ---------------------------------------------------------------------------
# Dispatch: the plain version for CPU tensors, the kernel for CUDA ones
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def linear_bn_fwd(x, mu, inv, gamma, beta, w, *, relu: bool, bn: bool):
    """(y, sum(y), sum(y^2)) of x (M, K) and w (N, K); the vectors are read
    (and checked) only with ``bn``, and may be None without."""
    (m, k), n = x.shape, w.shape[0]
    _check(k, n, {"x": (x, (m, k)), "w": (w, (n, k))},
           _bn_vecs(k, bn, mu=mu, inv=inv, gamma=gamma, beta=beta))
    fn = linear_bn_fwd_reference if _on_cpu(x) else linear_bn_fwd_cuda
    return fn(x, mu, inv, gamma, beta, w, relu=relu, bn=bn)


def linear_bn_bwd_dx(dy, y, ds, dss, w, x, mu, inv, gamma, beta, *,
                     relu: bool, bn: bool):
    """(dx, dbeta, dgamma); the sums are None without ``bn``."""
    (m, k), n = x.shape, w.shape[0]
    _check(k, n, {"dy": (dy, (m, n)), "y": (y, (m, n)), "w": (w, (n, k)),
            "x": (x, (m, k))},
           {"ds": (ds, n), "dss": (dss, n),
            **_bn_vecs(k, bn, mu=mu, inv=inv, gamma=gamma, beta=beta)})
    fn = linear_bn_bwd_dx_reference if _on_cpu(x) else linear_bn_bwd_dx_cuda
    return fn(dy, y, ds, dss, w, x, mu, inv, gamma, beta, relu=relu, bn=bn)


def linear_bn_bwd_dw(x, mu, inv, gamma, beta, dy, y, ds, dss, *, relu: bool,
                     bn: bool):
    """dw (N, K) in dy's dtype."""
    (m, k), n = x.shape, dy.shape[1]
    _check(k, n, {"x": (x, (m, k)), "dy": (dy, (m, n)), "y": (y, (m, n))},
           {"ds": (ds, n), "dss": (dss, n),
            **_bn_vecs(k, bn, mu=mu, inv=inv, gamma=gamma, beta=beta)})
    fn = linear_bn_bwd_dw_reference if _on_cpu(x) else linear_bn_bwd_dw_cuda
    return fn(x, mu, inv, gamma, beta, dy, y, ds, dss, relu=relu, bn=bn)


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------

class _BnLinearStats(torch.autograd.Function):
    """(y, s, ss) = bn_linear_stats(...), the JAX custom VJP: its backward
    runs kernels #9 and #10 from the saved x and y. mu and inv are
    differentiable inputs (the caller derives them from the previous
    layer's sums), so their cotangents are vector math outside the kernels:
    dmu = -gamma * inv * dbeta, dinv = gamma * dgamma / inv."""

    @staticmethod
    def forward(ctx, x, mu, inv, gamma, beta, w, relu: bool, bn: bool):
        y, s, ss = linear_bn_fwd(x, mu, inv, gamma, beta, w, relu=relu,
                                 bn=bn)
        ctx.save_for_backward(x, mu, inv, gamma, beta, w, y)
        ctx.relu, ctx.bn = relu, bn
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, ds, dss):
        x, mu, inv, gamma, beta, w, y = ctx.saved_tensors
        relu, bn = ctx.relu, ctx.bn
        dx, db, dg = linear_bn_bwd_dx(dy, y, ds, dss, w, x, mu, inv, gamma,
                                      beta, relu=relu, bn=bn)
        dw = linear_bn_bwd_dw(x, mu, inv, gamma, beta, dy, y, ds, dss,
                              relu=relu, bn=bn)
        if not bn:
            return dx, None, None, None, None, dw, None, None
        dmu = -gamma * inv * db
        dinv = gamma * dg / inv
        return dx, dmu, dinv, dg, db, dw, None, None


def bn_linear_stats(x, mu, inv, gamma, beta, w, relu: bool = True,
                    bn: bool = True):
    """y = relu((x - mu) * inv * gamma + beta) @ w^T with the per-output-
    channel (sum(y), sum(y^2)); returns (y, s, ss). x (M, K) rows, w (N, K)
    (a 1x1 convolution's weight), the vectors float32 (K,)."""
    return _BnLinearStats.apply(x, mu, inv, gamma, beta, w, relu, bn)


def linear_stats(x, w):
    """y = x @ w^T with (sum(y), sum(y^2)): the ``bn=False`` shape, for a
    matmul whose input is already a materialised activation."""
    return _BnLinearStats.apply(x, None, None, None, None, w, False, False)
