"""3x3 convolution with a BatchNorm prologue and a statistics epilogue: the
CUDA kernels' wrappers, their plain versions and the autograd function that
joins them.

Counterpart of ``distributeddeeplearning_tpu/ops/fused_conv_bn.py``, the
bottleneck's stride-1, pad-1 3x3 convolution fed the raw conv1 output. The
three Pallas kernels become hand-written Hopper kernels in
``csrc/fused_conv_bn.cu`` (see the note at its top for what bounds them and
what the design does about it):

- ``_fwd_kernel``    -> :func:`conv3x3_bn_fwd`: y = conv3x3(a, w) with a =
  relu((x - mu) * (inv * gamma) + beta) (a = x with ``bn`` off), zero
  outside the image, and the columns' sum(y) and sum(y^2) over y as stored;
- ``_bwd_dx_kernel`` -> :func:`conv3x3_bn_bwd_dx`: dY = dy + ds + 2 y dss,
  da = conv3x3(dY, flip(w)^T), and with ``bn`` dx, dbeta and dgamma
  through the prologue;
- ``_bwd_dw_kernel`` -> :func:`conv3x3_bn_bwd_dw`: dw = patches(a)^T @ dY.

In bf16 all three run on the tensor cores (wgmma, with TMA copies,
``csrc/conv3x3_tc.cuh``): each block transforms a halo slab of its pixel
tile once in shared memory (bn1's prologue over x, or dY over dy) and reads
the nine taps as row shifts of it, in registers; the kernels size their
grids by the card's SM count (:func:`fwd_run_rows`,
:func:`bwd_dx_run_rows`, :func:`dw_splits`). Every float32 instance runs the
FMA implicit GEMM of ``csrc/bn_gemm.cuh``. The tensor-core kernels take
every shape the wrappers accept, so nothing is routed elsewhere.

The plain versions repeat the Pallas kernels' rounding points: a is rounded
to x's dtype before the product, y is stored in x's dtype and the sums are
over y as stored; dY is rounded to the activations' dtype in #12 and #13;
dw is rounded to dy's dtype (the reference's VJP widens it to float32
after that, and so does autograd for the float32 master). Their
convolutions sum in float64 and round to float32 once: the exact sum that
any float32 order of accumulation approximates. A float32 library
convolution is no such reference: on an H100 cuDNN's float32 results for
ResNet-50's 3x3s sat up to 1.5e-5 of a column's largest value from the
exact ones (dw at batch 512, stage 1), more than the kernels' own error. The forward
prologue computes (x - mu) * (inv * gamma) + beta; #12's ReLU mask
recomputes z = ((x - mu) * inv) * gamma + beta, as the reference does, so
the two may round apart. Column sums are taken in
float64 and rounded to float32 once, as the kernels take them.

Layouts. x and y are (B, H, W, C) contiguous: the ``permute(0, 2, 3, 1)``
view of a channels_last activation, so no copy is made. The weight is the
port's (Cout, Cin, 3, 3) convolution weight in any memory format (the
kernels read it as (Cout, 3, 3, Cin), free for a channels_last weight), and
dw comes back in that shape, with channels_last strides from the kernel.
The JAX package's HWIO kernel ``wj`` is ``w.permute(2, 3, 1, 0)``; its
(9 * Cin, Cout) patch matrix has row (3 * dy + dx) * Cin + c, which is
column ``(3 * dy + dx) * Cin + c`` of the kernels' (Cout, 9 * Cin) view of
w; #12's ``w[::-1, ::-1].transpose(0, 1, 3, 2)`` is
``w.flip(2, 3).transpose(0, 1)`` here. The per-channel vectors are float32:
mu, inv, gamma, beta of the Cin input channels, ds and dss (the cotangents
of the two sums) of the Cout output channels. Every wrapper checks this and
raises rather than copying an activation. Dispatch follows the tensor: a
CPU tensor takes the plain version (``*_reference``), a CUDA tensor
launches the kernel or raises. Nothing falls back.

``fwd_launches``, ``bwd_dx_launches`` and ``bwd_dw_launches`` count the
wrapper calls that launched a kernel (one count a call, though each also
launches a second, summing kernel).

The JAX kernels' halo slab, its DMAs and row blocks (``_row_block``,
``_start_slab_dmas``) are TPU tiling devices, not semantics, and have no
counterpart here; nor do the jnp twins for shard_map.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from distributeddeeplearning_tpu_torch.ops._build import load_library
from distributeddeeplearning_tpu_torch.ops.fused_linear_bn import (
    _bn_vecs, _col_sum, _dy_total, _prologue, _ptr)

SOURCE = "fused_conv_bn.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

fwd_launches = 0     # conv3x3_bn_fwd
bwd_dx_launches = 0  # conv3x3_bn_bwd_dx
bwd_dw_launches = 0  # conv3x3_bn_bwd_dw


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in PyTorch, in the same order
# ---------------------------------------------------------------------------

def _conv(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """conv3x3(t, w), stride 1, zero padding 1, summed in float64 and
    rounded to float32: t (B, H, W, C), w (Cout, C, 3, 3); returns (B, H,
    W, Cout) float32."""
    out = F.conv2d(t.double().permute(0, 3, 1, 2), w.double(), padding=1)
    return out.permute(0, 2, 3, 1).float()


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def conv3x3_bn_fwd_reference(x, mu, inv, gamma, beta, w, *, relu: bool,
                             bn: bool):
    """(y, sum(y), sum(y^2)): y = conv3x3(a, w) rounded to float32, then to
    x's dtype, the sums over y as stored."""
    a = _prologue(x, mu, inv, gamma, beta, relu, bn)
    y = _conv(a, w).to(x.dtype).contiguous()
    yd = _rows(y).double()
    return y, _col_sum(yd), _col_sum(yd * yd)


def conv3x3_bn_bwd_dx_reference(dy, y, ds, dss, w, x, mu, inv, gamma, beta,
                                *, relu: bool, bn: bool):
    """(dx, dbeta, dgamma): da = conv3x3(dY, flip(w)^T) rounded to float32;
    with ``bn`` dz = da masked by xh * gamma + beta > 0 (``relu``), dx = dz
    * (gamma * inv) in x's dtype, dbeta = sum(dz), dgamma = sum(dz * xh)
    with xh = (x - mu) * inv. Without ``bn``, dx = da and the sums are
    None."""
    da = _conv(_dy_total(dy, y, ds, dss), w.flip(2, 3).transpose(0, 1))
    if not bn:
        return da.to(x.dtype).contiguous(), None, None
    xh = (x.float() - mu) * inv
    dz = torch.where(xh * gamma + beta > 0, da, 0.0) if relu else da
    dx = (dz * (gamma * inv)).to(x.dtype).contiguous()
    return dx, _col_sum(_rows(dz)), _col_sum(_rows(dz).double() * _rows(xh))


def conv3x3_bn_bwd_dw_reference(x, mu, inv, gamma, beta, dy, y, ds, dss, *,
                                relu: bool, bn: bool):
    """dw = patches(a)^T @ dY as a (Cout, Cin, 3, 3) weight, summed in
    float64, rounded to float32 and then to dy's dtype."""
    a = _prologue(x, mu, inv, gamma, beta, relu, bn)
    dyt = _dy_total(dy, y, ds, dss)
    shape = (dy.shape[-1], x.shape[-1], 3, 3)
    dw = torch.nn.grad.conv2d_weight(a.double().permute(0, 3, 1, 2), shape,
                                     dyt.double().permute(0, 3, 1, 2),
                                     padding=1)
    return dw.float().to(dy.dtype)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check(cin: int, cout: int, acts: dict, w, vecs: dict) -> None:
    """Raise on what the kernels (and, for the layout, the plain versions)
    do not take. Cin and Cout multiples of 8; ``acts``: {name: (tensor,
    (B, H, W, C))}, each contiguous, and w (Cout, Cin, 3, 3) unless None,
    all of one dtype (float32 or bfloat16); ``vecs``: {name: (tensor,
    length)}, float32 and contiguous. All on one device; on a CUDA device every
    operand 16-byte aligned and B * H * W < 2^31."""
    if cin % 8 or cout % 8:
        raise ValueError(f"Cin = {cin}, Cout = {cout}: the kernels load 16 "
                         f"bytes a thread and need multiples of 8")
    first = next(iter(acts.values()))[0]
    if first.dtype not in _DTYPES:
        raise TypeError(f"dtype {first.dtype}: the kernels take one of "
                        f"{list(_DTYPES)}")
    for name, (t, shape) in acts.items():
        if t.dim() != 4 or tuple(t.shape) != shape or t.dtype != first.dtype:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}; expected "
                             f"{first.dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(
                f"{name} has strides {t.stride()}: the 3x3 kernels take "
                f"contiguous (B, H, W, C) activations (the permute(0, 2, 3, "
                f"1) view of a channels_last tensor) and do not copy")
    if w is not None and (tuple(w.shape) != (cout, cin, 3, 3)
                          or w.dtype != first.dtype):
        raise ValueError(f"w is {w.dtype} {tuple(w.shape)}; expected "
                         f"{first.dtype} {(cout, cin, 3, 3)}")
    for name, (v, length) in vecs.items():
        if v.dtype != torch.float32 or tuple(v.shape) != (length,) \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 ({length},); "
                             f"got {v.dtype} {tuple(v.shape)}")
    tensors = {n: t for n, (t, _) in {**acts, **vecs}.items()}
    if w is not None:
        tensors["w"] = w
    dev = first.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"the 3x3 kernels run on CUDA tensors (and their "
                         f"plain versions on CPU ones), not {dev}")
    if first.numel() // first.shape[-1] >= 2 ** 31:
        raise ValueError(f"{tuple(first.shape)}: the 3x3 kernels index "
                         f"pixels in 32 bits")
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _fn(name: str, argtypes: tuple, restype=ctypes.c_int):
    """The C entry point ``name`` of ``csrc/fused_conv_bn.cu``."""
    fn = getattr(load_library(SOURCE), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _run(name: str, argtypes: tuple, *args) -> None:
    fn = _fn(name, argtypes + (_P,))
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc:
        err = _fn("fcbn_error_string", (_I,), ctypes.c_char_p)
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def _f32(n: int, like: torch.Tensor, *lead: int) -> torch.Tensor:
    return torch.empty((*lead, n), dtype=torch.float32, device=like.device)


def _ohwi(w: torch.Tensor) -> torch.Tensor:
    """w (Cout, Cin, 3, 3) as the contiguous (Cout, 3, 3, Cin) the kernels
    read: a view of a channels_last weight, a copy of any other."""
    return w.permute(0, 2, 3, 1).contiguous()


def fwd_run_rows(m: int, w: int, cin: int, cout: int,
                 dtype: torch.dtype) -> int:
    """The pixels of one block's run in kernel #11 at this shape (image
    width ``w``): block s sums the columns of y over pixels [s * run, (s +
    1) * run) into its own partial, and the partials are summed in order.
    Depends on the current card's SM count for bf16."""
    return _fn("fcbn_fwd_run_rows", (_L, _I, _I, _I, _I), _L)(
        m, w, cin, cout, _DTYPES[dtype])


def conv3x3_bn_fwd_cuda(x, mu, inv, gamma, beta, w, *, relu: bool,
                        bn: bool):
    """Launch kernel #11: (y, sum, sumsq) as
    :func:`conv3x3_bn_fwd_reference`."""
    global fwd_launches
    b, h, wd, cin = x.shape
    cout, m = w.shape[0], b * h * wd
    wk = _ohwi(w)
    y = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    s, ss = _f32(cout, x), _f32(cout, x)
    with torch.cuda.device(x.device):
        splits = -(-m // fwd_run_rows(m, wd, cin, cout, x.dtype))
        work = torch.empty((2, splits, cout), dtype=torch.float64,
                           device=x.device)
        _run("fcbn_fwd", (_P,) * 10 + (_L,) + (_I,) * 8,
             x.data_ptr(), wk.data_ptr(), _ptr(mu), _ptr(inv), _ptr(gamma),
             _ptr(beta), y.data_ptr(), work.data_ptr(), s.data_ptr(),
             ss.data_ptr(), m, h, wd, cin, cout, _DTYPES[x.dtype], int(relu),
             int(bn), splits)
    fwd_launches += 1
    return y, s, ss


def bwd_dx_run_rows(m: int, w: int, cin: int, cout: int,
                    dtype: torch.dtype) -> int:
    """The pixels of one block's run in kernel #12 at this shape (image
    width ``w``): block s sums dbeta and dgamma over pixels [s * run, (s +
    1) * run) into its own partial, and the partials are summed in order.
    Depends on the current card's SM count for bf16."""
    return _fn("fcbn_bwd_dx_run_rows", (_L, _I, _I, _I, _I), _L)(
        m, w, cin, cout, _DTYPES[dtype])


def conv3x3_bn_bwd_dx_cuda(dy, y, ds, dss, w, x, mu, inv, gamma, beta, *,
                           relu: bool, bn: bool):
    """Launch kernel #12: (dx, dbeta, dgamma) as
    :func:`conv3x3_bn_bwd_dx_reference`."""
    global bwd_dx_launches
    b, h, wd, cin = x.shape
    cout, m = w.shape[0], b * h * wd
    wk = _ohwi(w)
    dx = torch.empty_like(x)
    db, dg = (_f32(cin, x), _f32(cin, x)) if bn else (None, None)
    with torch.cuda.device(x.device):
        splits = -(-m // bwd_dx_run_rows(m, wd, cin, cout, x.dtype))
        work = torch.empty((2, splits, cin), dtype=torch.float64,
                           device=x.device) if bn else None
        _run("fcbn_bwd_dx", (_P,) * 14 + (_L,) + (_I,) * 8,
             dy.data_ptr(), y.data_ptr(), ds.data_ptr(), dss.data_ptr(),
             wk.data_ptr(), x.data_ptr(), _ptr(mu), _ptr(inv), _ptr(gamma),
             _ptr(beta), dx.data_ptr(), _ptr(work), _ptr(db), _ptr(dg), m, h,
             wd, cin, cout, _DTYPES[x.dtype], int(relu), int(bn), splits)
    bwd_dx_launches += 1
    return dx, db, dg


def dw_splits(m: int, cin: int, cout: int, dtype: torch.dtype) -> int:
    """The number of chunks of M = B * H * W that kernel #13 sums
    separately (and then in order) at this shape; each but the last
    covers the same number of pixels. Depends on the current card's SM
    count for bf16."""
    return _fn("fcbn_dw_splits", (_L, _I, _I, _I))(m, cin, cout,
                                                    _DTYPES[dtype])


def conv3x3_bn_bwd_dw_cuda(x, mu, inv, gamma, beta, dy, y, ds, dss, *,
                           relu: bool, bn: bool):
    """Launch kernel #13: dw as :func:`conv3x3_bn_bwd_dw_reference`, with
    channels_last strides."""
    global bwd_dw_launches
    b, h, wd, cin = x.shape
    cout, m = dy.shape[-1], b * h * wd
    dw = torch.empty((cout, 3, 3, cin), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        splits = dw_splits(m, cin, cout, x.dtype)
        work = _f32(9 * cin, x, splits, cout)
        _run("fcbn_bwd_dw", (_P,) * 11 + (_L,) + (_I,) * 8,
             x.data_ptr(), _ptr(mu), _ptr(inv), _ptr(gamma), _ptr(beta),
             dy.data_ptr(), y.data_ptr(), ds.data_ptr(), dss.data_ptr(),
             work.data_ptr(), dw.data_ptr(), m, h, wd, cin, cout,
             _DTYPES[x.dtype], int(relu), int(bn), splits)
    bwd_dw_launches += 1
    return dw.permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# Dispatch: the plain version for CPU tensors, the kernel for CUDA ones
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def _out_shape(x: torch.Tensor, c: int) -> tuple:
    return (*x.shape[:3], c)


def conv3x3_bn_fwd(x, mu, inv, gamma, beta, w, *, relu: bool, bn: bool):
    """(y, sum(y), sum(y^2)) of x (B, H, W, Cin) and w (Cout, Cin, 3, 3);
    the vectors are read (and checked) only with ``bn``, and may be None
    without."""
    cin, cout = x.shape[-1], w.shape[0]
    _check(cin, cout, {"x": (x, _out_shape(x, cin))}, w,
           _bn_vecs(cin, bn, mu=mu, inv=inv, gamma=gamma, beta=beta))
    fn = conv3x3_bn_fwd_reference if _on_cpu(x) else conv3x3_bn_fwd_cuda
    return fn(x, mu, inv, gamma, beta, w, relu=relu, bn=bn)


def conv3x3_bn_bwd_dx(dy, y, ds, dss, w, x, mu, inv, gamma, beta, *,
                      relu: bool, bn: bool):
    """(dx, dbeta, dgamma); the sums are None without ``bn``."""
    cin, cout = x.shape[-1], w.shape[0]
    _check(cin, cout, {"x": (x, _out_shape(x, cin)),
                       "dy": (dy, _out_shape(x, cout)),
                       "y": (y, _out_shape(x, cout))}, w,
           {"ds": (ds, cout), "dss": (dss, cout),
            **_bn_vecs(cin, bn, mu=mu, inv=inv, gamma=gamma, beta=beta)})
    fn = conv3x3_bn_bwd_dx_reference if _on_cpu(x) else conv3x3_bn_bwd_dx_cuda
    return fn(dy, y, ds, dss, w, x, mu, inv, gamma, beta, relu=relu, bn=bn)


def conv3x3_bn_bwd_dw(x, mu, inv, gamma, beta, dy, y, ds, dss, *,
                      relu: bool, bn: bool):
    """dw (Cout, Cin, 3, 3) in dy's dtype."""
    cin, cout = x.shape[-1], dy.shape[-1]
    _check(cin, cout, {"x": (x, _out_shape(x, cin)),
                       "dy": (dy, _out_shape(x, cout)),
                       "y": (y, _out_shape(x, cout))}, None,
           {"ds": (ds, cout), "dss": (dss, cout),
            **_bn_vecs(cin, bn, mu=mu, inv=inv, gamma=gamma, beta=beta)})
    fn = conv3x3_bn_bwd_dw_reference if _on_cpu(x) else conv3x3_bn_bwd_dw_cuda
    return fn(x, mu, inv, gamma, beta, dy, y, ds, dss, relu=relu, bn=bn)


# ---------------------------------------------------------------------------
# Differentiable op
# ---------------------------------------------------------------------------

class _BnConv3x3Stats(torch.autograd.Function):
    """(y, s, ss) = bn_conv3x3_stats(...), the JAX custom VJP: its backward
    runs kernels #12 and #13 from the saved x, w and y (no normalised a is
    kept). mu and inv are differentiable inputs (the caller derives them
    from the previous layer's sums), so their cotangents are vector math
    outside the kernels: dmu = -gamma * inv * dbeta, dinv = gamma * dgamma
    / inv."""

    @staticmethod
    def forward(ctx, x, mu, inv, gamma, beta, w, relu: bool, bn: bool):
        y, s, ss = conv3x3_bn_fwd(x, mu, inv, gamma, beta, w, relu=relu,
                                  bn=bn)
        ctx.save_for_backward(x, mu, inv, gamma, beta, w, y)
        ctx.relu, ctx.bn = relu, bn
        return y, s, ss

    @staticmethod
    def backward(ctx, dy, ds, dss):
        x, mu, inv, gamma, beta, w, y = ctx.saved_tensors
        relu, bn = ctx.relu, ctx.bn
        dy = dy.contiguous()
        dx, db, dg = conv3x3_bn_bwd_dx(dy, y, ds, dss, w, x, mu, inv, gamma,
                                       beta, relu=relu, bn=bn)
        dw = conv3x3_bn_bwd_dw(x, mu, inv, gamma, beta, dy, y, ds, dss,
                               relu=relu, bn=bn)
        if not bn:
            return dx, None, None, None, None, dw, None, None
        dmu = -gamma * inv * db
        dinv = gamma * dg / inv
        return dx, dmu, dinv, dg, db, dw, None, None


def bn_conv3x3_stats(x, mu, inv, gamma, beta, w, relu: bool = True,
                     bn: bool = True):
    """y = conv3x3(relu((x - mu) * inv * gamma + beta), w), stride 1, pad 1,
    with the per-output-channel (sum(y), sum(y^2)); returns (y, s, ss). x
    (B, H, W, Cin), w (Cout, Cin, 3, 3), the vectors float32 (Cin,)."""
    return _BnConv3x3Stats.apply(x, mu, inv, gamma, beta, w, relu, bn)


def conv3x3_stats(x, w):
    """y = conv3x3(x, w) with (sum(y), sum(y^2)): the ``bn=False`` shape,
    for an input that is already a materialised activation."""
    return _BnConv3x3Stats.apply(x, None, None, None, None, w, False, False)
