"""Fused BatchNorm(+residual)+ReLU: the CUDA kernels' wrappers, their plain
versions, the autograd function that joins them, and the module.

Counterpart of ``distributeddeeplearning_tpu/ops/fused_batchnorm.py``. The
four Pallas kernels become hand-written Hopper kernels in
``csrc/fused_batchnorm.cu`` (see the note at its top for what bounds them
and what the design does about it):

- ``_stats_kernel``      -> :func:`bn_stats` (mean and biased variance);
- ``_apply_kernel``      -> :func:`bn_apply` (normalise, scale, shift,
  residual, ReLU);
- ``_bwd_reduce_kernel`` -> :func:`bn_bwd_reduce` (dbeta, dgamma);
- ``_bwd_dx_kernel``     -> :func:`bn_bwd_dx` (dx and the residual's
  cotangent).

Every wrapper takes row-major (M, C) activations: M = N*H*W rows of C
channels, the free view of a channels_last convolution output. It checks
that layout and raises rather than copying. Dispatch follows the tensor: a
CPU tensor takes the plain version (``*_reference``), a CUDA tensor launches
the kernel or raises. Nothing falls back.

``stats_launches``, ``apply_launches``, ``bwd_reduce_launches`` and
``bwd_dx_launches`` count the wrapper calls that launched a kernel (one
count a call, though the reductions launch two CUDA kernels), so a run can
show that its path went through each kernel.

The JAX wrappers' lane folding (``_fold_factor``, ``_fold``, ``_tile``) and
their shard_map twins (``_jnp_twin``) are TPU tiling and tracing devices,
not semantics, and have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch import nn

from distributeddeeplearning_tpu_torch.ops._build import load_library

SOURCE = "fused_batchnorm.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements in 16 bytes
_THREADS = 256
_BLOCKS_PER_SM = 8  # 2048 resident threads an SM over 256-thread blocks

stats_launches = 0       # bn_stats
apply_launches = 0       # bn_apply
bwd_reduce_launches = 0  # bn_bwd_reduce
bwd_dx_launches = 0      # bn_bwd_dx


# ---------------------------------------------------------------------------
# Plain versions: the kernels' arithmetic in PyTorch, in the same order
# ---------------------------------------------------------------------------

def bn_stats_reference(x2d: torch.Tensor):
    """(M, C) -> (mean, var) per channel, float32: sum(x) / M and the biased
    max(sum(x^2) / M - mean^2, 0)."""
    m = x2d.shape[0]
    xf = x2d.float()
    mean = xf.sum(dim=0) / m
    var = (xf * xf).sum(dim=0) / m - mean * mean
    return mean, var.clamp_min(0.0)


def bn_apply_reference(x2d, mean, inv, gamma, beta, residual2d=None, *,
                       relu: bool):
    """[relu]((x - mean) * (inv * gamma) + beta [+ residual]) in float32,
    returned in x's dtype."""
    y = (x2d.float() - mean) * (inv * gamma) + beta
    if residual2d is not None:
        y = y + residual2d.float()
    if relu:
        y = y.clamp_min(0.0)
    return y.to(x2d.dtype)


def _dz_xh(dy2d, y2d, x2d, mean, inv, relu: bool):
    dz = dy2d.float()
    if relu:
        dz = torch.where(y2d.float() > 0, dz, 0.0)
    return dz, (x2d.float() - mean) * inv


def bn_bwd_reduce_reference(dy2d, y2d, x2d, mean, inv, *, relu: bool):
    """(dbeta, dgamma) = (sum(dz), sum(dz * xh)), float32; dz is dy masked
    by y > 0 with ``relu`` (y is not read otherwise), xh = (x - mean) *
    inv."""
    dz, xh = _dz_xh(dy2d, y2d, x2d, mean, inv, relu)
    return dz.sum(dim=0), (dz * xh).sum(dim=0)


def bn_bwd_dx_reference(dy2d, y2d, x2d, mean, inv, gamma, dbeta, dgamma, *,
                        relu: bool, want_dres: bool):
    """(dx, dres): dx = gamma * inv * (dz - dbeta / M - xh * dgamma / M) in
    x's dtype, and dres = dz in x's dtype when ``want_dres`` (else None)."""
    m = x2d.shape[0]
    dz, xh = _dz_xh(dy2d, y2d, x2d, mean, inv, relu)
    dx = (gamma * inv) * (dz - dbeta / m - xh * (dgamma / m))
    return dx.to(x2d.dtype), (dz.to(x2d.dtype) if want_dres else None)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check(rows: dict, vectors: dict) -> None:
    """Raise on what the kernels (and, for the layout, the plain versions)
    do not take: ``rows`` one (M, C) shape and dtype (float32 or bfloat16),
    each row-major; ``vectors`` float32 (C,) and contiguous; all on one
    device. On a CUDA device also C % 8 == 0 and 16-byte aligned rows."""
    first = next(iter(rows.values()))
    if first.dim() != 2:
        raise ValueError(f"expected (M, C) activations, got shape "
                         f"{tuple(first.shape)}")
    m, c = first.shape
    dev = first.device
    for name, x in rows.items():
        if x.shape != first.shape or x.dtype != first.dtype:
            raise ValueError(f"{name} is {x.dtype} {tuple(x.shape)}; every "
                             f"(M, C) operand must be {first.dtype} "
                             f"{tuple(first.shape)}")
        if x.stride(1) != 1 or (m > 1 and x.stride(0) != c):
            raise ValueError(
                f"{name} has strides {x.stride()}: the BatchNorm kernels "
                f"take row-major (M, C) activations (the (N*H*W, C) view of "
                f"a channels_last tensor) and do not copy")
    if first.dtype not in _DTYPES:
        raise TypeError(f"dtype {first.dtype}: the kernels take one of "
                        f"{list(_DTYPES)}")
    for name, v in vectors.items():
        if v.dtype != torch.float32 or v.shape != (c,) \
                or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 ({c},); got "
                             f"{v.dtype} {tuple(v.shape)}")
    for name, x in {**rows, **vectors}.items():
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"the BatchNorm kernels run on CUDA tensors (and "
                         f"their plain versions on CPU ones), not {dev}")
    if c % 8:
        raise ValueError(f"C = {c}: the kernels load 16 bytes a thread and "
                         f"need C % 8 == 0")
    for name, x in {**rows, **vectors}.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _fn(name: str, argtypes: tuple, restype=ctypes.c_int):
    """The C entry point ``name`` of ``csrc/fused_batchnorm.cu``."""
    fn = getattr(load_library(SOURCE), name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _splits(m: int, c: int, dtype) -> int:
    """Row chunks of a reduction kernel (csrc: ``fused_bn_splits``)."""
    return _fn("fused_bn_splits", (_L, _I, _I))(m, c, _DTYPES[dtype])


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _blocks(x2d: torch.Tensor) -> int:
    """Grid of an elementwise kernel: one thread a 16-byte vector up to the
    card's resident threads, and at least one pass over a whole row."""
    m, c = x2d.shape
    lanes = c // _VEC[x2d.dtype]
    full = _sm_count(x2d.device.index) * _BLOCKS_PER_SM
    want = -(-m * lanes // _THREADS)
    return max(min(want, full), -(-lanes // _THREADS))


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _run(name: str, argtypes: tuple, *args) -> None:
    fn = _fn(name, argtypes + (_P,))
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc:
        err = _fn("fused_bn_error_string", (_I,), ctypes.c_char_p)
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def bn_stats_cuda(x2d: torch.Tensor):
    """Launch kernel #4: (mean, var) as :func:`bn_stats_reference`."""
    global stats_launches
    m, c = x2d.shape
    splits = _splits(m, c, x2d.dtype)
    work = torch.empty((2, splits, c), dtype=torch.float32, device=x2d.device)
    mean, var = (torch.empty(c, dtype=torch.float32, device=x2d.device)
                 for _ in range(2))
    with torch.cuda.device(x2d.device):
        _run("fused_bn_stats", (_P, _P, _P, _P, _L, _I, _I, _I),
             x2d.data_ptr(), work.data_ptr(), mean.data_ptr(),
             var.data_ptr(), m, c, _DTYPES[x2d.dtype], splits)
    stats_launches += 1
    return mean, var


def bn_apply_cuda(x2d, mean, inv, gamma, beta, residual2d=None, *,
                  relu: bool):
    """Launch kernel #5: y as :func:`bn_apply_reference`."""
    global apply_launches
    m, c = x2d.shape
    y = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        _run("fused_bn_apply", (_P,) * 7 + (_L, _I, _I, _I, _I),
             x2d.data_ptr(), _ptr(residual2d), mean.data_ptr(),
             inv.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
             m, c, _DTYPES[x2d.dtype], int(relu), _blocks(x2d))
    apply_launches += 1
    return y


def bn_bwd_reduce_cuda(dy2d, y2d, x2d, mean, inv, *, relu: bool):
    """Launch kernel #6: (dbeta, dgamma) as :func:`bn_bwd_reduce_reference`."""
    global bwd_reduce_launches
    m, c = x2d.shape
    splits = _splits(m, c, x2d.dtype)
    work = torch.empty((2, splits, c), dtype=torch.float32, device=x2d.device)
    dbeta, dgamma = (torch.empty(c, dtype=torch.float32, device=x2d.device)
                     for _ in range(2))
    with torch.cuda.device(x2d.device):
        _run("fused_bn_bwd_reduce", (_P,) * 8 + (_L, _I, _I, _I, _I),
             dy2d.data_ptr(), _ptr(y2d) if relu else None, x2d.data_ptr(),
             mean.data_ptr(), inv.data_ptr(), work.data_ptr(),
             dbeta.data_ptr(), dgamma.data_ptr(), m, c, _DTYPES[x2d.dtype],
             int(relu), splits)
    bwd_reduce_launches += 1
    return dbeta, dgamma


def bn_bwd_dx_cuda(dy2d, y2d, x2d, mean, inv, gamma, dbeta, dgamma, *,
                   relu: bool, want_dres: bool):
    """Launch kernel #7: (dx, dres) as :func:`bn_bwd_dx_reference`."""
    global bwd_dx_launches
    m, c = x2d.shape
    dx = torch.empty_like(x2d)
    dres = torch.empty_like(x2d) if want_dres else None
    with torch.cuda.device(x2d.device):
        _run("fused_bn_bwd_dx", (_P,) * 10 + (_L, _I, _I, _I, _I),
             dy2d.data_ptr(), _ptr(y2d) if relu else None, x2d.data_ptr(),
             mean.data_ptr(), inv.data_ptr(), gamma.data_ptr(),
             dbeta.data_ptr(), dgamma.data_ptr(), dx.data_ptr(), _ptr(dres),
             m, c, _DTYPES[x2d.dtype], int(relu), _blocks(x2d))
    bwd_dx_launches += 1
    return dx, dres


# ---------------------------------------------------------------------------
# Dispatch: the plain version for CPU tensors, the kernel for CUDA ones
# ---------------------------------------------------------------------------

def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def bn_stats(x2d: torch.Tensor):
    """(M, C) -> (mean, var) per channel, float32, biased variance."""
    _check({"x": x2d}, {})
    return (bn_stats_reference if _on_cpu(x2d) else bn_stats_cuda)(x2d)


def bn_apply(x2d, mean, inv, gamma, beta, residual2d=None, *, relu: bool):
    """y = [relu]((x - mean) * (inv * gamma) + beta [+ residual]) in x's
    dtype; the per-channel vectors are float32."""
    rows = {"x": x2d}
    if residual2d is not None:
        rows["residual"] = residual2d
    _check(rows, {"mean": mean, "inv": inv, "gamma": gamma, "beta": beta})
    fn = bn_apply_reference if _on_cpu(x2d) else bn_apply_cuda
    return fn(x2d, mean, inv, gamma, beta, residual2d, relu=relu)


def bn_bwd_reduce(dy2d, y2d, x2d, mean, inv, *, relu: bool):
    """(dbeta, dgamma), float32; ``y2d`` is read (and checked) only with
    ``relu``, and may be None without."""
    rows = {"dy": dy2d, "x": x2d, **({"y": y2d} if relu else {})}
    _check(rows, {"mean": mean, "inv": inv})
    fn = bn_bwd_reduce_reference if _on_cpu(x2d) else bn_bwd_reduce_cuda
    return fn(dy2d, y2d, x2d, mean, inv, relu=relu)


def bn_bwd_dx(dy2d, y2d, x2d, mean, inv, gamma, dbeta, dgamma, *,
              relu: bool, want_dres: bool):
    """(dx, dres or None) in x's dtype; ``y2d`` as in :func:`bn_bwd_reduce`."""
    rows = {"dy": dy2d, "x": x2d, **({"y": y2d} if relu else {})}
    _check(rows, {"mean": mean, "inv": inv, "gamma": gamma, "dbeta": dbeta,
                  "dgamma": dgamma})
    fn = bn_bwd_dx_reference if _on_cpu(x2d) else bn_bwd_dx_cuda
    return fn(dy2d, y2d, x2d, mean, inv, gamma, dbeta, dgamma, relu=relu,
              want_dres=want_dres)


# ---------------------------------------------------------------------------
# Differentiable train-mode op
# ---------------------------------------------------------------------------

class _BatchNormAct(torch.autograd.Function):
    """(y, mean, var) = bn_act_train(...): its backward runs kernels #6 and
    #7 from the saved x, y, mean and inv, as the JAX custom VJPs
    ``_bn_act_bwd``/``_bn_act_res_bwd`` do. mean and var are state, not
    gradients: their cotangents are ignored."""

    @staticmethod
    def forward(ctx, x2d, gamma, beta, residual2d, relu: bool, eps: float):
        mean, var = bn_stats(x2d)
        inv = torch.rsqrt(var + eps)
        y = bn_apply(x2d, mean, inv, gamma.float(), beta.float(), residual2d,
                     relu=relu)
        # Without relu y is never read back, so it is not kept.
        ctx.save_for_backward(x2d, y if relu else None, mean, inv, gamma)
        ctx.relu, ctx.residual = relu, residual2d is not None
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x2d, y, mean, inv, gamma = ctx.saved_tensors
        dbeta, dgamma = bn_bwd_reduce(dy, y, x2d, mean, inv, relu=ctx.relu)
        dx, dres = bn_bwd_dx(dy, y, x2d, mean, inv, gamma.float(), dbeta,
                             dgamma, relu=ctx.relu, want_dres=ctx.residual)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), dres,
                None, None)


def bn_act_train(x2d, gamma, beta, relu: bool = True, eps: float = 1e-5,
                 residual2d: Optional[torch.Tensor] = None):
    """y = [relu](xh * gamma + beta [+ residual]) with batch statistics;
    returns (y, mean, var) with the biased batch statistics (for the running
    update; not differentiable). The JAX package's ``bn_act_train`` and,
    with ``residual2d``, ``bn_act_res_train``."""
    return _BatchNormAct.apply(x2d, gamma, beta, residual2d, relu, eps)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------

def as_rows(x: torch.Tensor) -> torch.Tensor:
    """The (N*H*W, C) view of a channels_last (N, C, H, W) tensor; raises
    rather than copying when x is not channels_last."""
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(
            f"the fused BatchNorm takes channels_last (N, C, H, W) "
            f"activations, whose (N*H*W, C) view is free; got shape "
            f"{tuple(x.shape)} with strides {x.stride()}")
    return x.permute(0, 2, 3, 1).view(-1, x.shape[1])


def from_rows(y2d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``y2d`` viewed in the shape and channels_last layout of ``like``."""
    n, c, h, w = like.shape
    return y2d.view(n, h, w, c).permute(0, 3, 1, 2)


class FusedBatchNormAct(nn.Module):
    """BatchNorm [+ residual] [+ ReLU] over the channel dim, through kernels
    #4-#7 in training: the JAX package's ``FusedBatchNormAct``.

    Same variables as flax ``nn.BatchNorm`` under the port's names:
    float32 ``weight`` (flax ``scale``) and ``bias`` parameters,
    ``running_mean``/``running_var`` buffers (flax ``batch_stats``
    ``mean``/``var``). In training the running update is flax's: ``ra =
    momentum * ra + (1 - momentum) * batch`` with the biased batch variance
    (so ``nn.BatchNorm2d``'s unbiased variance and complementary momentum do
    not apply). In evaluation it is the plain elementwise formula with the
    running statistics, and no kernel runs.

    Input: channels_last (N, C, H, W), cast to the compute ``dtype``;
    output in the same shape and layout.
    """

    def __init__(self, num_features: int, *, relu: bool = True,
                 momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16,
                 zero_init: bool = False):
        super().__init__()
        init = torch.zeros if zero_init else torch.ones
        self.weight = nn.Parameter(init(num_features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(num_features,
                                             dtype=torch.float32))
        self.register_buffer("running_mean",
                             torch.zeros(num_features, dtype=torch.float32))
        self.register_buffer("running_var",
                             torch.ones(num_features, dtype=torch.float32))
        self.relu, self.momentum, self.eps = relu, momentum, eps
        self.compute_dtype = dtype

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """flax's running update with the batch's (mean, biased var)."""
        m = self.momentum
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)

    def forward(self, x, residual=None):
        x = x.to(self.compute_dtype)
        x2d = as_rows(x)
        res2d = (None if residual is None
                 else as_rows(residual.to(self.compute_dtype)))
        if not self.training:
            inv = torch.rsqrt(self.running_var + self.eps)
            y2d = bn_apply_reference(x2d, self.running_mean, inv,
                                     self.weight.float(), self.bias.float(),
                                     res2d, relu=self.relu)
            return from_rows(y2d, x)
        y2d, mean, var = bn_act_train(x2d, self.weight, self.bias, self.relu,
                                      self.eps, res2d)
        self.update_running(mean, var)
        return from_rows(y2d, x)
