"""The port's fused BatchNorm (distributeddeeplearning_tpu_torch/ops/
fused_batchnorm.py) against the JAX package's, on the CPU.

Each plain version of kernels #4-#7 against its JAX wrapper running the
Pallas kernel in interpret mode, at (256, 64) (which the JAX wrapper folds
to 128 lanes) and (96, 128), on f32 and bf16 inputs, across the relu,
residual and want_dres variants. Then the autograd function's outputs and
gradients against ``jax.vjp`` of ``bn_act_train``/``bn_act_res_train``, and
the module's output and running update against flax ``FusedBatchNormAct``.

Tolerances: f32 outputs differ only in summation order (1e-6 absolute +
1e-5 relative). A bf16 output is rounded once from f32 values that may
differ in their last bits, so it may sit one bf16 ulp away: 2^-7 of the
largest |value| of its channel column.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops import fused_batchnorm as jbn
from distributeddeeplearning_tpu_torch.ops import fused_batchnorm as tbn
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

EPS = 1e-5
SHAPES = [(256, 64), (96, 128)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
F32 = dict(rtol=1e-5, atol=1e-6)


def _rows(rng, shape, dtype):
    """The same (M, C) values for both sides: torch in ``dtype``, JAX in
    the matching dtype (bf16 values are exact in both)."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _vec(rng, c, low=-1.0, high=1.0):
    a = rng.uniform(low, high, c).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _close(out: torch.Tensor, ref) -> None:
    """f32: F32. bf16: one ulp of the column's largest |ref|."""
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = out.float().numpy()
    if out.dtype == torch.float32:
        np.testing.assert_allclose(got, ref, **F32)
    else:
        col = np.abs(ref).max(axis=0, keepdims=True)
        assert (np.abs(got - ref) <= 2.0 ** -7 * col + 1e-6).all(), \
            np.abs(got - ref).max()


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """A CPU tensor takes the plain version: no kernel is counted."""
    names = ("stats_launches", "apply_launches", "bwd_reduce_launches",
             "bwd_dx_launches")
    before = [getattr(tbn, n) for n in names]
    yield
    assert [getattr(tbn, n) for n in names] == before


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_stats_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    x, jx = _rows(rng, shape, dtype)
    x, jx = x + 0.5, jx + 0.5  # a nonzero mean
    mean, var = tbn.bn_stats(x)
    ref_mean, ref_var = jbn.bn_stats(jx, interpret=True)
    np.testing.assert_allclose(mean.numpy(), ref_mean, **F32)
    np.testing.assert_allclose(var.numpy(), ref_var, **F32)


@pytest.mark.parametrize("variant", ["relu", "plain", "residual"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_apply_matches_pallas(shape, dtype, variant):
    rng = np.random.default_rng(1)
    c = shape[1]
    x, jx = _rows(rng, shape, dtype)
    (mean, jmean), (inv, jinv), (g, jg), (b, jb) = (
        _vec(rng, c), _vec(rng, c, 0.5, 2.0), _vec(rng, c, 0.5, 1.5),
        _vec(rng, c))
    res, jres = _rows(rng, shape, dtype) if variant == "residual" else (
        None, None)
    relu = variant != "plain"
    y = tbn.bn_apply(x, mean, inv, g, b, res, relu=relu)
    assert y.dtype == x.dtype
    _close(y, jbn.bn_apply(jx, jmean, jinv, jg, jb, jres, relu=relu,
                           interpret=True))


def _bwd_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    c = shape[1]
    rows = [_rows(rng, shape, dtype) for _ in range(3)]  # dy, x, y
    vecs = [_vec(rng, c), _vec(rng, c, 0.5, 2.0)]        # mean, inv
    return rows, vecs, rng


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_reduce_matches_pallas(shape, dtype, relu):
    ((dy, jdy), (x, jx), (y, jy)), ((mean, jmean), (inv, jinv)), _ = \
        _bwd_inputs(shape, dtype, 2)
    # Without relu y is not read: None is accepted.
    db, dg = tbn.bn_bwd_reduce(dy, y if relu else None, x, mean, inv,
                               relu=relu)
    ref_db, ref_dg = jbn.bn_bwd_reduce(jdy, jy, jx, jmean, jinv, relu=relu,
                                       interpret=True)
    np.testing.assert_allclose(db.numpy(), ref_db, **F32)
    np.testing.assert_allclose(dg.numpy(), ref_dg, **F32)


@pytest.mark.parametrize("relu,want_dres", [(True, False), (False, False),
                                            (True, True)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_dx_matches_pallas(shape, dtype, relu, want_dres):
    ((dy, jdy), (x, jx), (y, jy)), ((mean, jmean), (inv, jinv)), rng = \
        _bwd_inputs(shape, dtype, 3)
    c = shape[1]
    (g, jg), (db, jdb), (dg, jdg) = (_vec(rng, c, 0.5, 1.5),
                                     _vec(rng, c, -40, 40),
                                     _vec(rng, c, -40, 40))
    dx, dres = tbn.bn_bwd_dx(dy, y, x, mean, inv, g, db, dg, relu=relu,
                             want_dres=want_dres)
    ref_dx, ref_dres = jbn.bn_bwd_dx(jdy, jy, jx, jmean, jinv, jg, jdb, jdg,
                                     relu=relu, want_dres=want_dres,
                                     interpret=True)
    assert dx.dtype == x.dtype
    _close(dx, ref_dx)
    if want_dres:
        _close(dres, ref_dres)
    else:
        assert dres is None


@pytest.mark.parametrize("relu,residual", [(True, False), (False, False),
                                           (True, True)])
def test_autograd_matches_jax_vjp(relu, residual):
    """Outputs, mean/var and the gradients of x, gamma, beta (and the
    residual) against jax.vjp of the custom VJPs, f32 at (256, 64)."""
    rng = np.random.default_rng(4)
    shape, c = (256, 64), 64
    x, jx = _rows(rng, shape, "float32")
    dy, jdy = _rows(rng, shape, "float32")
    res, jres = _rows(rng, shape, "float32")
    (g, jg), (b, jb) = _vec(rng, c, 0.5, 1.5), _vec(rng, c)
    leaves = [x, g, b] + ([res] if residual else [])
    for t in leaves:
        t.requires_grad_(True)
    y, mean, var = tbn.bn_act_train(x, g, b, relu, EPS,
                                    res if residual else None)
    assert not mean.requires_grad and not var.requires_grad
    grads = torch.autograd.grad(y, leaves, dy)
    if residual:
        fn = lambda x_, g_, b_, r_: jbn.bn_act_res_train(  # noqa: E731
            x_, g_, b_, r_, relu, EPS)
        primals = (jx, jg, jb, jres)
    else:
        fn = lambda x_, g_, b_: jbn.bn_act_train(  # noqa: E731
            x_, g_, b_, relu, EPS)
        primals = (jx, jg, jb)
    (ref_y, ref_mean, ref_var), vjp = jax.vjp(fn, *primals)
    ref_grads = vjp((jdy, jnp.zeros(c), jnp.zeros(c)))
    _close(y.detach(), ref_y)
    np.testing.assert_allclose(mean.numpy(), ref_mean, **F32)
    np.testing.assert_allclose(var.numpy(), ref_var, **F32)
    for got, ref in zip(grads, ref_grads):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got.numpy() / scale,
                                   np.asarray(ref) / scale, **F32)


def test_module_matches_flax_and_updates_running_stats():
    """Train mode twice (two running updates from non-trivial buffers) and
    eval mode, with a residual, against flax ``FusedBatchNormAct``: the
    port's module takes the channels_last NCHW view of the same NHWC
    input."""
    rng = np.random.default_rng(5)
    n, h, w, c = 2, 4, 6, 64
    xs = [rng.standard_normal((n, h, w, c)).astype(np.float32) + 0.3
          for _ in range(2)]
    res = rng.standard_normal((n, h, w, c)).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                   "bias": rng.uniform(-1, 1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.uniform(-1, 1, c).astype(np.float32),
                        "var": rng.uniform(0.5, 2, c).astype(np.float32)}}
    flax_mod = jbn.FusedBatchNormAct(dtype=jnp.float32)
    module = tbn.FusedBatchNormAct(c, dtype=torch.float32)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        module.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        module.running_mean.copy_(torch.from_numpy(
            variables["batch_stats"]["mean"]))
        module.running_var.copy_(torch.from_numpy(
            variables["batch_stats"]["var"]))

    def nchw(a):
        return torch.from_numpy(a).permute(0, 3, 1, 2)

    for x in xs:
        ref, mutated = flax_mod.apply(variables, x, residual=res,
                                      mutable=["batch_stats"])
        variables = {**variables, "batch_stats": mutated["batch_stats"]}
        with torch.no_grad():
            out = module(nchw(x), nchw(res))
        assert out.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                                   **F32)
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(getattr(module, name).numpy(),
                                       variables["batch_stats"][key], **F32)
    ref = jbn.FusedBatchNormAct(use_running_average=True,
                                dtype=jnp.float32).apply(variables, xs[0],
                                                         residual=res)
    with torch.no_grad():
        out = module.eval()(nchw(xs[0]), nchw(res))
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, **F32)


@pytest.mark.parametrize("layout", ["transposed", "strided_rows",
                                    "contiguous_nchw"])
def test_wrapper_raises_rather_than_copying(layout):
    """The row-major (M, C) layout is checked on every device: a view that
    is not row-major raises instead of being copied."""
    x = torch.randn(8, 16, 4, 4).to(memory_format=torch.channels_last)
    if layout == "contiguous_nchw":
        with pytest.raises(ValueError, match="channels_last"):
            tbn.FusedBatchNormAct(16, dtype=torch.float32)(x.contiguous())
        return
    rows = tbn.as_rows(x)
    bad = (rows.t().contiguous().t() if layout == "transposed"
           else torch.randn(rows.shape[0], 32)[:, :16])
    with pytest.raises(ValueError, match="row-major"):
        tbn.bn_stats(bad)
    ones = torch.ones(16)
    with pytest.raises(ValueError, match="row-major"):
        tbn.bn_apply(rows, ones, ones, ones, ones, bad, relu=True)
