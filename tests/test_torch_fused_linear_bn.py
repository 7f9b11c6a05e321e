"""The port's fused matmul+BatchNorm op (distributeddeeplearning_tpu_torch/
ops/fused_linear_bn.py) against the JAX package's, on the CPU.

Each plain version of kernels #8-#10 against its JAX wrapper (``_fwd``,
``_bwd_dx``, ``_bwd_dw``) running the Pallas kernel in interpret mode, on
f32 and bf16 inputs: at (M, K, N) = (1024, 16, 32) (two 512-row tiles of
the JAX grid) with the prologue off, on without ReLU, and on with ReLU, and
at (200, 24, 8) (a ragged M) with the prologue and ReLU on. Then the
autograd function's outputs and every cotangent (dmu and dinv among them)
against ``jax.vjp`` of ``bn_linear_stats`` at one tile; then the wrappers'
layout checks.

The port keeps its weight as (N, K), the JAX package as (K, N): the same
numbers transposed, and dw comes back transposed too.

Tolerances: f32 outputs differ only in summation order (1e-5 of the
column's largest |ref|). A bf16 output is rounded once from f32 values
that may differ in their last bits, so it may sit one bf16 ulp away: 2^-7
of the column's largest |ref|. The forward's sums are over y as stored, so
where a bf16 y differs, the sums differ by exactly that: they are held
within 1e-5 of the column's sum of |terms| plus the column's sum of
|y - y_ref| (and |y^2 - y_ref^2|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops import fused_linear_bn as jflb
from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as tflb
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

SHAPES = {"two_tiles": (1024, 16, 32), "ragged": (200, 24, 8)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (bn, relu): the prologue off (conv1, the downsample), on (conv3), and on
# without ReLU.
VARIANTS = {"plain": (False, False), "bn": (True, False),
            "bn_relu": (True, True)}
CASES = [("two_tiles", v) for v in VARIANTS] + [("ragged", "bn_relu")]
SUM_TOL = 1e-5


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """A CPU tensor takes the plain version: no kernel is counted."""
    names = ("fwd_launches", "bwd_dx_launches", "bwd_dw_launches")
    before = [getattr(tflb, n) for n in names]
    yield
    assert [getattr(tflb, n) for n in names] == before


def _mat(rng, shape, dtype, scale=1.0):
    """The same values for both sides: torch in ``dtype``, JAX in the
    matching dtype (bf16 values are exact in both)."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _vec(rng, n, low=-1.0, high=1.0):
    a = rng.uniform(low, high, n).astype(np.float32)
    return torch.from_numpy(a), jnp.asarray(a)


def _inputs(shape, dtype, seed):
    """x (M, K), w (N, K) and its JAX (K, N) transpose, the prologue's
    vectors (mu, inv, gamma, beta), dy and y (M, N), ds and dss (N,)."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = _mat(rng, (m, k), dtype)
    w, _ = _mat(rng, (n, k), dtype, 0.3)
    jw = jnp.asarray(w.float().numpy().T).astype(DTYPES[dtype][1])
    vecs = [_vec(rng, k, -0.3, 0.3), _vec(rng, k, 0.5, 2.0),
            _vec(rng, k, 0.5, 1.5), _vec(rng, k, -0.3, 0.3)]
    dy, y = _mat(rng, (m, n), dtype), _mat(rng, (m, n), dtype)
    ds, dss = _vec(rng, n, -0.1, 0.1), _vec(rng, n, -0.1, 0.1)
    return dict(x=x, w=(w, jw), vecs=vecs, dy=dy, y=y, ds=ds, dss=dss)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _close(out: torch.Tensor, ref) -> None:
    """f32: 1e-5 of the column's largest |ref|; bf16: one ulp of it."""
    ref = _np(ref)
    got = out.double().numpy()
    assert got.shape == ref.shape
    col = np.abs(ref).max(axis=0, keepdims=True) + 1e-30
    rtol = 1e-5 if out.dtype == torch.float32 else 2.0 ** -7
    assert (np.abs(got - ref) <= rtol * col).all(), np.abs(got - ref).max()


def _close_sum(out: torch.Tensor, ref, terms, extra=0.0) -> None:
    """A column sum within SUM_TOL of its sum of |terms| plus ``extra``."""
    bound = SUM_TOL * np.abs(terms).sum(axis=0) + extra + 1e-30
    err = np.abs(out.double().numpy() - _np(ref))
    assert (err <= bound).all(), (err / bound).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,variant", CASES)
def test_fwd_matches_pallas(shape, dtype, variant):
    bn, relu = VARIANTS[variant]
    d = _inputs(SHAPES[shape], dtype, 0)
    (x, jx), (w, jw) = d["x"], d["w"]
    tv, jv = zip(*d["vecs"])
    y, s, ss = tflb.linear_bn_fwd(x, *tv, w, relu=relu, bn=bn)
    assert y.dtype == x.dtype and s.dtype == ss.dtype == torch.float32
    ry, rs, rss = jflb._fwd(jx, *jv, jw, relu, bn, interpret=True)
    _close(y, ry)
    yp, yr = y.double().numpy(), _np(ry)
    _close_sum(s, rs, yr, np.abs(yp - yr).sum(axis=0))
    _close_sum(ss, rss, yr * yr, np.abs(yp * yp - yr * yr).sum(axis=0))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,variant", CASES)
def test_bwd_dx_matches_pallas(shape, dtype, variant):
    bn, relu = VARIANTS[variant]
    d = _inputs(SHAPES[shape], dtype, 1)
    (x, jx), (w, jw) = d["x"], d["w"]
    (dy, jdy), (y, jy), (ds, jds), (dss, jdss) = (d["dy"], d["y"], d["ds"],
                                                  d["dss"])
    tv, jv = zip(*d["vecs"])
    dx, db, dg = tflb.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *tv,
                                       relu=relu, bn=bn)
    rdx, rdb, rdg = jflb._bwd_dx(jdy, jy, jds, jdss, jw, jx, *jv, relu, bn,
                                 interpret=True)
    assert dx.dtype == x.dtype
    _close(dx, rdx)
    if not bn:
        assert db is None and dg is None
        return
    # The terms of the sums: dz (the ReLU-masked da) and dz * xh, from the
    # plain version's own arithmetic in float64.
    mu, inv, gamma, beta = (v.double().numpy() for v in tv)
    dyt = tflb._dy_total(dy, y, ds, dss).double().numpy()
    da = dyt @ w.double().numpy()
    xh = (x.double().numpy() - mu) * inv
    dz = np.where(xh * gamma + beta > 0, da, 0.0) if relu else da
    _close_sum(db, rdb, dz)
    _close_sum(dg, rdg, dz * xh)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,variant", CASES)
def test_bwd_dw_matches_pallas(shape, dtype, variant):
    bn, relu = VARIANTS[variant]
    d = _inputs(SHAPES[shape], dtype, 2)
    (x, jx), (w, _) = d["x"], d["w"]
    (dy, jdy), (y, jy), (ds, jds), (dss, jdss) = (d["dy"], d["y"], d["ds"],
                                                  d["dss"])
    tv, jv = zip(*d["vecs"])
    dw = tflb.linear_bn_bwd_dw(x, *tv, dy, y, ds, dss, relu=relu, bn=bn)
    ref = jflb._bwd_dw(jx, *jv, jdy, jy, jds, jdss, relu, bn, interpret=True)
    assert dw.shape == w.shape and dw.dtype == x.dtype
    _close(dw, jnp.asarray(ref).T)


@pytest.mark.parametrize("variant", ["plain", "bn_relu"])
def test_autograd_matches_jax_vjp(variant):
    """Outputs and every cotangent of the op, at one tile: (64, 16, 8),
    f32, against ``jax.vjp`` of ``bn_linear_stats`` (its custom VJP over
    the Pallas kernels)."""
    bn, relu = VARIANTS[variant]
    d = _inputs((64, 16, 8), "float32", 3)
    (x, jx), (w, jw) = d["x"], d["w"]
    tv, jv = zip(*d["vecs"])
    (dy, jdy), (ds, jds), (dss, jdss) = d["dy"], d["ds"], d["dss"]
    leaves = [t.clone().requires_grad_() for t in (x, *tv, w)]
    if bn:
        outs = tflb.bn_linear_stats(*leaves, relu, bn)
    else:
        outs = tflb.linear_stats(leaves[0], leaves[-1])
    torch.autograd.backward(outs, (dy, ds, dss))
    refs, vjp = jax.vjp(
        lambda *a: jflb.bn_linear_stats(*a, relu, bn), jx, *jv, jw)
    ref_grads = vjp((jdy, jds, jdss))
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    names = ("x", "mu", "inv", "gamma", "beta")
    for name, leaf, ref in zip(names, leaves, ref_grads):
        if bn or name == "x":
            np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        else:  # JAX returns zeros for the unread vectors; torch None
            assert leaf.grad is None and not np.asarray(ref).any(), name
    np.testing.assert_allclose(leaves[-1].grad.numpy(),
                               np.asarray(ref_grads[-1]).T, rtol=1e-5,
                               atol=1e-5, err_msg="w")


def _layout_cases():
    x = torch.randn(64, 16)
    w = torch.randn(8, 16)
    return {
        "transposed_x": (torch.randn(16, 64).t(), w),
        "strided_x": (torch.randn(64, 32)[:, ::2], w),
        "transposed_w": (x, torch.randn(16, 8).t()),
        "k_not_multiple_of_8": (torch.randn(64, 12), torch.randn(8, 12)),
        "n_not_multiple_of_8": (x, torch.randn(12, 16)),
        "float64": (x.double(), w.double()),
    }


@pytest.mark.parametrize("case", list(_layout_cases()))
def test_wrappers_raise_rather_than_copying(case):
    x, w = _layout_cases()[case]
    error = TypeError if case == "float64" else ValueError
    with pytest.raises(error):
        tflb.linear_bn_fwd(x, None, None, None, None, w, relu=False,
                           bn=False)
    m, n = x.shape[0], w.shape[0]
    dy, y, ds, dss = (torch.zeros(m, n, dtype=x.dtype),
                      torch.zeros(m, n, dtype=x.dtype), torch.zeros(n),
                      torch.zeros(n))
    with pytest.raises(error):
        tflb.linear_bn_bwd_dx(dy, y, ds, dss, w, x, None, None, None, None,
                              relu=False, bn=False)
    if case.endswith("_w"):
        return  # dw does not read w
    with pytest.raises(error):
        tflb.linear_bn_bwd_dw(x, None, None, None, None, dy, y, ds, dss,
                              relu=False, bn=False)


def test_wrappers_raise_on_a_bad_vector():
    """With the prologue on, each vector must be float32 (K,)."""
    x, w = torch.randn(64, 16), torch.randn(8, 16)
    good = torch.ones(16)
    for bad in (torch.ones(8), torch.ones(16, dtype=torch.float64),
                torch.ones(32)[::2]):
        with pytest.raises(ValueError):
            tflb.linear_bn_fwd(x, good, bad, good, good, w, relu=True,
                               bn=True)
