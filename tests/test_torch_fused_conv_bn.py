"""The port's fused 3x3 conv+BatchNorm op (distributeddeeplearning_tpu_torch/
ops/fused_conv_bn.py) against the JAX package's, on the CPU.

Each plain version of kernels #11-#13 against its JAX wrapper (``_fwd``,
``_bwd_dx``, ``_bwd_dw``) running the Pallas kernel in interpret mode, on
f32 and bf16 inputs: at (B, H, W, Cin -> Cout) = (2, 8, 6, 8 -> 16) with
the prologue off, on without ReLU, and on with ReLU; at (2, 32, 64, 8 ->
16), where the JAX grid cuts each image into four row blocks whose halos
cross their borders; and at (2, 7, 7, 16 -> 8), an odd side and Cin >
Cout. Then the autograd function's outputs and all six cotangents against
``jax.vjp`` of ``bn_conv3x3_stats``, ``conv3x3_stats`` (the op without the
prologue) against its JAX counterpart, and the wrappers' layout checks.

The port keeps its weight as (Cout, Cin, 3, 3), the JAX package as HWIO
(3, 3, Cin, Cout): ``w.permute(2, 3, 1, 0)``, and dw comes back the same
way.

Tolerances, as in test_torch_fused_linear_bn.py: f32 outputs differ only in
summation order (1e-5 of the column's largest |ref|, a column being one
output channel over all pixels, or one (tap, input channel) of dw over the
output channels). A bf16 output is rounded once from f32 values that may
differ in their last bits, so it may sit one bf16 ulp away: 2^-7 of the
column's largest |ref|. The sums are held within 1e-5 of the column's sum
of |terms|; the forward's are over y as stored, so where a bf16 y differs,
they also carry that difference (the column's sum of |y - y_ref| and of
|y^2 - y_ref^2|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops import fused_conv_bn as jfc
from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as tfc
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

# (B, H, W, Cin, Cout)
SHAPES = {"small": (2, 8, 6, 8, 16), "row_blocks": (2, 32, 64, 8, 16),
          "odd_side": (2, 7, 7, 16, 8)}
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (bn, relu): the prologue off (conv3x3_stats), on without ReLU, and on
# with ReLU (the bottleneck's 3x3).
VARIANTS = {"plain": (False, False), "bn": (True, False),
            "bn_relu": (True, True)}
CASES = [("small", v) for v in VARIANTS] + [("row_blocks", "bn_relu"),
                                            ("odd_side", "bn_relu")]
SUM_TOL = 1e-5


@pytest.fixture(autouse=True)
def no_kernel_launch():
    """A CPU tensor takes the plain version: no kernel is counted."""
    names = ("fwd_launches", "bwd_dx_launches", "bwd_dw_launches")
    before = [getattr(tfc, n) for n in names]
    yield
    assert [getattr(tfc, n) for n in names] == before


def _arr(rng, shape, dtype, scale=1.0):
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
    """x (B, H, W, Cin), w (Cout, Cin, 3, 3) and its JAX HWIO transpose,
    the prologue's vectors (mu, inv, gamma, beta), dy and y (B, H, W,
    Cout), ds and dss (Cout,)."""
    b, h, w_, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = _arr(rng, (b, h, w_, cin), dtype)
    w, _ = _arr(rng, (cout, cin, 3, 3), dtype, (9 * cin) ** -0.5)
    jw = jnp.asarray(w.float().permute(2, 3, 1, 0).numpy()).astype(
        DTYPES[dtype][1])
    vecs = [_vec(rng, cin, -0.3, 0.3), _vec(rng, cin, 0.5, 2.0),
            _vec(rng, cin, 0.5, 1.5), _vec(rng, cin, -0.3, 0.3)]
    dy = _arr(rng, (b, h, w_, cout), dtype)
    y = _arr(rng, (b, h, w_, cout), dtype)
    ds, dss = _vec(rng, cout, -0.1, 0.1), _vec(rng, cout, -0.1, 0.1)
    return dict(x=x, w=(w, jw), vecs=vecs, dy=dy, y=y, ds=ds, dss=dss)


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32), np.float64)


def _rows(a: np.ndarray) -> np.ndarray:
    return a.reshape(-1, a.shape[-1])


def _close(out: torch.Tensor, ref) -> None:
    """Per column of the (rows, C) view: f32 1e-5 of the column's largest
    |ref|; bf16 one ulp of it."""
    ref = _rows(_np(ref))
    got = _rows(out.double().numpy())
    assert got.shape == ref.shape
    col = np.abs(ref).max(axis=0, keepdims=True) + 1e-30
    rtol = 1e-5 if out.dtype == torch.float32 else 2.0 ** -7
    assert (np.abs(got - ref) <= rtol * col).all(), np.abs(got - ref).max()


def _close_sum(out: torch.Tensor, ref, terms, extra=0.0) -> None:
    """A column sum within SUM_TOL of its sum of |terms| plus ``extra``."""
    bound = SUM_TOL * np.abs(_rows(terms)).sum(axis=0) + extra + 1e-30
    err = np.abs(out.double().numpy() - _np(ref))
    assert (err <= bound).all(), (err / bound).max()


def _dw_rows(dw) -> np.ndarray:
    """A (Cout, Cin, 3, 3) weight as its (Cout, 9 * Cin) rows: columns are
    (tap, input channel), as the kernel's dw product lays them out."""
    return np.asarray(dw, np.float64).transpose(0, 2, 3, 1).reshape(
        dw.shape[0], -1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape,variant", CASES)
def test_fwd_matches_pallas(shape, dtype, variant):
    bn, relu = VARIANTS[variant]
    d = _inputs(SHAPES[shape], dtype, 0)
    (x, jx), (w, jw) = d["x"], d["w"]
    tv, jv = zip(*d["vecs"])
    y, s, ss = tfc.conv3x3_bn_fwd(x, *tv, w, relu=relu, bn=bn)
    assert y.dtype == x.dtype and y.is_contiguous()
    assert s.dtype == ss.dtype == torch.float32
    ry, rs, rss = jfc._fwd(jx, *jv, jw, relu, bn, interpret=True)
    _close(y, ry)
    yp, yr = _rows(y.double().numpy()), _rows(_np(ry))
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
    dx, db, dg = tfc.conv3x3_bn_bwd_dx(dy, y, ds, dss, w, x, *tv, relu=relu,
                                       bn=bn)
    rdx, rdb, rdg = jfc._bwd_dx(jdy, jy, jds, jdss, jw, jx, *jv, relu, bn,
                                interpret=True)
    assert dx.dtype == x.dtype
    _close(dx, rdx)
    if not bn:
        assert db is None and dg is None
        return
    # The terms of the sums: dz (the ReLU-masked da) and dz * xh, from the
    # plain version's own arithmetic.
    mu, inv, gamma, beta = (v.double().numpy() for v in tv)
    dyt = tfc._dy_total(dy, y, ds, dss)
    da = tfc._conv(dyt, w.flip(2, 3).transpose(0, 1)).double().numpy()
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
    dw = tfc.conv3x3_bn_bwd_dw(x, *tv, dy, y, ds, dss, relu=relu, bn=bn)
    ref = jfc._bwd_dw(jx, *jv, jdy, jy, jds, jdss, relu, bn, interpret=True)
    assert dw.shape == w.shape and dw.dtype == x.dtype
    ref_oihw = _np(ref).transpose(3, 2, 0, 1)
    got = torch.from_numpy(_dw_rows(dw.double().numpy())).to(dw.dtype)
    _close(got, _dw_rows(ref_oihw))


def _autograd_case(seed: int):
    d = _inputs(SHAPES["small"], "float32", seed)
    (x, jx), (w, jw) = d["x"], d["w"]
    tv, jv = zip(*d["vecs"])
    cots = [d[k] for k in ("dy", "ds", "dss")]
    return x, jx, w, jw, tv, jv, cots


def test_autograd_matches_jax_vjp():
    """Outputs and all six cotangents of the op with the prologue and ReLU
    at (2, 8, 6, 8 -> 16), f32, against ``jax.vjp`` of
    ``bn_conv3x3_stats`` (its custom VJP over the Pallas kernels)."""
    x, jx, w, jw, tv, jv, cots = _autograd_case(3)
    leaves = [t.clone().requires_grad_() for t in (x, *tv, w)]
    outs = tfc.bn_conv3x3_stats(*leaves, True, True)
    torch.autograd.backward(outs, [t for t, _ in cots])
    refs, vjp = jax.vjp(lambda *a: jfc.bn_conv3x3_stats(*a, True, True),
                        jx, *jv, jw)
    ref_grads = vjp(tuple(j for _, j in cots))
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    names = ("x", "mu", "inv", "gamma", "beta")
    for name, leaf, ref in zip(names, leaves, ref_grads):
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(
        leaves[-1].grad.numpy(),
        np.asarray(ref_grads[-1]).transpose(3, 2, 0, 1), rtol=1e-5,
        atol=1e-5, err_msg="w")


def test_conv3x3_stats_matches_jax():
    """The identity-prologue op (``bn=False``: the vectors are not read and
    get no gradient) and its x and w cotangents against the JAX
    ``conv3x3_stats``."""
    x, jx, w, jw, _, _, cots = _autograd_case(4)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    outs = tfc.conv3x3_stats(xl, wl)
    torch.autograd.backward(outs, [t for t, _ in cots])
    refs, vjp = jax.vjp(jfc.conv3x3_stats, jx, jw)
    dx, dw = vjp(tuple(j for _, j in cots))
    for out, ref in zip(outs, refs):
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(xl.grad.numpy(), dx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wl.grad.numpy(),
                               np.asarray(dw).transpose(3, 2, 0, 1),
                               rtol=1e-5, atol=1e-5)


def _layout_cases():
    x = torch.randn(2, 8, 6, 16)
    w = torch.randn(8, 16, 3, 3)
    return {
        "nchw_contiguous_x": (torch.randn(2, 16, 8, 6).permute(0, 2, 3, 1),
                              w),
        "strided_x": (torch.randn(2, 8, 6, 32)[..., ::2], w),
        "three_d_x": (torch.randn(2, 48, 16), w),
        "cin_not_multiple_of_8": (torch.randn(2, 8, 6, 12),
                                  torch.randn(8, 12, 3, 3)),
        "cout_not_multiple_of_8": (x, torch.randn(12, 16, 3, 3)),
        "1x1_w": (x, torch.randn(8, 16, 1, 1)),
        "float64": (x.double(), w.double()),
    }


@pytest.mark.parametrize("case", list(_layout_cases()))
def test_wrappers_raise_rather_than_copying(case):
    x, w = _layout_cases()[case]
    error = TypeError if case == "float64" else ValueError
    with pytest.raises(error):
        tfc.conv3x3_bn_fwd(x, None, None, None, None, w, relu=False,
                           bn=False)
    b, h, wd = x.shape[:3] if x.dim() == 4 else (2, 8, 6)
    n = w.shape[0]
    dy, y, ds, dss = (torch.zeros(b, h, wd, n, dtype=x.dtype),
                      torch.zeros(b, h, wd, n, dtype=x.dtype),
                      torch.zeros(n), torch.zeros(n))
    with pytest.raises(error):
        tfc.conv3x3_bn_bwd_dx(dy, y, ds, dss, w, x, None, None, None, None,
                              relu=False, bn=False)
    if case.endswith("_w"):
        return  # dw does not read w
    with pytest.raises(error):
        tfc.conv3x3_bn_bwd_dw(x, None, None, None, None, dy, y, ds, dss,
                              relu=False, bn=False)


def test_wrappers_raise_on_a_bad_vector():
    """With the prologue on, each vector must be float32 (Cin,)."""
    x, w = torch.randn(2, 8, 6, 16), torch.randn(8, 16, 3, 3)
    good = torch.ones(16)
    for bad in (torch.ones(8), torch.ones(16, dtype=torch.float64),
                torch.ones(32)[::2]):
        with pytest.raises(ValueError):
            tfc.conv3x3_bn_fwd(x, good, bad, good, good, w, relu=True,
                               bn=True)
