"""The port's flash attention (distributeddeeplearning_tpu_torch/ops/
flash_attention.py) and attention dispatch against the JAX package.

On the CPU the port's plain flash versions are held against the Pallas
kernels in interpret mode: o against ``flash_attention``, lse against
``_fwd``, and the gradients against ``jax.vjp`` of ``flash_attention``, with
and without dropout. The CUDA kernels are held against the plain versions on
the card in tests/test_torch_cuda.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.ops import attention as jattn
from distributeddeeplearning_tpu.ops import masks as jmasks
from distributeddeeplearning_tpu_torch.ops import attention as tattn
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.ops import masks as tmasks
from tests.torch_port_helpers import (BF16, F32,  # noqa: F401
                                      one_torch_thread)

# The JAX ops package re-exports the function under the module's name.
jfa = importlib.import_module("distributeddeeplearning_tpu.ops.flash_attention")

B, H, D = 2, 2, 16


def _qkv(seed, s, b=B, h=H, d=D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _mask(s, lengths):
    m = np.zeros((len(lengths), s), np.int32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1
    return m


def _jax_flash(q, k, v, mask, causal, dtype):
    """(o, lse) of the Pallas forward in interpret mode."""
    b, s, h, d = q.shape
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    o = jfa.flash_attention(jq, jk, jv, jnp.asarray(mask), causal=causal,
                            block_q=32, block_k=32, interpret=True)

    def to_bh(x):
        return x.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    mask_bh = jnp.broadcast_to(jnp.asarray(mask)[:, None, :],
                               (b, h, s)).reshape(b * h, s)
    _, lse = jfa._fwd(to_bh(jq), to_bh(jk), to_bh(jv), mask_bh,
                      jnp.zeros((5,), jnp.int32), scale=d ** -0.5,
                      block_q=512, block_k=1024, interpret=True,
                      causal=causal, dropout_rate=0.0)
    return (np.asarray(o.astype(jnp.float32)),
            np.asarray(lse).reshape(b, h, s))


@pytest.mark.parametrize("s,causal,lengths,dtype", [
    (64, True, (64, 50), "float32"),        # ragged padding, causal
    (64, False, (64, 50), "float32"),       # ragged padding, bidirectional
    (64, True, (40, 0), "float32"),         # a fully masked batch row
    (64, False, (40, 0), "float32"),
    (200, True, (200, 137), "float32"),     # S the JAX side pads to 256
    (64, True, (64, 33), "bfloat16"),
])
def test_plain_flash_matches_pallas(s, causal, lengths, dtype):
    q, k, v = _qkv(s, s)
    mask = _mask(s, lengths)
    o_ref, lse_ref = _jax_flash(q, k, v, mask, causal, getattr(jnp, dtype))
    tdt = getattr(torch, dtype)
    o, lse = tfa.flash_attention_fwd(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(mask), causal=causal)
    assert o.dtype == tdt and o.shape == (B, s, H, D)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, s)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(o.float().numpy(), o_ref, **tol)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **F32)
    if 0 in lengths:  # flash semantics: zero output, lse pinned to 0
        row = lengths.index(0)
        assert not o[row].float().any() and not lse[row].any()


def test_cpu_dispatch_takes_plain_version_and_never_falls_back():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 32))
    before = tfa.launches
    o = tfa.flash_attention(q, k, v, causal=True)
    ref, _ = tfa.flash_attention_reference(q, k, v, None, causal=True)
    torch.testing.assert_close(o, ref, rtol=0, atol=0)
    assert tfa.launches == before
    # Any other device goes to the kernel's wrapper, which refuses what the
    # kernel cannot take instead of computing it some other way.
    meta = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tfa.flash_attention(meta, meta, meta)


def _misaligned_bf16(q):
    """q's shape in bf16, starting 2 bytes past a 16-byte boundary."""
    return torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)


@pytest.mark.parametrize("change,exc", [
    (lambda q: q.to(torch.float16), TypeError),
    (lambda q: q[..., :8], ValueError),           # D not in {64, 128}
    (lambda q: q.transpose(1, 3).contiguous().transpose(1, 3), ValueError),
    (lambda q: q, ValueError),                    # CPU tensors
    (_misaligned_bf16, ValueError),               # bf16 rows off 16 bytes
])
def test_kernel_wrapper_rejects_what_it_cannot_take(change, exc):
    q, k, v = (torch.zeros((1, 8, 2, 64)) for _ in range(3))
    q, k, v = change(q), change(k), change(v)
    mask = torch.ones((1, 8), dtype=torch.int32)
    # A bf16 row off 16 bytes is refused before the device is looked at:
    # every bf16 kernel copies rows with 16-byte cp.async copies.
    match = "16 bytes" if q.dtype == torch.bfloat16 else None
    with pytest.raises(exc, match=match):
        tfa.flash_attention_cuda(q, k, v, mask, causal=True)
    # The backward wrappers refuse the same.
    lse = torch.zeros((1, 2, 8))
    for fn in (tfa.flash_attention_dq_cuda, tfa.flash_attention_dkv_cuda):
        with pytest.raises(exc, match=match):
            fn(q, k, v, mask, lse, q, lse, causal=True)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_multihead_attention_matches_jax(impl, causal):
    s = 48
    q, k, v = _qkv(7, s)
    mask = _mask(s, (s, 29)).astype(bool)
    ref = jattn.multihead_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask), impl=impl,
        causal=causal, dtype=jnp.float32)
    out = tattn.multihead_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
        impl=impl, causal=causal, dtype=torch.float32)
    assert out.shape == (B, s, H * D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_dense_fully_masked_row_averages_like_jax():
    """The dense impl softmaxes finfo.min scores: a fully masked row is a
    uniform average of v, unlike flash's zero row."""
    s = 16
    q, k, v = _qkv(3, s)
    mask = _mask(s, (s, 0)).astype(bool)
    ref = jattn.multihead_attention(
        *(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(mask),
        impl="dense", causal=False, dtype=jnp.float32)
    out = tattn.multihead_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(mask),
        impl="dense", causal=False, dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    assert out[1].abs().sum() > 0


@pytest.mark.parametrize("impl,exc", [("ring", NotImplementedError),
                                      ("zigzag", NotImplementedError),
                                      ("nope", ValueError)])
def test_multihead_attention_rejects_unported_impls(impl, exc):
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(exc):
        tattn.multihead_attention(q, q, q, None, impl=impl, causal=True,
                                  dtype=torch.float32)


def test_attention_dropout_raises_only_in_training():
    """Dropout runs only in training, and there it needs an int32 seed or a
    torch.Generator to draw one from."""
    q = torch.zeros((1, 4, 2, 8))
    kw = dict(impl="dense", causal=True, dtype=torch.float32,
              dropout_rate=0.1)
    tattn.multihead_attention(q, q, q, None, training=False, **kw)
    with pytest.raises(ValueError, match="dropout_rng"):
        tattn.multihead_attention(q, q, q, None, training=True, **kw)
    tattn.multihead_attention(q, q, q, None, training=True, dropout_rng=3,
                              **kw)
    tattn.multihead_attention(q, q, q, None, training=True,
                              dropout_rng=torch.Generator().manual_seed(0),
                              **kw)


@pytest.mark.parametrize("qb,kb,sq,sk", [(0, 0, 8, 8), (1, 0, 8, 16),
                                         (2, 3, 16, 8)])
def test_block_causal_mask_matches_jax(qb, kb, sq, sk):
    ref = np.asarray(jmasks.block_causal_mask(qb, kb, sq, sk))
    np.testing.assert_array_equal(
        tmasks.block_causal_mask(qb, kb, sq, sk).numpy(), ref)


def _jax_flash_vjp(q, k, v, g, mask, causal, dtype, rate, seed):
    """(o, dq, dk, dv) of the Pallas kernels in interpret mode, by jax.vjp
    with cotangent g."""
    def f(jq, jk, jv):
        return jfa.flash_attention(jq, jk, jv, jnp.asarray(mask),
                                   causal=causal, block_q=32, block_k=32,
                                   interpret=True, dropout_rate=rate,
                                   dropout_seed=jnp.int32(seed))

    o, vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(g, dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (o, *grads)]


def _port_flash_vjp(q, k, v, g, mask, causal, dtype, rate, seed):
    """(o, dq, dk, dv) of the port's autograd function on the CPU."""
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    o = tfa.flash_attention(tq, tk, tv, torch.from_numpy(mask),
                            causal=causal, dropout_rate=rate,
                            dropout_seed=seed)
    o.backward(torch.from_numpy(g).to(dtype))
    return [x.detach().float().numpy()
            for x in (o, tq.grad, tk.grad, tv.grad)]


@pytest.mark.parametrize("s,causal,lengths,dtype,rate", [
    (64, True, (64, 64), "float32", 0.0),      # causal, tile skip
    (64, True, (50, 0), "float32", 0.0),       # padded + fully masked row
    (160, True, (160, 117), "float32", 0.1),   # S the JAX side pads to 256
    (64, False, (64, 41), "float32", 0.5),     # full, padded, dropout
    (64, True, (64, 47), "bfloat16", 0.1),
])
def test_plain_backward_matches_pallas_vjp(s, causal, lengths, dtype, rate):
    """The plain forward and backward (the kernels' CPU versions) against
    jax.vjp of the Pallas kernels in interpret mode. f32 at F32 and bf16 at
    BF16, each gradient relative to its largest |ref|: the two sides
    accumulate in another order and, in bf16, round p and ds at the same
    points from slightly different f32 values."""
    q, k, v = _qkv(s + 11, s)
    g = np.random.default_rng(s).standard_normal(q.shape).astype(np.float32)
    mask = _mask(s, lengths)
    seed = -123456789
    ref = _jax_flash_vjp(q, k, v, g, mask, causal, getattr(jnp, dtype), rate,
                         seed)
    out = _port_flash_vjp(q, k, v, g, mask, causal, getattr(torch, dtype),
                          rate, seed)
    tol = F32 if dtype == "float32" else BF16
    for name, a, b in zip(("o", "dq", "dk", "dv"), out, ref):
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a / scale, b / scale, err_msg=name, **tol)
    if 0 in lengths:  # a fully masked row contributes nothing
        row = lengths.index(0)
        assert not any(x[row].any() for x in out)


def test_plain_forward_dropout_matches_pallas_bitwise_mask():
    """With dropout, o and lse against the Pallas forward: the same hash
    mask drops the same probabilities."""
    s = 64
    q, k, v = _qkv(5, s)
    mask = _mask(s, (64, 30))
    for seed in (7, -(2 ** 31)):
        ref = jfa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                  jnp.asarray(mask), causal=True,
                                  block_q=32, block_k=32, interpret=True,
                                  dropout_rate=0.3,
                                  dropout_seed=jnp.int32(seed))
        o, _ = tfa.flash_attention_fwd(
            *(torch.from_numpy(x) for x in (q, k, v)),
            torch.from_numpy(mask), causal=True, dropout_rate=0.3,
            dropout_seed=seed)
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), **F32)


def test_flash_dropout_needs_a_seed():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="dropout_seed"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)


@pytest.mark.parametrize("causal", [True, False])
def test_dense_and_flash_drop_the_same_probabilities(causal):
    """Inside the port, dense (materialized hash mask) and flash (the
    mask regenerated per tile) give the same output and gradients at one
    seed; a different seed gives a different output."""
    s = 40
    q, k, v = (torch.from_numpy(x) for x in _qkv(9, s))
    mask = torch.ones((B, s), dtype=torch.bool)
    outs = {}
    for impl in ("dense", "flash"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = tattn.multihead_attention(
            *leaves, mask, impl=impl, causal=causal, dtype=torch.float32,
            dropout_rate=0.2, dropout_rng=42, training=True)
        out.square().sum().backward()
        outs[impl] = [out.detach()] + [x.grad for x in leaves]
    for a, b in zip(outs["dense"], outs["flash"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **F32)
    other = tattn.multihead_attention(
        q, k, v, mask, impl="flash", causal=causal, dtype=torch.float32,
        dropout_rate=0.2, dropout_rng=43, training=True)
    assert not torch.allclose(other, outs["flash"][0])
