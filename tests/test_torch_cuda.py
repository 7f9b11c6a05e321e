"""The port's CUDA kernels on the card, against their plain versions:
the flash forward (with and without dropout), the dq and dk/dv backward
kernels, and a tiny GPT's training step on the card against the CPU; the
four BatchNorm kernels, and a ``resnet_nano`` training step through them
against the plain path on the CPU; the three matmul+BatchNorm kernels, and
a ``resnet_nano`` ``fused_block`` training step through them against the
CPU; the three 3x3 conv+BatchNorm kernels, and a ``resnet_nano``
``fused_block`` + ``fused_conv3`` training step through them against the
CPU.

Every test here needs an NVIDIA GPU and skips without one. The file imports
nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import resnet as tresnet
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa
from distributeddeeplearning_tpu_torch.ops import fused_batchnorm as tbn
from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as tfc
from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as tflb
from distributeddeeplearning_tpu_torch.train.losses import (
    causal_lm_loss, smoothed_softmax_ce)

# Kernel vs plain version on the card. f32: the same f32 arithmetic summed
# in another order. bf16: o is rounded to bf16 at the end.
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); run on the card with -m cuda")
    return torch.device("cuda")


def _mask(s, lengths, device):
    m = torch.zeros((len(lengths), s), dtype=torch.int32)
    for i, n in enumerate(lengths):
        m[i, :n] = 1
    return m.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 65, 200])
def test_flash_kernel_matches_plain(cuda_device, dtype, d, causal, s):
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, s, 4, d)).astype(
        np.float32)).to(cuda_device, dtype) for _ in range(3))
    mask = _mask(s, (s, max(s // 2, 1), 0), cuda_device)
    before = tfa.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    ref_o, ref_lse = tfa.flash_attention_reference(q, k, v, mask, causal)
    tol = F32 if dtype == torch.float32 else BF16
    torch.testing.assert_close(o.float(), ref_o.float(), **tol)
    torch.testing.assert_close(lse, ref_lse, **F32)
    assert not o[2].float().any() and not lse[2].any()  # fully masked row


@pytest.mark.cuda
def test_flash_kernel_reads_strided_views(cuda_device):
    """q/k/v as head-split views of one fused (B, S, 3, H, D) projection:
    the kernel reads them through their strides without a copy."""
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 96, 3, 4, 64)).astype(
        np.float32)).to(cuda_device)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ref_o, ref_lse = tfa.flash_attention_reference(q, k, v, None, True)
    torch.testing.assert_close(o, ref_o, **F32)
    torch.testing.assert_close(lse, ref_lse, **F32)


@pytest.mark.cuda
def test_flash_model_on_card_matches_cpu(cuda_device):
    """A GPT at a kernel head dim (64) through the CUDA kernel on the card,
    against the same weights on the CPU through the plain version."""
    torch.manual_seed(0)
    cpu = tgpt.tiny_gpt(vocab_size=97, hidden_size=128, num_heads=2,
                        attention_impl="flash").eval()
    card = tgpt.tiny_gpt(vocab_size=97, hidden_size=128, num_heads=2,
                         attention_impl="flash").to(cuda_device).eval()
    card.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.default_rng(1).integers(1, 97, (2, 80)))
    mask = _mask(80, (80, 70), "cpu")
    before = tfa.launches
    with torch.no_grad():
        ref = cpu(ids, attention_mask=mask)
        out = card(ids.to(cuda_device), attention_mask=mask.to(cuda_device))
    assert tfa.launches == before + 2  # one per layer
    torch.testing.assert_close(out.cpu(), ref, **F32)


def _rows_close(out, ref, rtol, atol=0.0):
    """|out - ref| <= atol + rtol * max|ref| of each row (the last dim: one
    query or key position of one head). The kernels and the plain versions
    round p and ds to bf16 from f32 values summed in other orders, so a bf16
    error follows the row's scale."""
    out, ref = out.float(), ref.float()
    limit = atol + rtol * ref.abs().amax(dim=-1, keepdim=True)
    bad = (out - ref).abs() > limit
    assert not bad.any(), (f"{int(bad.sum())} elements over the row limit; "
                           f"max err {(out - ref).abs().max().item():.3e}")


# Backward kernels vs plain version, per row: f32 differs in summation
# order; bf16 in where ds and p_drop round (up to 2^-5 of the row's max).
# The absolute part covers rows that are zero in exact arithmetic (at S=1,
# or a causal first query, ds = p * (dp - delta) = 0): both sides hold f32
# rounding noise there, measured up to 1.5e-6 with unit-variance inputs.
GRAD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2 ** -5, 1e-5)}


def _inputs(device, dtype, b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32)).to(device, dtype) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 63, 65, 200, 1031])
def test_backward_kernels_match_plain(cuda_device, rate, dtype, d, causal, s):
    """dq and dk/dv kernels against the plain backward on the forward
    kernel's o and lse, with a ragged and a fully masked batch row. S=1031
    spans 17 of the bf16 kernels' 64-row tiles with a ragged last one, so
    their two-stage ring wraps several times."""
    q, k, v, do = _inputs(cuda_device, dtype, 3, s, 4, d, s * d)
    mask = _mask(s, (s, max(s // 2, 1), 0), cuda_device)
    seed = -20260101
    o, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=causal,
                                     dropout_rate=rate, dropout_seed=seed)
    before = (tfa.dq_launches, tfa.dkv_launches)
    grads = tfa.flash_attention_bwd(q, k, v, mask, o, lse, do, causal=causal,
                                    dropout_rate=rate, dropout_seed=seed)
    torch.cuda.synchronize()
    assert (tfa.dq_launches, tfa.dkv_launches) == (before[0] + 1,
                                                   before[1] + 1)
    refs = tfa.flash_attention_bwd_reference(q, k, v, mask, o, lse, do,
                                             causal, rate, seed)
    for g, ref in zip(grads, refs):
        assert g.dtype == dtype and g.shape == q.shape
        _rows_close(g, ref, *GRAD_TOL[dtype])
        assert not g[2].float().any()  # the fully masked batch row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_forward_dropout_matches_plain(cuda_device, dtype, d, causal):
    """The forward kernel with rate 0.1 drops exactly the plain version's
    probabilities (the hash mask in CUDA against ops/hash_dropout.py)."""
    q, k, v, _ = _inputs(cuda_device, dtype, 2, 150, 3, d, d)
    mask = _mask(150, (150, 77), cuda_device)
    for seed in (0, -1, 2 ** 31 - 1):
        o, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=causal,
                                         dropout_rate=0.1, dropout_seed=seed)
        ref_o, ref_lse = tfa.flash_attention_reference(
            q, k, v, mask, causal, 0.1, seed)
        tol = F32 if dtype == torch.float32 else BF16
        torch.testing.assert_close(o.float(), ref_o.float(), **tol)
        torch.testing.assert_close(lse, ref_lse, **F32)
        undropped, _ = tfa.flash_attention_fwd(q, k, v, mask, causal=causal)
        assert (o.float() - undropped.float()).abs().max() > 1e-3


@pytest.mark.cuda
def test_backward_kernels_read_strided_views(cuda_device):
    """q/k/v and do as head-split views of fused projections: read through
    their strides; the gradients come back contiguous."""
    rng = np.random.default_rng(1)
    qkv, go = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device)
        for shape in ((2, 96, 3, 4, 64), (2, 96, 2, 4, 64)))
    q, k, v = qkv.unbind(dim=2)
    do = go[:, :, 1]
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True, dropout_rate=0.2,
                                     dropout_seed=5)
    mask = torch.ones((2, 96), dtype=torch.int32, device=cuda_device)
    grads = tfa.flash_attention_bwd(q, k, v, mask, o, lse, do, causal=True,
                                    dropout_rate=0.2, dropout_seed=5)
    refs = tfa.flash_attention_bwd_reference(q, k, v, mask, o, lse, do,
                                             True, 0.2, 5)
    for g, ref in zip(grads, refs):
        assert g.is_contiguous()
        _rows_close(g, ref, *GRAD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("change,exc", [
    (lambda x: x.half(), TypeError),
    (lambda x: x[..., :32], ValueError),           # D not in {64, 128}
])
def test_backward_wrapper_raises_rather_than_falling_back(cuda_device,
                                                          change, exc):
    q, k, v, do = (change(x) for x in _inputs(cuda_device, torch.float32,
                                              1, 16, 2, 64, 0))
    mask = torch.ones((1, 16), dtype=torch.int32, device=cuda_device)
    lse = torch.zeros((1, 2, 16), device=cuda_device)
    before = (tfa.dq_launches, tfa.dkv_launches)
    with pytest.raises(exc):
        tfa.flash_attention_bwd(q, k, v, mask, q, lse, do, causal=True)
    with pytest.raises(exc):
        tfa.flash_attention_fwd(q, k, v, mask, causal=True)
    assert (tfa.dq_launches, tfa.dkv_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_repeats_bitwise(cuda_device, dtype):
    """Every gradient element is summed in one fixed order, without
    atomics: two runs of the dq and dk/dv kernels on the same inputs give
    the same bits, at both head dims, with dropout, over many tiles."""
    for d in (64, 128):
        q, k, v, do = _inputs(cuda_device, dtype, 2, 1031, 3, d, d + 1)
        mask = _mask(1031, (1031, 700), cuda_device)
        o, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=True,
                                         dropout_rate=0.1, dropout_seed=9)
        runs = [tfa.flash_attention_bwd(q, k, v, mask, o, lse, do,
                                        causal=True, dropout_rate=0.1,
                                        dropout_seed=9) for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_backward_takes_aligned_views_refuses_misaligned(cuda_device):
    """The bf16 kernels copy 16-byte pieces of rows: head-split views of a
    fused projection (rows 128 bytes apart) are read through their strides,
    a view 2 bytes off a 16-byte boundary raises before any launch."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((2, 96, 3, 4, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    do = torch.from_numpy(rng.standard_normal((2, 96, 4, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    mask = torch.ones((2, 96), dtype=torch.int32, device=cuda_device)
    o, lse = tfa.flash_attention_fwd(q, k, v, mask, causal=True)
    grads = tfa.flash_attention_bwd(q, k, v, mask, o, lse, do, causal=True)
    refs = tfa.flash_attention_bwd_reference(q, k, v, mask, o, lse, do,
                                             True)
    for g, ref in zip(grads, refs):
        _rows_close(g, ref, *GRAD_TOL[torch.bfloat16])

    off = torch.zeros(do.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(do.shape)
    off.copy_(do)
    before = (tfa.dq_launches, tfa.dkv_launches)
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.flash_attention_bwd(q, k, v, mask, o, lse, off, causal=True)
    assert (tfa.dq_launches, tfa.dkv_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_repeats_bitwise(cuda_device, d):
    """The bf16 forward sums each output element in one fixed order,
    without atomics: two runs on the same inputs give the same bits, with
    dropout, a ragged row and many key tiles, causal and full."""
    q, k, v, _ = _inputs(cuda_device, torch.bfloat16, 2, 1031, 3, d, d + 3)
    mask = _mask(1031, (1031, 700), cuda_device)
    for causal in (True, False):
        runs = [tfa.flash_attention_fwd(q, k, v, mask, causal=causal,
                                        dropout_rate=0.1, dropout_seed=9)
                for _ in range(2)]
        torch.cuda.synchronize()
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_bf16_forward_takes_aligned_views_refuses_misaligned(cuda_device):
    """The bf16 forward copies 16-byte pieces of rows: head-split views of
    a fused projection are read through their strides, and a view 2 bytes
    off a 16-byte boundary raises before any launch."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.standard_normal((2, 96, 3, 4, 64)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    ref_o, ref_lse = tfa.flash_attention_reference(q, k, v, None, True)
    _rows_close(o, ref_o, 2 ** -6, 1e-6)
    torch.testing.assert_close(lse, ref_lse, **F32)

    off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(q.shape)
    off.copy_(q)
    before = tfa.launches
    with pytest.raises(ValueError, match="16 bytes"):
        tfa.flash_attention_fwd(off, k, v, causal=True)
    assert tfa.launches == before


@pytest.mark.cuda
def test_training_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """One forward and backward of a GPT at a kernel head dim (64), with
    attention dropout 0.1, through the three kernels on the card against
    the plain versions on the CPU: the same CPU generator gives both the same
    attention seeds, and the hash mask the same dropped probabilities. The
    residual and embedding sites draw torch's device RNG, which differs
    between the CPU and the card, so they are turned off here."""
    monkeypatch.setattr(tgpt, "dropout", lambda x, rate, rng: x)
    torch.manual_seed(0)
    cpu = tgpt.tiny_gpt(vocab_size=97, hidden_size=128, num_heads=2,
                        attention_impl="flash", dropout_rate=0.1).train()
    card = tgpt.tiny_gpt(vocab_size=97, hidden_size=128, num_heads=2,
                         attention_impl="flash", dropout_rate=0.1)
    card = card.to(cuda_device).train()
    card.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.default_rng(2).integers(1, 97, (2, 80)))
    mask = _mask(80, (80, 70), "cpu")
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    losses = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        logits = model(ids.to(dev), attention_mask=mask.to(dev),
                       rng=torch.Generator().manual_seed(3))
        loss = causal_lm_loss(logits, ids.to(dev), mask.to(dev))
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == tuple(
        n + 2 for n in before)  # one of each per layer on the card
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    # Each gradient within 1e-4 of its largest |ref|; the key bias, zero in
    # exact arithmetic, within 1e-8 of the largest gradient of the model.
    top = max(p.grad.abs().max().item() for p in cpu.parameters())
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        scale = max(p.grad.abs().max().item(), 1e-4 * top)
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-4,
                                   atol=1e-4 * scale, msg=name)


# BatchNorm kernels vs plain versions on the card, per channel column. The
# elementwise outputs (#5 y, #7 dx and dres) compute the same f32 formula in
# the same order: f32 within 1e-5 of the column's largest |ref|; a bf16
# output may sit one ulp away, 2^-7 of that. The reductions (#4 mean and
# var, #6 dbeta and dgamma) sum the same f32 terms in another order: within
# 1e-5 of the column's sum of |terms|.
BN_ROWS = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
BN_SUMS = 1e-5


def _bn_close(out, ref, rtol):
    limit = rtol * ref.float().abs().amax(dim=0, keepdim=True) + 1e-30
    bad = (out.float() - ref.float()).abs() > limit
    assert not bad.any(), (f"{int(bad.sum())} elements over the column "
                           f"limit; max err "
                           f"{(out.float() - ref.float()).abs().max():.3e}")


def _sums_close(out, ref, abs_terms, extra=0.0):
    assert ((out - ref).abs() <= BN_SUMS * abs_terms + extra).all(), \
        (out - ref).abs().max().item()


def _bn_inputs(device, dtype, m, c, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = [torch.randn((m, c), generator=gen, device=device).to(dtype)
            for _ in range(4)]                       # x, res, dy, y
    vecs = [torch.rand(c, generator=gen, device=device) + 0.5
            for _ in range(4)]                       # inv, gamma, beta, -
    return rows, vecs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 2048])
@pytest.mark.parametrize("m", [4099, 100003])
def test_bn_kernels_match_plain(cuda_device, dtype, c, m):
    """#4-#7 against their plain versions at a ragged M (no multiple of a
    tile, a split or a pass), across the relu, residual and want_dres
    variants."""
    (x, res, dy, y), (inv, gamma, beta, _) = _bn_inputs(cuda_device, dtype,
                                                        m, c, m + c)
    x = x + 0.25
    counts = (tbn.stats_launches, tbn.apply_launches,
              tbn.bwd_reduce_launches, tbn.bwd_dx_launches)
    mean, var = tbn.bn_stats(x)
    ref_mean, ref_var = tbn.bn_stats_reference(x)
    xf = x.float()
    _sums_close(mean, ref_mean, xf.abs().mean(dim=0))
    _sums_close(var, ref_var, 2 * (xf * xf).mean(dim=0))
    for relu, r in ((True, None), (False, None), (True, res)):
        out = tbn.bn_apply(x, mean, inv, gamma, beta, r, relu=relu)
        ref = tbn.bn_apply_reference(x, mean, inv, gamma, beta, r, relu=relu)
        assert out.dtype == dtype
        _bn_close(out, ref, BN_ROWS[dtype])
    for relu in (True, False):
        db, dg = tbn.bn_bwd_reduce(dy, y, x, mean, inv, relu=relu)
        ref_db, ref_dg = tbn.bn_bwd_reduce_reference(dy, y, x, mean, inv,
                                                     relu=relu)
        dz = torch.where(y.float() > 0, dy.float(), 0.0) if relu \
            else dy.float()
        _sums_close(db, ref_db, dz.abs().sum(dim=0))
        _sums_close(dg, ref_dg,
                    (dz * (xf - mean) * inv).abs().sum(dim=0))
    for relu, want_dres in ((True, False), (False, False), (True, True)):
        outs = tbn.bn_bwd_dx(dy, y, x, mean, inv, gamma, db, dg, relu=relu,
                             want_dres=want_dres)
        refs = tbn.bn_bwd_dx_reference(dy, y, x, mean, inv, gamma, db, dg,
                                       relu=relu, want_dres=want_dres)
        for out, ref in zip(outs, refs):
            if ref is None:
                assert out is None
            else:
                _bn_close(out, ref, BN_ROWS[dtype])
    torch.cuda.synchronize()
    assert (tbn.stats_launches, tbn.apply_launches, tbn.bwd_reduce_launches,
            tbn.bwd_dx_launches) == (counts[0] + 1, counts[1] + 3,
                                     counts[2] + 2, counts[3] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_reductions_repeat_bitwise(cuda_device, dtype):
    """#4 and #6 sum without atomics in a fixed order: two runs agree bit
    for bit."""
    (x, _, dy, y), _ = _bn_inputs(cuda_device, dtype, 200003, 256, 7)
    runs = []
    for _ in range(2):
        mean, var = tbn.bn_stats(x)
        inv = torch.rsqrt(var + 1e-5)
        runs.append((mean, var, *tbn.bn_bwd_reduce(dy, y, x, mean, inv,
                                                   relu=True)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["transposed", "strided", "c_not_mult_8",
                                  "unaligned", "half"])
def test_bn_wrapper_raises_rather_than_copying(cuda_device, case):
    x = torch.randn(64, 128, device=cuda_device)
    bad = {"transposed": lambda: x.t().contiguous().t(),
           "strided": lambda: torch.randn(64, 256, device=cuda_device)[:,
                                                                       :128],
           "c_not_mult_8": lambda: x[:, :12].contiguous(),
           "unaligned": lambda: torch.randn(64 * 128 + 1,
                                            device=cuda_device)[1:].view(
                                                64, 128),
           "half": lambda: x.half()}[case]()
    before = tbn.stats_launches
    with pytest.raises((ValueError, TypeError)):
        tbn.bn_stats(bad)
    assert tbn.stats_launches == before


@pytest.mark.cuda
def test_resnet_step_on_card_matches_cpu(cuda_device, monkeypatch):
    """One f32 forward and backward of resnet_nano with fused_bn through
    the four kernels on the card (convolutions in full f32: TF32 off),
    against the plain versions on the CPU: loss, every gradient and the
    updated running buffers."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    cpu = tresnet.resnet_nano(num_classes=10, dtype=torch.float32,
                              fused_bn=True).train()
    card = tresnet.resnet_nano(num_classes=10, dtype=torch.float32,
                               fused_bn=True).to(cuda_device).train()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)
    image = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    label = torch.from_numpy(rng.integers(0, 10, 4))
    counts = (tbn.stats_launches, tbn.apply_launches,
              tbn.bwd_reduce_launches, tbn.bwd_dx_launches)
    losses = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        loss = smoothed_softmax_ce(model(image.to(dev)), label.to(dev), 0.1)
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    # Nine BatchNorm layers: the stem and four in each of the two blocks.
    assert (tbn.stats_launches, tbn.apply_launches, tbn.bwd_reduce_launches,
            tbn.bwd_dx_launches) == tuple(n + 9 for n in counts)
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    top = max(p.grad.abs().max().item() for p in cpu.parameters())
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        scale = max(p.grad.abs().max().item(), 1e-4 * top)
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-4,
                                   atol=1e-4 * scale, msg=name)
    for (name, a), b in zip(cpu.named_buffers(), card.buffers()):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5,
                                   msg=name)


# The matmul+BatchNorm kernels against their plain versions, as
# chip_smoke.py holds them: the products (y, dx, dw) per element within
# 1e-5 of the largest |ref| of the element's column; a bf16 output may sit
# one more ulp of itself away. The column sums within 1e-5 of their sum of
# |terms|; the forward's sums are over y as stored, so where a bf16 y
# rounded the other way they also carry that difference (the column's sum
# of |y - y_ref| and of |y^2 - y_ref^2|).
FLBN_VARIANTS = {"plain": (False, False), "bn": (True, False),
                 "bn_relu": (True, True)}


def _flbn_close(out, ref):
    r = ref.float()
    limit = 1e-5 * r.abs().amax(dim=0)
    if ref.dtype == torch.bfloat16:
        _, e = torch.frexp(r)
        limit = limit + torch.where(
            r != 0, torch.ldexp(torch.ones_like(r), e - 8), 0.0)
    err = (out.float() - r).abs()
    assert (err <= limit).all(), (f"{int((err > limit).sum())} elements "
                                  f"over the limit; max err/limit "
                                  f"{(err / limit).max():.3e}")


def _flbn_inputs(device, dtype, m, k, n, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x = rand(m, k).to(dtype)
    w = rand(n, k, scale=k ** -0.5).to(dtype)
    vecs = (rand(k, scale=0.3), rand(k).abs() + 0.5, rand(k).abs() + 0.5,
            rand(k, scale=0.3))                     # mu, inv, gamma, beta
    dy, y = rand(m, n).to(dtype), rand(m, n).to(dtype)
    return x, w, vecs, dy, y, rand(n, scale=0.1), rand(n, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(FLBN_VARIANTS))
@pytest.mark.parametrize("m,k,n", [(4099, 64, 256), (200003, 256, 64),
                                   (129, 24, 40), (1000, 1024, 2048),
                                   (3001, 64, 64), (2053, 64, 128),
                                   (5003, 128, 64), (1031, 128, 128),
                                   (777, 128, 256), (37, 64, 128),
                                   (2000, 384, 320), (25088, 2048, 512),
                                   (25088, 512, 2048), (3001, 1024, 64),
                                   (4093, 64, 1024), (1500, 512, 128),
                                   (77, 2048, 512)])
def test_linear_bn_kernels_match_plain(cuda_device, dtype, variant, m, k,
                                       n):
    """#8-#10 against their plain versions at ragged M (no multiple of a
    tile or a split), K and N below, at and above a tile, and a contracted
    length that is no multiple of a step. For the bf16 tensor-core dw's
    tiles (dw_plan): 64 x 64 (K = N = 64, each pixel tile's steps split
    between the warpgroups), 64 x 128, 64 x 256, 128 x 64, 256 x 64,
    128 x 128, 128 x 256 and 256 x 128 (K above 128: a second K tile
    wholly past K at K = 384, and N = 320 not a multiple of the tile), and
    M = 37, shorter than one tile and so than one chunk. For the bf16
    tensor-core forward's and dx's tiles (row_plan, 64, 128 or 256 output
    channels a block, the weight slice resident or streamed): stage 4's
    conv1 and conv3 (25,088 x 2048 -> 512 and 512 -> 2048: streamed, four
    and eight column blocks, dx with bn at 128 wide), a 64-wide output
    over a streamed weight (1024 -> 64 forward, 1024 -> 64 dx), 128-wide
    streamed (512 -> 128), and M = 77 at stage 4's widths."""
    bn, relu = FLBN_VARIANTS[variant]
    x, w, vecs, dy, y, ds, dss = _flbn_inputs(cuda_device, dtype, m, k, n,
                                              m + k + n)
    mu, inv, gamma, beta = vecs
    counts = (tflb.fwd_launches, tflb.bwd_dx_launches, tflb.bwd_dw_launches)

    out, s, ss = tflb.linear_bn_fwd(x, *vecs, w, relu=relu, bn=bn)
    ref, rs, rss = tflb.linear_bn_fwd_reference(x, *vecs, w, relu=relu,
                                                bn=bn)
    assert out.dtype == dtype
    _flbn_close(out, ref)
    rf, of = ref.float(), out.float()
    _sums_close(s, rs, rf.abs().sum(dim=0),
                (of - rf).abs().sum(dim=0))
    _sums_close(ss, rss, (rf * rf).sum(dim=0),
                (of * of - rf * rf).abs().sum(dim=0))

    dx, db, dg = tflb.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *vecs,
                                       relu=relu, bn=bn)
    rdx, rdb, rdg = tflb.linear_bn_bwd_dx_reference(dy, y, ds, dss, w, x,
                                                    *vecs, relu=relu, bn=bn)
    _flbn_close(dx, rdx)
    if bn:
        xh = (x.float() - mu) * inv
        da = tflb._dy_total(dy, y, ds, dss).float() @ w.float()
        dz = torch.where(xh * gamma + beta > 0, da, 0.0) if relu else da
        _sums_close(db, rdb, dz.abs().sum(dim=0))
        _sums_close(dg, rdg, (dz * xh).abs().sum(dim=0))
    else:
        assert db is None and dg is None

    dw = tflb.linear_bn_bwd_dw(x, *vecs, dy, y, ds, dss, relu=relu, bn=bn)
    rdw = tflb.linear_bn_bwd_dw_reference(x, *vecs, dy, y, ds, dss,
                                          relu=relu, bn=bn)
    assert dw.shape == (n, k) and dw.dtype == dtype
    _flbn_close(dw, rdw)
    # A dw that lacks one of the kernel's chunks of M fails the limit.
    chunk = -(-m // tflb.dw_splits(m, k, n, dtype))
    r0 = min(m // 2, m - chunk)
    rows = slice(r0, r0 + chunk)
    lost = (tflb._dy_total(dy[rows], y[rows], ds, dss).float().t()
            @ tflb._prologue(x[rows], *vecs, relu, bn).float())
    with pytest.raises(AssertionError):
        _flbn_close((dw.float() - lost).to(dtype), rdw)
    torch.cuda.synchronize()
    assert (tflb.fwd_launches, tflb.bwd_dx_launches,
            tflb.bwd_dw_launches) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_bn_reductions_repeat_bitwise(cuda_device, dtype):
    """The sums of #8 and #9 and the whole of #10 reduce over M without
    atomics in a fixed order: two runs agree bit for bit. #10 also at
    stage 1's conv3 widths (64 -> 256) and at 64 -> 64, where the bf16
    dw's warpgroups split each pixel tile and add their halves."""
    x, w, vecs, dy, y, ds, dss = _flbn_inputs(cuda_device, dtype, 300007,
                                              128, 512, 5)
    runs = []
    for _ in range(2):
        _, s, ss = tflb.linear_bn_fwd(x, *vecs, w, relu=True, bn=True)
        _, db, dg = tflb.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *vecs,
                                          relu=True, bn=True)
        dw = tflb.linear_bn_bwd_dw(x, *vecs, dy, y, ds, dss, relu=True,
                                   bn=True)
        runs.append((s, ss, db, dg, dw))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for m, k, n in ((200003, 64, 256), (100003, 64, 64)):
        x, _, vecs, dy, y, ds, dss = _flbn_inputs(cuda_device, dtype, m, k,
                                                  n, 6)
        dws = [tflb.linear_bn_bwd_dw(x, *vecs, dy, y, ds, dss, relu=True,
                                     bn=True) for _ in range(2)]
        assert torch.equal(*dws)
    # #8's and #9's sums at the bf16 tile plans of stage 1's conv3 (a
    # 256-wide forward and a 64-wide dx over a resident weight), stage 1's
    # conv1 (64 wide, 128-wide dx) and stage 4's (streamed weights).
    for m, k, n in ((200003, 64, 256), (100003, 256, 64),
                    (25088, 512, 2048)):
        x, w, vecs, dy, y, ds, dss = _flbn_inputs(cuda_device, dtype, m, k,
                                                  n, 8)
        runs = []
        for _ in range(2):
            _, s, ss = tflb.linear_bn_fwd(x, *vecs, w, relu=True, bn=True)
            _, db, dg = tflb.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *vecs,
                                              relu=True, bn=True)
            runs.append((s, ss, db, dg))
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(200003, 64, 256), (100003, 256, 64)])
def test_linear_bn_sums_fail_without_one_run(cuda_device, dtype, m, k, n):
    """#8's sum(y) and sum(y^2) and #9's dbeta and dgamma pass their
    limits, and sums that lack one block's run of pixels (run_rows: the
    middle block's, taken out of the kernel's own sums) fail them."""
    x, w, vecs, dy, y, ds, dss = _flbn_inputs(cuda_device, dtype, m, k, n, 9)
    mu, inv, gamma, beta = vecs

    def middle_run(dx):
        run = tflb.run_rows(m, k, n, dtype, dx=dx, bn=True)
        assert 0 < run < m
        r0 = (-(-m // run) // 2) * run
        return slice(r0, r0 + run)

    out, s, ss = tflb.linear_bn_fwd(x, *vecs, w, relu=True, bn=True)
    ref, rs, rss = tflb.linear_bn_fwd_reference(x, *vecs, w, relu=True,
                                                bn=True)
    rf, of = ref.float(), out.float()
    gone = of[middle_run(False)].double()
    dx, db, dg = tflb.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *vecs,
                                       relu=True, bn=True)
    _, rdb, rdg = tflb.linear_bn_bwd_dx_reference(dy, y, ds, dss, w, x,
                                                  *vecs, relu=True, bn=True)
    xh = (x.float() - mu) * inv
    da = tflb._dy_total(dy, y, ds, dss).float() @ w.float()
    dz = torch.where(xh * gamma + beta > 0, da, 0.0)
    rows = middle_run(True)
    cases = (
        (s, rs, rf.abs().sum(dim=0), (of - rf).abs().sum(dim=0), gone),
        (ss, rss, (rf * rf).sum(dim=0),
         (of * of - rf * rf).abs().sum(dim=0), gone * gone),
        (db, rdb, dz.abs().sum(dim=0), 0.0, dz[rows].double()),
        (dg, rdg, (dz * xh).abs().sum(dim=0), 0.0,
         dz[rows].double() * xh[rows]))
    for got, want, terms, flips, lost in cases:
        _sums_close(got, want, terms, flips)
        with pytest.raises(AssertionError):
            _sums_close((got.double() - lost.sum(dim=0)).float(), want,
                        terms, flips)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["transposed", "strided", "k_not_mult_8",
                                  "unaligned", "half"])
def test_linear_bn_wrapper_raises_rather_than_copying(cuda_device, case):
    x = torch.randn(64, 128, device=cuda_device)
    w = torch.randn(64, 128, device=cuda_device)
    bad = {"transposed": lambda: x.t().contiguous().t(),
           "strided": lambda: torch.randn(64, 256, device=cuda_device)[:,
                                                                       :128],
           "k_not_mult_8": lambda: x[:, :12].contiguous(),
           "unaligned": lambda: torch.randn(64 * 128 + 1,
                                            device=cuda_device)[1:].view(
                                                64, 128),
           "half": lambda: x.half()}[case]()
    wb = w[:, :12].contiguous() if case == "k_not_mult_8" else (
        w.half() if case == "half" else w)
    before = tflb.fwd_launches
    with pytest.raises((ValueError, TypeError)):
        tflb.linear_bn_fwd(bad, None, None, None, None, wb, relu=False,
                           bn=False)
    assert tflb.fwd_launches == before


@pytest.mark.cuda
def test_resnet_fused_block_step_on_card_matches_cpu(cuda_device,
                                                     monkeypatch):
    """One f32 forward and backward of resnet_nano with fused_block
    through kernels #8-#10 on the card (convolutions in full f32: TF32
    off), against the plain versions on the CPU: loss, every gradient and
    the updated running buffers."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    cpu = tresnet.resnet_nano(num_classes=10, dtype=torch.float32,
                              fused_block=True).train()
    card = tresnet.resnet_nano(num_classes=10, dtype=torch.float32,
                               fused_block=True).to(cuda_device).train()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    image = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    label = torch.from_numpy(rng.integers(0, 10, 4))
    counts = (tflb.fwd_launches, tflb.bwd_dx_launches, tflb.bwd_dw_launches)
    losses = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        loss = smoothed_softmax_ce(model(image.to(dev)), label.to(dev), 0.1)
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    # Two blocks, each with conv1, conv3 and a downsample.
    assert (tflb.fwd_launches, tflb.bwd_dx_launches,
            tflb.bwd_dw_launches) == tuple(c + 6 for c in counts)
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    top = max(p.grad.abs().max().item() for p in cpu.parameters())
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        scale = max(p.grad.abs().max().item(), 1e-4 * top)
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-4,
                                   atol=1e-4 * scale, msg=name)
    for (name, a), b in zip(cpu.named_buffers(), card.buffers()):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5,
                                   msg=name)


# The 3x3 conv+BatchNorm kernels against their plain versions, held as the
# matmul kernels are: y, dx per element of the (pixels, channels) view and
# dw per element of its (Cout, 9 * Cin) view, within 1e-5 of the largest
# |ref| of the element's column (a bf16 output one more ulp of itself);
# the column sums within 1e-5 of their sum of |terms| (the forward's plus
# the column's sum of |y - y_ref| and |y^2 - y_ref^2|).
def _rows(t):
    return t.reshape(-1, t.shape[-1])


def _dw_rows(dw):
    return dw.permute(0, 2, 3, 1).reshape(dw.shape[0], -1)


def _fcbn_inputs(device, dtype, b, h, w, cin, cout, seed):
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    x = rand(b, h, w, cin).to(dtype)
    wt = rand(cout, cin, 3, 3, scale=(9 * cin) ** -0.5).to(
        dtype, memory_format=torch.channels_last)
    vecs = (rand(cin, scale=0.3), rand(cin).abs() + 0.5,
            rand(cin).abs() + 0.5, rand(cin, scale=0.3))
    dy, y = rand(b, h, w, cout).to(dtype), rand(b, h, w, cout).to(dtype)
    return x, wt, vecs, dy, y, rand(cout, scale=0.1), rand(cout, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", list(FLBN_VARIANTS))
@pytest.mark.parametrize("b,h,w,cin,cout", [(3, 7, 7, 24, 40),
                                            (4, 9, 13, 64, 32),
                                            (2, 28, 28, 136, 144),
                                            (16, 56, 56, 64, 64),
                                            (5, 14, 14, 128, 128),
                                            (6, 7, 7, 256, 136),
                                            (2, 9, 11, 72, 64),
                                            (2, 12, 10, 64, 8),
                                            (1, 4, 300, 16, 24),
                                            (2, 28, 28, 64, 200),
                                            (3, 14, 14, 192, 64),
                                            (1, 5, 80, 96, 64),
                                            (1, 3, 320, 96, 64)])
def test_conv_bn_kernels_match_plain(cuda_device, monkeypatch, dtype,
                                     variant, b, h, w, cin, cout):
    """#11-#13 against their plain versions: W = 7 and odd sides (a row
    tile spans several images, and each tap must stay in its own image),
    Cin != Cout, channels above one 128-wide tile and not a multiple of it,
    and stage 1's widths. For the bf16 tensor-core kernels' tiling: W = 14
    and 7 at 128 channels and more (a 128- or 256-pixel tile spans several
    images), M a multiple of neither tile (980, 294), Cin = 72 (a second
    64-channel chunk of 8 channels), Cout = 8 (one 64-wide block of
    8), and an image wider than the tile (W = 300: the halo slab in three
    segments). For the bf16 tensor-core dx's plans (dx_plan: 128-pixel
    tiles; 64 or 128 input channels a block; weights resident or streamed;
    two slab stages or one): resident at Cin, Cout <= 64 (stage 1's widths
    among them), streamed 64 wide (64 -> 200: a Cout chunk of 8) and 128
    wide (Cin > 64; 192 -> 64 with a last block of 64), 64 wide for lack
    of room (96 -> 64 at W = 80: a 320-row slab) and one stage (W = 300 and
    W = 320, slabs of three runs, the latter in two 64-wide blocks); M a
    multiple of no tile. The plain versions' convolutions in full f32 (TF32
    off), as the kernels compute."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    bn, relu = FLBN_VARIANTS[variant]
    x, wt, vecs, dy, y, ds, dss = _fcbn_inputs(cuda_device, dtype, b, h, w,
                                               cin, cout, b + h + cin)
    mu, inv, gamma, beta = vecs
    counts = (tfc.fwd_launches, tfc.bwd_dx_launches, tfc.bwd_dw_launches)

    out, s, ss = tfc.conv3x3_bn_fwd(x, *vecs, wt, relu=relu, bn=bn)
    ref, rs, rss = tfc.conv3x3_bn_fwd_reference(x, *vecs, wt, relu=relu,
                                                bn=bn)
    assert out.dtype == dtype and out.shape == (b, h, w, cout)
    _flbn_close(_rows(out), _rows(ref))
    rf, of = _rows(ref).float(), _rows(out).float()
    _sums_close(s, rs, rf.abs().sum(dim=0), (of - rf).abs().sum(dim=0))
    _sums_close(ss, rss, (rf * rf).sum(dim=0),
                (of * of - rf * rf).abs().sum(dim=0))

    dx, db, dg = tfc.conv3x3_bn_bwd_dx(dy, y, ds, dss, wt, x, *vecs,
                                       relu=relu, bn=bn)
    rdx, rdb, rdg = tfc.conv3x3_bn_bwd_dx_reference(dy, y, ds, dss, wt, x,
                                                    *vecs, relu=relu, bn=bn)
    _flbn_close(_rows(dx), _rows(rdx))
    dyt = tfc._dy_total(dy, y, ds, dss)
    if bn:
        xh = (x.float() - mu) * inv
        da = tfc._conv(dyt, wt.flip(2, 3).transpose(0, 1))
        dz = torch.where(xh * gamma + beta > 0, da, 0.0) if relu else da
        _sums_close(db, rdb, _rows(dz).abs().sum(dim=0))
        _sums_close(dg, rdg, _rows(dz * xh).abs().sum(dim=0))
    else:
        assert db is None and dg is None

    dw = tfc.conv3x3_bn_bwd_dw(x, *vecs, dy, y, ds, dss, relu=relu, bn=bn)
    rdw = tfc.conv3x3_bn_bwd_dw_reference(x, *vecs, dy, y, ds, dss,
                                          relu=relu, bn=bn)
    assert dw.shape == (cout, cin, 3, 3) and dw.dtype == dtype
    _flbn_close(_dw_rows(dw), _dw_rows(rdw))
    # A dw that lacks one of the kernel's chunks of M fails the limit.
    m = b * h * w
    chunk = -(-m // tfc.dw_splits(m, cin, cout, dtype))
    r0 = min(m // 2, m - chunk)
    keep = torch.zeros(m, 1, device=cuda_device)
    keep[r0:r0 + chunk] = 1.0
    a = tfc._prologue(x, *vecs, relu, bn).float().permute(0, 3, 1, 2)
    lost = torch.nn.grad.conv2d_weight(
        a, dw.shape, (_rows(dyt).float() * keep).view(b, h, w, cout)
        .permute(0, 3, 1, 2), padding=1)
    with pytest.raises(AssertionError):
        _flbn_close(_dw_rows((dw.float() - lost).to(dtype)), _dw_rows(rdw))
    torch.cuda.synchronize()
    assert (tfc.fwd_launches, tfc.bwd_dx_launches,
            tfc.bwd_dw_launches) == tuple(c + 1 for c in counts)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", [(16, 56, 56, 64, 64),
                                            (8, 14, 14, 256, 256)])
def test_conv_bn_sums_fail_without_one_run(cuda_device, monkeypatch, dtype,
                                           b, h, w, cin, cout):
    """#11's sum(y) and sum(y^2) pass their limit, and sums that lack one
    block's run of pixels (fwd_run_rows: the middle block's, taken out of
    the kernel's own sums) fail it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, wt, vecs, _, _, _, _ = _fcbn_inputs(cuda_device, dtype, b, h, w,
                                           cin, cout, 7)
    out, s, ss = tfc.conv3x3_bn_fwd(x, *vecs, wt, relu=True, bn=True)
    ref, rs, rss = tfc.conv3x3_bn_fwd_reference(x, *vecs, wt, relu=True,
                                                bn=True)
    rf, of = _rows(ref).float(), _rows(out).float()
    terms = (rf.abs().sum(dim=0), (rf * rf).sum(dim=0))
    flips = ((of - rf).abs().sum(dim=0), (of * of - rf * rf).abs().sum(dim=0))
    _sums_close(s, rs, terms[0], flips[0])
    _sums_close(ss, rss, terms[1], flips[1])
    m = b * h * w
    run = tfc.fwd_run_rows(m, w, cin, cout, dtype)
    assert 0 < run < m
    r0 = (-(-m // run) // 2) * run
    gone = of[r0:r0 + run].double()
    for got, want, t, f, lost in ((s, rs, terms[0], flips[0], gone),
                                  (ss, rss, terms[1], flips[1],
                                   gone * gone)):
        with pytest.raises(AssertionError):
            _sums_close((got.double() - lost.sum(dim=0)).float(), want, t,
                        f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", [(16, 56, 56, 64, 64),
                                            (8, 14, 14, 256, 256)])
def test_conv_bn_dx_sums_fail_without_one_run(cuda_device, monkeypatch,
                                              dtype, b, h, w, cin, cout):
    """#12's dbeta and dgamma pass their limit, and sums that lack one
    block's run of pixels (bwd_dx_run_rows: the middle block's, taken out
    of the kernel's own sums) fail it."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, wt, vecs, dy, y, ds, dss = _fcbn_inputs(cuda_device, dtype, b, h, w,
                                               cin, cout, 11)
    mu, inv, gamma, beta = vecs
    _, db, dg = tfc.conv3x3_bn_bwd_dx(dy, y, ds, dss, wt, x, *vecs,
                                      relu=True, bn=True)
    _, rdb, rdg = tfc.conv3x3_bn_bwd_dx_reference(dy, y, ds, dss, wt, x,
                                                  *vecs, relu=True, bn=True)
    xh = _rows((x.float() - mu) * inv)
    da = _rows(tfc._conv(tfc._dy_total(dy, y, ds, dss),
                         wt.flip(2, 3).transpose(0, 1)))
    dz = torch.where(xh * gamma + beta > 0, da, 0.0)
    m = b * h * w
    run = tfc.bwd_dx_run_rows(m, w, cin, cout, dtype)
    assert 0 < run < m
    r0 = (-(-m // run) // 2) * run
    rows = slice(r0, r0 + run)
    for got, want, terms, lost in (
            (db, rdb, dz.abs().sum(dim=0), dz[rows].double()),
            (dg, rdg, (dz * xh).abs().sum(dim=0),
             dz[rows].double() * xh[rows])):
        _sums_close(got, want, terms)
        with pytest.raises(AssertionError):
            _sums_close((got.double() - lost.sum(dim=0)).float(), want,
                        terms)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,w,cin,cout", [(16, 56, 56, 64, 64),
                                            (4, 14, 14, 256, 136)])
def test_conv_bn_dx_repeats_bitwise(cuda_device, dtype, b, h, w, cin, cout):
    """#12 at stage 1's widths (the bf16 weights resident) and at a
    streamed shape (two 64-column blocks a block, a last Cout chunk of 8):
    two runs give the same dx, dbeta and dgamma bit for bit."""
    x, wt, vecs, dy, y, ds, dss = _fcbn_inputs(cuda_device, dtype, b, h, w,
                                               cin, cout, 12)
    runs = [tfc.conv3x3_bn_bwd_dx(dy, y, ds, dss, wt, x, *vecs, relu=True,
                                  bn=True) for _ in range(2)]
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bn_reductions_repeat_bitwise(cuda_device, dtype):
    """The sums of #11 and #12 and the whole of #13 reduce over M without
    atomics in a fixed order: two runs agree bit for bit."""
    x, wt, vecs, dy, y, ds, dss = _fcbn_inputs(cuda_device, dtype, 32, 28,
                                               28, 128, 128, 5)
    runs = []
    for _ in range(2):
        _, s, ss = tfc.conv3x3_bn_fwd(x, *vecs, wt, relu=True, bn=True)
        _, db, dg = tfc.conv3x3_bn_bwd_dx(dy, y, ds, dss, wt, x, *vecs,
                                          relu=True, bn=True)
        dw = tfc.conv3x3_bn_bwd_dw(x, *vecs, dy, y, ds, dss, relu=True,
                                   bn=True)
        runs.append((s, ss, db, dg, dw))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["nchw_contiguous", "strided",
                                  "c_not_mult_8", "unaligned", "half"])
def test_conv_bn_wrapper_raises_rather_than_copying(cuda_device, case):
    x = torch.randn(2, 8, 8, 64, device=cuda_device)
    w = torch.randn(64, 64, 3, 3, device=cuda_device)
    bad = {"nchw_contiguous": lambda: torch.randn(
               2, 64, 8, 8, device=cuda_device).permute(0, 2, 3, 1),
           "strided": lambda: torch.randn(2, 8, 8, 128,
                                          device=cuda_device)[..., :64],
           "c_not_mult_8": lambda: x[..., :12].contiguous(),
           "unaligned": lambda: torch.randn(2 * 8 * 8 * 64 + 1,
                                            device=cuda_device)[1:].view(
                                                2, 8, 8, 64),
           "half": lambda: x.half()}[case]()
    wb = w[:, :12].contiguous() if case == "c_not_mult_8" else (
        w.half() if case == "half" else w)
    before = tfc.fwd_launches
    with pytest.raises((ValueError, TypeError)):
        tfc.conv3x3_bn_fwd(bad, None, None, None, None, wb, relu=False,
                           bn=False)
    assert tfc.fwd_launches == before


@pytest.mark.cuda
def test_resnet_fused_conv3_step_on_card_matches_cpu(cuda_device,
                                                     monkeypatch):
    """One f32 forward and backward of resnet_nano with fused_block and
    fused_conv3 through kernels #8-#13 on the card (convolutions in full
    f32: TF32 off), against the plain versions on the CPU: loss, every
    gradient and the updated running buffers."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    torch.manual_seed(0)
    cpu = tresnet.resnet_nano(num_classes=10, dtype=torch.float32,
                              fused_block=True, fused_conv3=True).train()
    card = tresnet.resnet_nano(num_classes=10, dtype=torch.float32,
                               fused_block=True,
                               fused_conv3=True).to(cuda_device).train()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    image = torch.from_numpy(rng.standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    label = torch.from_numpy(rng.integers(0, 10, 4))
    counts = (tflb.fwd_launches, tflb.bwd_dx_launches, tflb.bwd_dw_launches,
              tfc.fwd_launches, tfc.bwd_dx_launches, tfc.bwd_dw_launches)
    losses = []
    for model, dev in ((cpu, "cpu"), (card, cuda_device)):
        loss = smoothed_softmax_ce(model(image.to(dev)), label.to(dev), 0.1)
        loss.backward()
        losses.append(loss.item())
    torch.cuda.synchronize()
    # Two blocks, each with conv1, conv3 and a downsample; the first is at
    # stride 1, so its 3x3 runs through #11-#13.
    assert (tflb.fwd_launches, tflb.bwd_dx_launches, tflb.bwd_dw_launches,
            tfc.fwd_launches, tfc.bwd_dx_launches,
            tfc.bwd_dw_launches) == tuple(
                c + n for c, n in zip(counts, (6, 6, 6, 1, 1, 1)))
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    top = max(p.grad.abs().max().item() for p in cpu.parameters())
    for (name, p), q in zip(cpu.named_parameters(), card.parameters()):
        scale = max(p.grad.abs().max().item(), 1e-4 * top)
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-4,
                                   atol=1e-4 * scale, msg=name)
    for (name, a), b in zip(cpu.named_buffers(), card.buffers()):
        torch.testing.assert_close(b.cpu(), a, rtol=1e-5, atol=1e-5,
                                   msg=name)
