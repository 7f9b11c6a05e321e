"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one. The file imports
nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.ops import flash_attention as tfa

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
