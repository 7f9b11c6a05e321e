"""The port's Llama (distributeddeeplearning_tpu_torch/models/llama.py)
against the JAX model, with grouped-query attention (2 KV heads for 4 query
heads): JAX-initialised weights through ``params_from_flax``, f32 logits for
the dense and flash impls and for KV-cache decoding, and RoPE alone."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu_torch.models import llama as tllama
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.torch_port_helpers import F32, flax_params  # noqa: F401
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

VOCAB = 97


@pytest.fixture(scope="module")
def weights():
    model = jllama.tiny_llama(vocab_size=VOCAB)
    assert model.cfg.num_kv_heads < model.cfg.num_heads
    variables = model.init({"params": jax.random.key(0)},
                           jnp.ones((2, 8), jnp.int32), train=False)
    return flax_params(variables)


def _pair(weights, impl, **kw):
    jmodel = jllama.tiny_llama(vocab_size=VOCAB, attention_impl=impl, **kw)
    tmodel = tllama.tiny_llama(vocab_size=VOCAB, attention_impl=impl,
                               **kw).eval()
    tmodel.load_state_dict(params_from_flax(weights))
    return jmodel, tmodel


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax(weights, impl):
    jmodel, tmodel = _pair(weights, impl)
    rng = np.random.default_rng(2)
    ids = rng.integers(1, VOCAB, (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[0, -7:] = 0
    ref = jmodel.apply({"params": weights}, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask), train=False)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (2, 20, VOCAB)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_decode_prefill_and_steps_match_jax(weights):
    jmodel, tmodel = _pair(weights, "dense", decode_cache_len=16)
    ids = np.random.default_rng(3).integers(1, VOCAB, (2, 5)).astype(
        np.int32)
    ref, mut = jmodel.apply({"params": weights}, jnp.asarray(ids),
                            train=False, decode=True, mutable=["cache"])
    cache = tmodel.init_cache(2)
    assert cache.keys[0].shape == (2, 16, 2, 16)  # kv-head width
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids).long(), cache=cache)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
        for tok in ([[4], [9]], [[30], [2]]):
            nxt = np.asarray(tok, np.int32)
            ref, mut = jmodel.apply(
                {"params": weights, "cache": mut["cache"]},
                jnp.asarray(nxt), train=False, decode=True,
                mutable=["cache"])
            out = tmodel(torch.from_numpy(nxt).long(), cache=cache)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)
    assert cache.index == 7


@pytest.mark.parametrize("offset", [0, 13])
def test_rope_matches_jax(offset):
    x = np.random.default_rng(4).standard_normal((2, 6, 3, 16)).astype(
        np.float32)
    ref = jllama.apply_rope(jnp.asarray(x), theta=10000.0, offset=offset)
    out = tllama.apply_rope(torch.from_numpy(x), theta=10000.0,
                            offset=offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_gqa_repeat_is_interleaved():
    """jnp.repeat(k, rep, axis=2) repeats each KV head in place: heads
    (a, b) -> (a, a, b, b), not (a, b, a, b)."""
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    ref = np.asarray(jnp.repeat(jnp.asarray(k), 2, axis=2))
    out = torch.repeat_interleave(torch.from_numpy(k), 2, dim=2)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("name,build", [
    ("tinyllama_1b", tllama.tinyllama_1b), ("llama2_7b", tllama.llama2_7b)])
def test_param_counts_at_full_width(name, build):
    """Built on the meta device: nothing at full width runs on the CPU."""
    with torch.device("meta"):
        model = build()
    count = sum(p.numel() for p in model.parameters())
    assert count == model_spec(name).param_count
