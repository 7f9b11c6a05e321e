"""The port's GPT (distributeddeeplearning_tpu_torch/models/gpt.py) against
the JAX model: JAX-initialised weights carried across by
``params_from_flax``, the same ids through both, f32 logits compared for the
dense and flash impls and for KV-cache decoding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)
from tests.torch_port_helpers import (F32, flat_params,  # noqa: F401
                                      flax_params, one_torch_thread)

VOCAB = 97


@pytest.fixture(scope="module")
def weights():
    model = jgpt.tiny_gpt(vocab_size=VOCAB)
    variables = model.init({"params": jax.random.key(0)},
                           jnp.ones((2, 8), jnp.int32), train=False)
    return flax_params(variables)


def _pair(weights, impl):
    jmodel = jgpt.tiny_gpt(vocab_size=VOCAB, attention_impl=impl)
    tmodel = tgpt.tiny_gpt(vocab_size=VOCAB, attention_impl=impl).eval()
    tmodel.load_state_dict(params_from_flax(weights))
    return jmodel, tmodel


def _ids_and_mask(s=24):
    rng = np.random.default_rng(1)
    ids = rng.integers(1, VOCAB, (2, s)).astype(np.int32)
    mask = np.ones((2, s), np.int32)
    mask[1, -5:] = 0
    return ids, mask


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax(weights, impl):
    jmodel, tmodel = _pair(weights, impl)
    ids, mask = _ids_and_mask()
    ref = jmodel.apply({"params": weights}, jnp.asarray(ids),
                       attention_mask=jnp.asarray(mask), train=False)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask))
    assert out.dtype == torch.float32 and out.shape == (2, 24, VOCAB)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **F32)


def test_decode_prefill_and_step_match_jax(weights):
    jmodel, tmodel = _pair(weights, "dense")
    ids, _ = _ids_and_mask(6)
    ref0, mut = jmodel.apply({"params": weights}, jnp.asarray(ids),
                             train=False, decode=True, mutable=["cache"])
    nxt = np.asarray([[5], [11]], np.int32)
    ref1, _ = jmodel.apply({"params": weights, "cache": mut["cache"]},
                           jnp.asarray(nxt), train=False, decode=True,
                           mutable=["cache"])
    cache = tmodel.init_cache(2)
    with torch.no_grad():
        out0 = tmodel(torch.from_numpy(ids).long(), cache=cache)
        out1 = tmodel(torch.from_numpy(nxt).long(), cache=cache)
    assert cache.index == 7
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), **F32)
    np.testing.assert_allclose(out1.numpy(), np.asarray(ref1), **F32)


def test_decode_refuses_to_overflow_positions(weights):
    _, tmodel = _pair(weights, "dense")
    cache = tmodel.init_cache(1)
    cache.index = tmodel.cfg.max_position
    with pytest.raises(ValueError, match="max_position"):
        tmodel(torch.ones((1, 1), dtype=torch.long), cache=cache)


def test_params_from_flax_accepts_nested_and_flat_and_round_trips(weights):
    nested = params_from_flax(weights)
    flat = params_from_flax({f"params/{k}": v
                             for k, v in flat_params(weights).items()})
    assert nested.keys() == flat.keys()
    for key in nested:
        torch.testing.assert_close(nested[key], flat[key], rtol=0, atol=0)
    model = tgpt.tiny_gpt(vocab_size=VOCAB)
    assert nested.keys() == model.state_dict().keys()
    back = params_to_flax(nested)
    ref = flat_params(weights)
    assert back.keys() == ref.keys()
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key])


@pytest.mark.parametrize("name,build", [("gpt2_small", tgpt.gpt2_small),
                                        ("gpt2_medium", tgpt.gpt2_medium)])
def test_param_counts_at_full_width(name, build):
    """Built on the meta device: nothing at full width runs on the CPU."""
    with torch.device("meta"):
        model = build()
    assert model.cfg.hidden_size % model.cfg.num_heads == 0
    count = sum(p.numel() for p in model.parameters())
    assert count == model_spec(name).param_count


def test_fit_positions_matches_jax():
    for seq_len in (None, 64, 4096):
        ref = jgpt.gpt2_small(seq_len=seq_len).cfg.max_position
        with torch.device("meta"):
            assert tgpt.gpt2_small(seq_len=seq_len).cfg.max_position == ref
    assert {f.name for f in dataclasses.fields(tgpt.GptConfig)} <= {
        f.name for f in dataclasses.fields(jgpt.GptConfig)}
