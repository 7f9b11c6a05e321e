"""The port's models in training mode (distributeddeeplearning_tpu_torch/
models/, train/losses.py) against the JAX package on the CPU.

- loss and every parameter's gradient against ``jax.value_and_grad`` of
  ``steps._causal_loss_fn``'s loss, on gpt_tiny and llama_tiny, f32, through
  the flash impl;
- attention dropout on, at matching seeds, through flash and dense: the
  hash mask reproduces exactly, so loss and gradients are compared too. The
  residual and embedding dropout sites are turned off on both sides,
  because torch's RNG cannot replay flax's.

Losses are compared at F32 and gradients relative to each tensor's largest
|ref| at F32 (``close_rel``): both sides compute in f32 and differ in
summation order.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu.ops import hash_dropout as jhash
from distributeddeeplearning_tpu.train import losses as jlosses
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import llama as tllama
from distributeddeeplearning_tpu_torch.ops import attention as tattn
from distributeddeeplearning_tpu_torch.train.losses import causal_lm_loss
from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)
from tests.torch_port_helpers import (F32, close_rel,  # noqa: F401
                                      flat_params, one_torch_thread,
                                      tiny_lm_params)

VOCAB = 97
B, S = 2, 32
FAMILIES = {"gpt": (jgpt.tiny_gpt, tgpt.tiny_gpt),
            "llama": (jllama.tiny_llama, tllama.tiny_llama)}


def _batch():
    rng = np.random.default_rng(3)
    ids = rng.integers(1, VOCAB, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, -7:] = 0
    return ids, mask


def _jax_loss_and_grads(family, impl, rate):
    jbuild, _ = FAMILIES[family]
    model = jbuild(vocab_size=VOCAB, attention_impl=impl, dropout_rate=rate)
    params = tiny_lm_params(family, VOCAB)
    ids, mask = _batch()
    loss_fn = jsteps._causal_loss_fn(model, None)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, None, {"input_ids": jnp.asarray(ids),
                       "attention_mask": jnp.asarray(mask)},
        jax.random.key(1))
    return params, float(loss), flat_params(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(family, impl, rate, params):
    _, tbuild = FAMILIES[family]
    model = tbuild(vocab_size=VOCAB, attention_impl=impl,
                   dropout_rate=rate).train()
    model.load_state_dict(params_from_flax(params))
    ids, mask = (torch.from_numpy(x) for x in _batch())
    logits = model(ids.long(), attention_mask=mask,
                   rng=torch.Generator().manual_seed(0))
    loss = causal_lm_loss(logits, ids, mask)
    loss.backward()
    grads = params_to_flax({n: p.grad for n, p in model.named_parameters()})
    return loss.item(), grads


@pytest.mark.parametrize("family,impl", [("gpt", "flash"),
                                         ("llama", "flash")])
def test_loss_and_grads_match_jax(family, impl):
    params, ref_loss, ref_grads = _jax_loss_and_grads(family, impl, 0.0)
    loss, grads = _port_loss_and_grads(family, impl, 0.0, params)
    np.testing.assert_allclose(loss, ref_loss, **F32)
    close_rel(grads, ref_grads)


class _NoDropout:
    """flax ``nn.Dropout`` turned off: the residual and embedding sites."""

    def __init__(self, rate):
        del rate

    def __call__(self, x, deterministic=True):
        return x


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_attention_dropout_matches_jax(impl, monkeypatch):
    """Attention dropout 0.1 on gpt_tiny: each layer's seed is fed to both
    sides, and the hash mask makes loss and gradients agree."""
    seeds = [-1234567, 987654321]
    jseeds, tseeds = iter(seeds), iter(seeds)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(jhash, "seed_from_key",
                        lambda key: jnp.int32(next(jseeds)))
    monkeypatch.setattr(tgpt, "dropout", lambda x, rate, rng: x)
    monkeypatch.setattr(tattn, "draw_seed", lambda rng: next(tseeds))
    params, ref_loss, ref_grads = _jax_loss_and_grads("gpt", impl, 0.1)
    loss, grads = _port_loss_and_grads("gpt", impl, 0.1, params)
    np.testing.assert_allclose(loss, ref_loss, **F32)
    close_rel(grads, ref_grads)
    # The mask changes the result: without dropout the loss differs.
    plain_loss, _ = _port_loss_and_grads("gpt", impl, 0.0, params)
    assert abs(plain_loss - ref_loss) > 1e-4


def test_every_layer_draws_its_own_attention_seed(monkeypatch):
    """One seed per layer and step, none shared."""
    drawn = []
    draw = tattn.draw_seed
    monkeypatch.setattr(tattn, "draw_seed",
                        lambda rng: drawn.append(draw(rng)) or drawn[-1])
    model = tgpt.tiny_gpt(vocab_size=VOCAB, num_layers=3,
                          attention_impl="flash").train()
    ids = torch.ones((1, 8), dtype=torch.long)
    for step in range(2):
        model(ids, rng=torch.Generator().manual_seed(step))
    assert len(drawn) == 2 * 3 and len(set(drawn)) == len(drawn)


def test_training_without_rng_raises():
    model = tgpt.tiny_gpt(vocab_size=VOCAB).train()
    with pytest.raises(ValueError, match="rng"):
        model(torch.ones((1, 8), dtype=torch.long))
    model.eval()(torch.ones((1, 8), dtype=torch.long))  # eval: no dropout


def test_causal_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, S, VOCAB)).astype(np.float32)
    ids, mask = _batch()
    ref = jlosses.causal_lm_loss(jnp.asarray(logits), jnp.asarray(ids),
                                 jnp.asarray(mask))
    out = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(float(out), float(ref), **F32)
    # No predicted token at all: the count is clamped at 1.
    empty = causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(ids),
                           torch.zeros((B, S), dtype=torch.int32))
    assert float(empty) == 0.0
