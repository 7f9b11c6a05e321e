"""The port's HuggingFace converters (distributeddeeplearning_tpu_torch/
utils/hf_convert.py) against the JAX package's on the CPU.

For BERT, GPT-2 and Llama the HF-layout state dict is built in the test
(the JAX exporter applied to the JAX tiny model's seeded params). The
port's ``*_params_from_hf`` must equal JAX ``*_params_from_hf`` followed by
``params_from_flax``, load into the port's tiny model strictly, and its
``*_params_to_hf`` must give the HF dict back bit for bit. ``convert_checked``
refuses a tensor the mapping would drop, and ignores the tied duplicates.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import bert as jbert
from distributeddeeplearning_tpu.utils import hf_convert as jhf
from distributeddeeplearning_tpu_torch.models import bert as tbert
from distributeddeeplearning_tpu_torch.models import gpt as tgpt
from distributeddeeplearning_tpu_torch.models import llama as tllama
from distributeddeeplearning_tpu_torch.utils import hf_convert as thf
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.torch_port_helpers import (flax_params,  # noqa: F401
                                      one_torch_thread, tiny_lm_params)

VOCAB = 97
LAYERS = 2
FAMILIES = {
    "bert": lambda: tbert.tiny_bert_mlm(vocab_size=VOCAB),
    "gpt2": lambda: tgpt.tiny_gpt(vocab_size=VOCAB),
    "llama": lambda: tllama.tiny_llama(vocab_size=VOCAB),
}


@functools.lru_cache(maxsize=None)
def _flax(family: str) -> dict:
    if family == "bert":
        init = jax.jit(lambda key: jbert.tiny_bert_mlm(vocab_size=VOCAB).init(
            {"params": key}, jnp.ones((1, 8), jnp.int32), train=False))
        return flax_params(init(jax.random.key(2)))
    return tiny_lm_params({"gpt2": "gpt", "llama": "llama"}[family], VOCAB)


def _hf(family: str) -> dict:
    """The HF-layout state dict of the JAX tiny model's params."""
    return {k: np.asarray(v) for k, v in
            jhf.EXPORTERS[family](_flax(family), LAYERS).items()}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_from_hf_matches_jax(family):
    hf = _hf(family)
    convert, _ = jhf.CONVERTERS[family]
    ref = params_from_flax(convert(hf, LAYERS))
    out, _ = thf.CONVERTERS[family]
    state = out(hf, LAYERS)
    assert state.keys() == ref.keys()
    for key in ref:
        assert torch.equal(state[key], ref[key]), key
    model = FAMILIES[family]()
    model.load_state_dict(state)          # strict: the port's names


@pytest.mark.parametrize("family", list(FAMILIES))
def test_round_trip_through_hf(family):
    hf = _hf(family)
    state = thf.convert_checked(family, hf, LAYERS)
    back = thf.EXPORTERS[family](state, LAYERS)
    assert back.keys() == hf.keys()
    for key in hf:
        np.testing.assert_array_equal(back[key], hf[key], err_msg=key)
    # And from a port model's own state dict to HF and back.
    torch.manual_seed(0)
    model = FAMILIES[family]()
    again = thf.convert_checked(
        family, thf.EXPORTERS[family](model.state_dict(), LAYERS), LAYERS)
    for key, value in model.state_dict().items():
        assert torch.equal(again[key], value), key


def test_convert_checked_refuses_a_dropped_tensor():
    hf = _hf("bert")
    hf["bert.encoder.layer.0.attention.self.query.extra"] = np.zeros(3)
    with pytest.raises(ValueError, match="does not consume"):
        thf.convert_checked("bert", hf, LAYERS)
    with pytest.raises(ValueError, match="does not consume"):
        jhf.convert_checked("bert", hf, LAYERS)


def test_llama_tied_head_and_ignorable_buffers():
    """A tie_word_embeddings checkpoint has no lm_head: the head is the
    embedding; RoPE's inv_freq buffer is ignored."""
    hf = _hf("llama")
    del hf["lm_head.weight"]
    hf["model.layers.0.self_attn.rotary_emb.inv_freq"] = np.ones(4)
    state = thf.convert_checked("llama", hf, LAYERS)
    assert torch.equal(state["lm_head.weight"],
                       torch.tensor(hf["model.embed_tokens.weight"]))


def test_state_dict_to_numpy():
    sd = {"a": torch.arange(3.0, requires_grad=True)}
    out = thf.state_dict_to_numpy(sd)
    np.testing.assert_array_equal(out["a"], [0.0, 1.0, 2.0])
