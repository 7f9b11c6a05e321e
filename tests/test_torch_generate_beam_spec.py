"""Beam search and speculative decoding of the port (models/generate.py
``generate_beam`` and ``generate_speculative``, the generate CLI's
``--num-beams``/``--draft-model`` flags) against the JAX package's (the
cases of tests/test_generate.py).

Weights are the JAX models' own, carried by ``params_from_flax``; prompts
come from numpy seeds. Tolerance: ids equal, everywhere. Beam search runs
by refeed and over per-beam KV caches, with and without an EOS id and a
length penalty, on gpt_tiny and llama_tiny; speculative decoding with a
smaller drafter at several draft lengths and with the target as its own
drafter; both through the CLI too. Around them, the guards and the cache's
row map and rewind.
"""

import functools
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import generate as jgen
from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu_torch import generate as cli
from distributeddeeplearning_tpu_torch.models import gpt, llama
from distributeddeeplearning_tpu_torch.models.decode_cache import KVCache
from distributeddeeplearning_tpu_torch.models.generate import (
    generate, generate_beam, generate_speculative)
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.torch_port_helpers import flat_params, flax_params, tiny_lm_params
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

VOCAB = 97
JAX_BUILD = {"gpt": lambda **kw: jgpt.tiny_gpt(dropout_rate=0.0, **kw),
             "llama": jllama.tiny_llama}
PORT_BUILD = {"gpt": lambda **kw: gpt.tiny_gpt(dropout_rate=0.0, **kw),
              "llama": llama.tiny_llama}


@functools.lru_cache(maxsize=None)
def _pair(family):
    """``(jax_model, variables, port_model)`` with one set of weights."""
    params = tiny_lm_params(family, VOCAB)
    model = PORT_BUILD[family](vocab_size=VOCAB)
    model.load_state_dict(params_from_flax(params))
    return JAX_BUILD[family](vocab_size=VOCAB), {"params": params}, \
        model.eval()


def _prompt(seed, shape):
    return np.random.default_rng(seed).integers(1, VOCAB, shape).astype(
        np.int32)


def _jax_beam(family, prompt, **kw):
    return _jax_beam_cached(family, prompt.tobytes(), prompt.shape,
                            tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _jax_beam_cached(family, data, shape, kw):
    jm, jv, _ = _pair(family)
    prompt = np.frombuffer(data, np.int32).reshape(shape)
    return np.asarray(jgen.generate_beam(jm, jv, prompt, **dict(kw)))


@functools.lru_cache(maxsize=None)
def _jax_spec(family, k):
    """JAX ``generate_speculative`` of the drafter case: 9 new tokens after
    the seed-11 prompt of 5."""
    jm, jv, _ = _pair(family)
    jd, dv, _ = _drafter(family)
    return np.asarray(jgen.generate_speculative(
        jm, jv, jd, dv, _prompt(11, (1, 5)), max_new_tokens=9, draft_len=k))


def _port_beam(family, prompt, **kw):
    return generate_beam(_pair(family)[2], prompt, **kw).numpy()


# --- beam search ------------------------------------------------------------

@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_beam_refeed_and_cached_equal_jax(family):
    prompt = _prompt(8, (2, 4))
    ref = _jax_beam(family, prompt, max_new_tokens=5, num_beams=3)
    for use_cache in (False, True):
        out = _port_beam(family, prompt, max_new_tokens=5, num_beams=3,
                         use_cache=use_cache)
        np.testing.assert_array_equal(out, ref, err_msg=str(use_cache))


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_beam_eos_and_length_penalty_equal_jax(family):
    """An EOS id that a surviving beam emits (the first generated token of
    the free winner) at length penalties 0 and 1.5: the frozen beam pads,
    and the ranking over lengths matches."""
    prompt = _prompt(9, (1, 4))
    eos = int(_jax_beam(family, prompt, max_new_tokens=6, num_beams=3)[0, 4])
    for alpha in (0.0, 1.5):
        kw = dict(max_new_tokens=6, num_beams=3, eos_id=eos, pad_id=0,
                  length_penalty=alpha)
        ref = _jax_beam(family, prompt, **kw)
        for use_cache in (False, True):
            out = _port_beam(family, prompt, use_cache=use_cache, **kw)
            np.testing.assert_array_equal(out, ref,
                                          err_msg=f"{alpha} {use_cache}")
        gen = ref[0, 4:]
        if (gen == eos).any():   # a frozen beam pads after its eos
            assert (gen[np.argmax(gen == eos) + 1:] == 0).all()


def test_beam1_equals_greedy():
    prompt = _prompt(1, (2, 4))
    model = _pair("gpt")[2]
    greedy = generate(model, prompt, max_new_tokens=4)
    for use_cache in (False, True):
        beam = generate_beam(model, prompt, max_new_tokens=4, num_beams=1,
                             use_cache=use_cache)
        assert torch.equal(beam, greedy)


def test_beam_matches_exhaustive_search():
    """num_beams = vocab_size is exhaustive: the returned continuation is
    the true most probable one."""
    model = gpt.tiny_gpt(vocab_size=7, dropout_rate=0.0).eval()
    prompt = np.array([[1, 2, 3]], np.int32)
    out = generate_beam(model, prompt, max_new_tokens=2, num_beams=7)

    def seq_logprob(cont):
        seq = torch.as_tensor(np.concatenate([prompt[0], cont])[None])
        with torch.no_grad():
            lp = torch.log_softmax(model(seq)[0], dim=-1)
        return float(lp[2, cont[0]] + lp[3, cont[1]])

    best = max(itertools.product(range(7), repeat=2), key=seq_logprob)
    assert out[0, 3:].tolist() == list(best)


def test_beam_zero_new_tokens_returns_prompt():
    prompt = np.ones((2, 4), np.int32) * 3
    for use_cache in (False, True):
        out = _port_beam("gpt", prompt, max_new_tokens=0, num_beams=2,
                         use_cache=use_cache)
        np.testing.assert_array_equal(out, prompt)


def test_cached_beam_overflow_guard():
    with pytest.raises(ValueError, match="max_position|decode_cache_len"):
        _port_beam("gpt", np.ones((1, 4), np.int32), max_new_tokens=1000,
                   num_beams=2, use_cache=True)
    with pytest.raises(ValueError, match="num_beams"):
        _port_beam("gpt", np.ones((1, 4), np.int32), max_new_tokens=2,
                   num_beams=0)


def test_cache_row_map_and_rewind():
    cache = KVCache.zeros(2, (2, 8, 1, 4), dtype=torch.float32,
                          device="cpu")
    for layer in range(2):
        cache.keys[layer][1] = 1.0
    cache.advance(5)
    cache.map_rows(lambda x: x.repeat_interleave(3, dim=0))
    assert cache.keys[0].shape == (6, 8, 1, 4) and cache.index == 5
    assert cache.values[1].shape == (6, 8, 1, 4)
    cache.map_rows(lambda x: x.index_select(0, torch.tensor([5, 0])))
    assert cache.keys[1][:, 0, 0, 0].tolist() == [1.0, 0.0]
    cache.rewind(2)
    assert cache.index == 2
    with pytest.raises(ValueError, match="rewind"):
        cache.rewind(3)


# --- speculative decoding ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _drafter(family):
    """A one-layer drafter of the family, JAX-initialised from key 1."""
    if family == "gpt":
        cfg = dict(vocab_size=VOCAB, hidden_size=32, num_layers=1,
                   num_heads=2, max_position=128, dropout_rate=0.0)
        jm = jgpt.GptLM(jgpt.GptConfig(**cfg), dtype=jnp.float32)
        tm = gpt.GptLM(gpt.GptConfig(**cfg), dtype=torch.float32)
    else:
        cfg = dict(vocab_size=VOCAB, hidden_size=32, num_layers=1,
                   num_heads=2, num_kv_heads=2, intermediate_size=64,
                   decode_cache_len=64)
        jm = jllama.LlamaLM(jllama.LlamaConfig(**cfg), dtype=jnp.float32)
        tm = llama.LlamaLM(llama.LlamaConfig(**cfg), dtype=torch.float32)
    dv = jm.init({"params": jax.random.key(1)}, jnp.ones((1, 4), jnp.int32),
                 train=False)
    tm.load_state_dict(params_from_flax(flax_params(dv)))
    return jm, dv, tm.eval()


@pytest.mark.parametrize("family,draft_lens", [("gpt", (1, 4)),
                                               ("llama", (3,))])
def test_speculative_equals_jax_and_target_greedy(family, draft_lens):
    model, draft = _pair(family)[2], _drafter(family)[2]
    prompt = _prompt(11, (1, 5))
    greedy = generate(model, prompt, max_new_tokens=9).numpy()
    for k in draft_lens:
        ref = _jax_spec(family, k)
        out = generate_speculative(model, draft, prompt, max_new_tokens=9,
                                   draft_len=k).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=f"K={k}")
        np.testing.assert_array_equal(out, greedy, err_msg=f"K={k}")


def test_speculative_self_draft_and_guards():
    _, _, model = _pair("gpt")
    prompt = np.asarray([[3, 5, 7, 9]], np.int32)
    ref = generate(model, prompt, max_new_tokens=8)
    assert torch.equal(generate_speculative(model, model, prompt,
                                            max_new_tokens=8, draft_len=4),
                       ref)
    draft = _drafter("gpt")[2]
    with pytest.raises(ValueError, match="batch-1"):
        generate_speculative(model, draft, np.ones((2, 4), np.int32),
                             max_new_tokens=2)
    with pytest.raises(ValueError, match=">= 2"):
        generate_speculative(model, draft, np.ones((1, 1), np.int32),
                             max_new_tokens=2)
    with pytest.raises(ValueError, match="draft_len"):
        generate_speculative(model, draft, prompt, max_new_tokens=2,
                             draft_len=0)
    with pytest.raises(ValueError, match="max_position"):
        generate_speculative(model, draft, prompt, max_new_tokens=124,
                             draft_len=4)


# --- the CLI ----------------------------------------------------------------

def _run_cli(argv, capsys):
    assert cli.main(argv + ["--device", "cpu"]) == 0
    return [json.loads(line)["tokens"]
            for line in capsys.readouterr().out.splitlines()]


def test_cli_beam_and_draft_flags_equal_jax(tmp_path, capsys):
    params = tmp_path / "gpt.npz"
    np.savez(params, **flat_params(tiny_lm_params("gpt", VOCAB)))
    draft = tmp_path / "nano.npz"
    np.savez(draft, **flat_params(flax_params(_drafter("gpt")[1])))
    # The cases above, through the CLI: the JAX results are cached.
    prompt = _prompt(8, (2, 4))
    rows = [x for r in prompt for x in ("--prompt-ids",
                                        ",".join(map(str, r)))]
    base = ["--model", "gpt_tiny", "--params", str(params)]
    ref = _jax_beam("gpt", prompt, max_new_tokens=5, num_beams=3)
    for extra in ([], ["--use-cache"]):
        out = _run_cli(base + rows + ["--max-new-tokens", "5",
                                      "--num-beams", "3"] + extra, capsys)
        assert out == ref.tolist()
    out = _run_cli(base + ["--prompt-ids", ",".join(
        map(str, _prompt(11, (1, 5))[0])), "--max-new-tokens", "9",
        "--draft-model", "gpt_nano", "--draft-params", str(draft),
        "--draft-len", "4"], capsys)
    assert out == _jax_spec("gpt", 4).tolist()


@pytest.mark.parametrize("extra,match", [
    (["--num-beams", "2"], "greedy"),
    (["--temperature", "0.5"], "greedy"),
    (["--use-cache"], "drop --use-cache"),
    (["--draft-len", "0"], "need >= 1"),
    (["--no-draft-params"], "needs --draft-params")])
def test_cli_draft_refusals(tmp_path, extra, match):
    params = tmp_path / "gpt.npz"
    np.savez(params, **flat_params(tiny_lm_params("gpt", VOCAB)))
    argv = ["--model", "gpt_tiny", "--params", str(params), "--prompt-ids",
            "1,2,3", "--device", "cpu", "--draft-model", "gpt_nano"]
    if extra != ["--no-draft-params"]:
        argv += ["--draft-params", str(params)] + extra
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)
