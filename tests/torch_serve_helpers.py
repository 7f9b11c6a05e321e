"""Shared pieces of the serve engine's port tests (tests/test_torch_serve_
engine.py and test_torch_serve_prefix.py): a JAX engine and a port engine
built from one config and one set of weights, each on a fake clock, and
the comparison of what the two did with the same requests.

The fake clocks advance 1 ms a call, and both engines read their clock at
the same points (submit, step start, after a prefill, after a decode), so
TTFTs, inter-token gaps and deadline decisions must be equal too.
"""

from __future__ import annotations

import numpy as np
import torch

from distributeddeeplearning_tpu.serve import engine as jengine
from distributeddeeplearning_tpu.serve import scheduler as jsched
from distributeddeeplearning_tpu_torch.serve import engine as tengine
from distributeddeeplearning_tpu_torch.serve import scheduler as tsched
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.torch_port_helpers import flax_params

VOCAB = 97
COUNTERS = ("steps", "preemptions", "sheds", "deadline_misses", "retries",
            "prefix_hits", "prefix_misses", "prefix_tokens_reused",
            "cow_copies", "spec_rounds", "spec_proposed", "spec_accepted")


def fake_clock():
    """A clock that advances 1 ms a reading; ``clock.t[0]`` is its time."""
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]
    clock.t = t
    return clock


def engine_pair(model: str = "gpt_tiny", **kw):
    """``(jax_engine, port_engine)`` over one ``ServeConfig`` (the JAX
    tests' defaults), the port's weights carried from the JAX engine's (the
    drafter's too, under speculative decoding)."""
    kw.setdefault("vocab_size", VOCAB)
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 32)
    kw.setdefault("max_pages_per_slot", 8)
    kw.setdefault("prefill_buckets", (8, 16))
    # No AOT cache on the JAX side: nothing read from earlier runs.
    jeng = jengine.Engine(jengine.ServeConfig(model=model,
                                              compile_cache_dir="off", **kw),
                          clock=fake_clock())
    state = params_from_flax(flax_params(jeng._fresh))
    draft = (params_from_flax(flax_params(jeng._draft_fresh))
             if jeng._draft_model is not None else None)
    teng = tengine.Engine(tengine.ServeConfig(model=model, **kw),
                          state_dict=state, draft_state_dict=draft,
                          device="cpu", clock=fake_clock())
    return jeng, teng


def run_pair(scenario, jeng, teng):
    """Run ``scenario(engine, scheduler_module)`` on both engines; returns
    the two lists of requests it made."""
    with torch.inference_mode():
        treqs = scenario(teng, tsched)
    return scenario(jeng, jsched), treqs


def assert_same(jeng, teng, jreqs, treqs) -> None:
    """Equal tokens, outcomes and times for every request, equal engine
    counters and page accounting, and both leak checks passing."""
    assert len(jreqs) == len(treqs)
    for a, b in zip(treqs, jreqs):
        assert a.tokens == b.tokens, f"request {b.uid}: tokens"
        assert (a.failed, a.preemptions, a.retries) == (
            b.failed, b.preemptions, b.retries), f"request {b.uid}"
        assert (a.ttft_s, a.itl_s, a.finished_s) == (
            b.ttft_s, b.itl_s, b.finished_s), f"request {b.uid}: times"
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.allocator.free_pages == jeng.allocator.free_pages
    assert teng.allocator.pages_in_use == jeng.allocator.pages_in_use
    assert [r.uid for r in teng.finished] == [r.uid for r in jeng.finished]
    assert [r.uid for r in teng.failed] == [r.uid for r in jeng.failed]
    if jeng.prefix is not None:
        assert teng.prefix.evictions == jeng.prefix.evictions
        assert sorted(teng.prefix.owned_pages()) == sorted(
            jeng.prefix.owned_pages())
    teng.shutdown()
    jeng.shutdown()


def prompts(seed: int, lengths) -> list:
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(1, VOCAB, n)] for n in lengths]
