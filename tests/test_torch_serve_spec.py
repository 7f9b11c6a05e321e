"""The port's engine with speculative decoding on, against the JAX engine
(the scenarios of tests/test_serve_fastpath.py).

A drafter (gpt_nano or llama_nano, or the target itself) proposes up to
``spec_k`` tokens a slot by paged decode steps over its own pools, one
target forward over the paged block branch verifies every slot's block.
Both engines run on the shared fake clock with the JAX engine's target and
drafter weights (``params_from_flax``). Tolerance: every request's tokens,
outcome and times, and every counter (``spec_rounds``, ``spec_proposed``,
``spec_accepted`` included), are equal exactly; tokens also equal the
port's ``generate(use_cache=True)`` of each request alone. One engine pair
per family runs two scenarios in turn (the JAX engine compiles its
programs anew for every config): two requests through a drafter, then a
preemption with the prefix cache on, whose victim resumes with its drafter
re-prefilled and must finish with the uninterrupted tokens. A self-draft
accepts every proposal.
"""

import pytest
import torch

from distributeddeeplearning_tpu_torch.models.generate import generate
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from tests.torch_serve_helpers import (assert_same, engine_pair, prompts,
                                       run_pair)


def _reference(eng, req) -> list:
    out = generate(eng.model, [req.prompt], max_new_tokens=req.max_new_tokens,
                   use_cache=True)
    return out[0, len(req.prompt):].tolist()


def _two_requests(eng, sched):
    reqs = [eng.submit(p, max_new_tokens=7) for p in prompts(7, [8, 8])]
    eng.run_until_idle()
    return reqs


def _preemption(eng, sched):
    """A tenant's page cap tightened mid-run; the starved request evicts
    the over-budget one, which resumes with its tokens folded in and its
    drafter re-prefilled over the shared pages."""
    bg_prompt, rt_prompt = prompts(11, [4, 8])
    bg = eng.submit(bg_prompt, max_new_tokens=12, tenant="bg")
    eng.step()
    eng.step()
    assert eng.num_live == 1 and len(bg.tokens) >= 1
    eng.scheduler.policies["bg"] = sched.TenantPolicy("bg", max_pages=3)
    rt = eng.submit(rt_prompt, max_new_tokens=12, tenant="rt")
    for _ in range(8):
        if eng.preemptions:
            break
        eng.step()
    assert eng.preemptions == 1 and bg.preemptions == 1
    del eng.scheduler.policies["bg"]
    eng.run_until_idle()
    return [bg, rt]


@pytest.mark.parametrize("model,draft", [("gpt_tiny", "gpt_nano"),
                                         ("llama_tiny", "llama_nano")])
def test_spec_decode_and_preemption_equal_jax(model, draft):
    # num_pages=8: rt's 5 pages cannot fit beside bg's 4, so the capped bg
    # slot must be preempted.
    jeng, teng = engine_pair(model, num_pages=8, prefix_cache=True,
                             spec_draft_model=draft, spec_k=3)
    assert teng.draft_model is not None
    jreqs, treqs = run_pair(_two_requests, jeng, teng)
    with torch.inference_mode():
        for req in treqs:
            assert req.tokens == _reference(teng, req), req.uid
    assert teng.spec_rounds > 0 and teng.spec_proposed > 0
    assert 0 <= teng.spec_accepted <= teng.spec_proposed
    assert_same(jeng, teng, jreqs, treqs)

    rounds = teng.spec_rounds
    jreqs, treqs = run_pair(_preemption, jeng, teng)
    assert treqs[0].preemptions == 1 and teng.spec_rounds > rounds
    with torch.inference_mode():
        for req in treqs:
            assert req.tokens == _reference(teng, req), req.uid
    assert_same(jeng, teng, jreqs, treqs)


def test_self_draft_accepts_everything_equal_jax():
    """Drafter == target (same name, same seed rule, equal weights): every
    proposal matches the target's argmax."""
    jeng, teng = engine_pair("gpt_tiny", spec_draft_model="gpt_tiny",
                             spec_k=4)
    for a, b in zip(teng.model.state_dict().values(),
                    teng.draft_model.state_dict().values()):
        assert torch.equal(a, b)

    def scenario(eng, sched):
        req = eng.submit(list(range(1, 7)), max_new_tokens=8)
        eng.run_until_idle()
        return [req]

    jreqs, treqs = run_pair(scenario, jeng, teng)
    assert teng.spec_proposed > 0
    assert teng.spec_accepted == teng.spec_proposed
    with torch.inference_mode():
        assert treqs[0].tokens == _reference(teng, treqs[0])
    assert_same(jeng, teng, jreqs, treqs)


def test_spec_warmup_keeps_pools_and_runs_every_forward():
    from distributeddeeplearning_tpu_torch.serve.engine import (Engine,
                                                                ServeConfig)

    eng = Engine(ServeConfig(vocab_size=97, max_slots=2, page_size=4,
                             num_pages=16, max_pages_per_slot=4,
                             prefill_buckets=(8,), prefix_cache=True,
                             spec_draft_model="gpt_nano", spec_k=2),
                 device="cpu")
    pools = (eng.pools.keys + eng.pools.values + eng.draft_pools.keys
             + eng.draft_pools.values)
    for pool in pools:
        pool.normal_()
    before = [p.clone() for p in pools]
    seconds = eng.warmup()
    assert set(seconds) == {"prefill_8", "draft_prefill_8", "page_clone",
                            "draft_decode", "verify"}
    for a, b in zip(before, pools):
        assert torch.equal(a, b)
    assert eng.spec_rounds == 0 and eng.cow_copies == 0
