"""The port's continuous-batching engine (distributeddeeplearning_tpu_torch/
serve/engine.py) against the JAX engine.

The engine runs the JAX engine's own scenarios with the same config, fake
clock and requests as the JAX engine: mid-stream retire and admit for both
families, preemption (a tenant's page cap tightened mid-run, a starved
request), and deadlines, bounded retry with backoff and brownout in one
sequence. Every request's tokens, outcome and times, the engine counters
and the free pages at the end must be equal. The prefix cache's scenarios
are in test_torch_serve_prefix.py, speculative decoding's in
test_torch_serve_spec.py, the paged model branches in
test_torch_serve_models.py. Around them, the refusals of this slice.
"""

import pytest
import torch

from distributeddeeplearning_tpu_torch.serve.engine import (Engine,
                                                            ServeConfig)
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from tests.torch_serve_helpers import (VOCAB, assert_same, engine_pair,
                                       prompts, run_pair)


# --- the engine against the JAX engine ---------------------------------------

def _midstream(eng, sched):
    """Five requests through two slots: slots retire and re-admit while
    others are mid-decode (tests/test_serve.py)."""
    lens = [(5, 6), (7, 4), (3, 8), (6, 5), (8, 3)]
    reqs = [eng.submit(p, max_new_tokens=m) for p, (_, m) in
            zip(prompts(0, [n for n, _ in lens]), lens)]
    eng.run_until_idle()
    return reqs


@pytest.mark.parametrize("model", ["gpt_tiny", "llama_tiny"])
def test_midstream_retire_admit_equals_jax(model):
    jeng, teng = engine_pair(model)
    jreqs, treqs = run_pair(_midstream, jeng, teng)
    assert all(len(r.tokens) == r.max_new_tokens for r in treqs)
    assert teng.allocator.free_pages == teng.config.num_pages
    assert_same(jeng, teng, jreqs, treqs)


def _preemption(eng, sched):
    """A tenant's page cap tightened mid-run; the starved request evicts
    the over-budget one, which resumes with its tokens folded in."""
    bg_prompt, rt_prompt = prompts(1, [4, 8])
    bg = eng.submit(bg_prompt, max_new_tokens=12, tenant="bg")  # 4 pages
    eng.step()
    eng.step()
    eng.scheduler.policies["bg"] = sched.TenantPolicy("bg", max_pages=3)
    rt = eng.submit(rt_prompt, max_new_tokens=12, tenant="rt")  # 5 pages
    eng.step()
    assert eng.preemptions == 1 and bg in list(eng.waiting)
    del eng.scheduler.policies["bg"]
    eng.run_until_idle()
    return [bg, rt]


def test_preemption_equals_jax():
    jeng, teng = engine_pair("gpt_tiny", num_pages=8)
    jreqs, treqs = run_pair(_preemption, jeng, teng)
    assert treqs[0].preemptions == 1 and teng.preemptions == 1
    assert_same(jeng, teng, jreqs, treqs)


def _deadlines(eng, sched):
    """Deadlines, bounded retry with backoff and brownout, one after the
    other on one engine (the JAX tests' scenarios)."""
    out = []
    # A first-token deadline already past: never admitted.
    eng.scheduler = sched.SloScheduler(
        [sched.TenantPolicy("rt", ttft_deadline_s=0.0)])
    out.append(eng.submit([1, 2, 3, 4], max_new_tokens=3, tenant="rt"))
    eng.step()
    # A total deadline blown mid-decode: the live slot is cancelled.
    eng.scheduler = sched.SloScheduler(
        [sched.TenantPolicy("rt", total_deadline_s=0.004)])
    req = eng.submit([1, 2, 3, 4], max_new_tokens=16, tenant="rt")
    out.append(req)
    for _ in range(16):
        if req.failed is not None:
            break
        eng.step()
    # The retry budget: with max_retries 0 the victim fails.
    policy = sched.SloScheduler([sched.TenantPolicy("bg", max_pages=8)],
                                max_retries=0)
    eng.scheduler = policy
    out += [eng.submit([1, 2, 3, 4], max_new_tokens=12, tenant="bg"),
            eng.submit([5, 6, 7, 8], max_new_tokens=12, tenant="bg")]
    eng.step()
    policy.policies["bg"] = sched.TenantPolicy("bg", max_pages=0)
    out.append(eng.submit([9, 10, 11, 12], max_new_tokens=3, tenant="rt"))
    eng.run_until_idle()
    # Backoff: a victim waits 2 ms before it may re-admit.
    policy = sched.SloScheduler([sched.TenantPolicy("bg", max_pages=8)],
                                retry_backoff_s=0.002)
    eng.scheduler = policy
    out += [eng.submit([2, 3, 4, 5], max_new_tokens=10, tenant="bg"),
            eng.submit([6, 7, 8, 9], max_new_tokens=10, tenant="bg")]
    eng.step()
    policy.policies["bg"] = sched.TenantPolicy("bg", max_pages=0)
    out.append(eng.submit([3, 4, 5], max_new_tokens=4, tenant="rt"))
    eng.step()
    del policy.policies["bg"]
    eng.run_until_idle()
    # Brownout: queue pressure sheds the overdue.
    eng.scheduler = sched.SloScheduler(
        [sched.TenantPolicy("rt", ttft_slo_s=0.0)])
    eng.brownout = sched.BrownoutController(queue_pressure=2,
                                            max_shed_per_step=2)
    out += [eng.submit([1, 2, 3, 4], max_new_tokens=3, tenant="rt"),
            eng.submit([5, 6, 7, 8], max_new_tokens=3, tenant="rt")]
    eng.step()
    eng.brownout = None
    return out


def test_deadlines_retry_and_brownout_equal_jax():
    jeng, teng = engine_pair("gpt_tiny")
    jreqs, treqs = run_pair(_deadlines, jeng, teng)
    assert [r.failed for r in treqs] == [
        "deadline", "deadline", None, "retries_exhausted", None, None, None,
        None, "shed", "shed"]
    assert len(treqs[1].tokens) >= 1
    assert teng.deadline_misses == 2 and teng.sheds == 3
    # The newest bg slot was the backoff victim.
    assert teng.retries == 2 and treqs[6].not_before_s > 0
    assert_same(jeng, teng, jreqs, treqs)


# --- refusals -------------------------------------------------------------

def _cpu_engine(**kw):
    cfg = dict(model="gpt_tiny", vocab_size=VOCAB, max_slots=1, page_size=4,
               num_pages=16, max_pages_per_slot=4, prefill_buckets=(8,))
    fault_plan = kw.pop("fault_plan", None)
    return Engine(ServeConfig(**{**cfg, **kw}), device="cpu",
                  fault_plan=fault_plan)


@pytest.mark.parametrize("prompt,max_new,match", [
    (list(range(1, 9)), 9, "slot holds at most 16"),
    (list(range(1, 11)), 2, "largest prefill bucket"),
    ([], 2, "empty prompt"),
    ([1, 2], 0, "emits nothing")])
def test_submit_refuses(prompt, max_new, match):
    eng = _cpu_engine()
    with pytest.raises(ValueError, match=match):
        eng.submit(prompt, max_new_tokens=max_new)


@pytest.mark.parametrize("kw,match", [
    # gpt_tiny's max_position is 128; 64-token pages x 4 = 256.
    ({"page_size": 64}, "decode bound"),
    ({"prefill_buckets": (32,)}, "largest prefill bucket"),
    ({"prefill_buckets": ()}, "at least one"),
    # kw3 and kw4 held the speculative configs until the engine carried
    # them: a drafter of a later slice's registry entry keeps their IDs.
    ({"spec_draft_model": "gpt_tiny_pp", "spec_k": 3},
     "speculative decoding .* later slice"),
    ({"spec_draft_model": "gpt2_small_pp", "spec_k": 2},
     "speculative decoding .* later slice"),
    ({"fault_plan": "page_leak@1"}, "fault plans .* later slice"),
    ({"model": "bert_tiny"}, "decode"),
    ({"spec_k": 2}, "needs BOTH spec_draft_model and spec_k"),
    ({"spec_draft_model": "gpt_nano"}, "needs BOTH"),
    # gpt_nano's 128 positions against 64-token pages x 4 = 256.
    ({"page_size": 64, "model": "llama_tiny",
      "spec_draft_model": "gpt_nano", "spec_k": 2},
     "drafter's decode bound")])
def test_engine_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        _cpu_engine(**kw)


def test_engine_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        assert Engine(ServeConfig(vocab_size=VOCAB)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(ServeConfig(vocab_size=VOCAB))


def test_compile_cache_dir_is_accepted_and_warmup_keeps_pools():
    eng = _cpu_engine(compile_cache_dir="/nonexistent", prefix_cache=True)
    for pool in eng.pools.keys + eng.pools.values:
        pool.normal_()
    before = [p.clone() for p in eng.pools.keys + eng.pools.values]
    seconds = eng.warmup()
    assert set(seconds) == {"prefill_8", "page_clone", "decode"}
    for a, b in zip(before, eng.pools.keys + eng.pools.values):
        assert torch.equal(a, b)
    assert eng.steps == 0 and eng.cow_copies == 0
