"""The port's engine with the radix prefix cache on, against the JAX
engine (the scenarios of tests/test_serve_fastpath.py).

Shared-head prompts must hit the tree (full pages mapped shared, only the
suffix prefilled over the paged block branch), a page-aligned prompt
submitted twice must copy its partial trailing page on write, a pool too
small for every retired prefix must evict LRU tree pages, and concurrent
shared-head requests must share pinned pages across a preemption. Every
request's tokens, outcome and times, the counters (hits, misses, tokens
reused, copies, evictions) and the pages left in the tree must equal the
JAX engine's, and both leak checks must pass with the tree's pages live.
"""

import pytest

from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from tests.torch_serve_helpers import (assert_same, engine_pair, prompts,
                                       run_pair)


def _shared_head(seed, head_len=9, tails=(5, 5, 5)):
    """One shared head + distinct tails; 9 tokens at page size 4 leave a
    partial trailing chunk."""
    head, *rest = prompts(seed, (head_len, *tails))
    return [head + tail for tail in rest]


def _reuse(eng, sched):
    reqs = []
    for p in _shared_head(3):
        reqs.append(eng.submit(p, max_new_tokens=5))
        eng.run_until_idle()
    return reqs


@pytest.mark.parametrize("model", ["gpt_tiny", "llama_tiny"])
def test_prefix_reuse_equals_jax(model):
    jeng, teng = engine_pair(model, prefix_cache=True, prefill_buckets=(16,))
    jreqs, treqs = run_pair(_reuse, jeng, teng)
    assert (teng.prefix_hits, teng.prefix_misses) == (2, 1)
    assert teng.prefix_tokens_reused == 16 and teng.cow_copies == 0
    assert_same(jeng, teng, jreqs, treqs)


def _cow(eng, sched):
    prompt = list(range(1, 9))   # 8 tokens: exactly 2 full pages
    a = eng.submit(prompt, max_new_tokens=5)
    eng.run_until_idle()
    b = eng.submit(prompt, max_new_tokens=5)
    eng.run_until_idle()
    return [a, b]


def test_copy_on_write_of_the_trailing_page_equals_jax():
    jeng, teng = engine_pair("gpt_tiny", prefix_cache=True,
                             prefill_buckets=(16,))
    jreqs, treqs = run_pair(_cow, jeng, teng)
    assert teng.cow_copies == 1 and teng.prefix_hits == 1
    assert treqs[0].tokens == treqs[1].tokens
    assert_same(jeng, teng, jreqs, treqs)


def _evict(eng, sched):
    reqs = []
    for p in prompts(5, [6] * 4):
        reqs.append(eng.submit(p, max_new_tokens=4))
        eng.run_until_idle()
    return reqs


def test_eviction_under_pool_pressure_equals_jax():
    jeng, teng = engine_pair("gpt_tiny", max_slots=1, num_pages=4,
                             prefix_cache=True, prefill_buckets=(8,))
    jreqs, treqs = run_pair(_evict, jeng, teng)
    assert teng.prefix.evictions > 0 and teng.prefix.num_nodes() > 0
    assert_same(jeng, teng, jreqs, treqs)


def _concurrent(eng, sched):
    """Six shared-head requests at once through two slots: later ones map
    pages a live slot still holds; a page cap tightened mid-run preempts
    one, whose re-admission folds its tokens in and hits the tree too."""
    reqs = [eng.submit(p, max_new_tokens=6, tenant="bg" if i % 2 else "rt")
            for i, p in enumerate(_shared_head(7, tails=(3, 4, 5, 2, 6, 3)))]
    eng.step()
    eng.step()
    eng.scheduler.policies["bg"] = sched.TenantPolicy("bg", max_pages=2)
    eng.step()
    eng.step()
    del eng.scheduler.policies["bg"]
    eng.run_until_idle()
    return reqs


def test_concurrent_shared_heads_with_preemption_equal_jax():
    jeng, teng = engine_pair("gpt_tiny", prefix_cache=True,
                             prefill_buckets=(16,), num_pages=16)
    jreqs, treqs = run_pair(_concurrent, jeng, teng)
    assert teng.prefix_hits >= 4 and teng.preemptions >= 1
    assert all(len(r.tokens) == 6 for r in treqs)
    assert_same(jeng, teng, jreqs, treqs)
