"""The port's paged KV cache (distributeddeeplearning_tpu_torch/serve/
kv_cache.py) against the JAX package's, on the same seeded numpy inputs.

Paged attention (the one-token step and the block path) is held per output
row within 1e-5 of the row's largest |ref| in f32, with GQA, dead slots and
block columns past ``n_new``; the pools after the writes, the prefill
packing and the copy-on-write clone must equal JAX's exactly (they are
copies). The allocator and the radix prefix cache are driven through the
same seeded call sequence on both sides: every result, free count,
refcount, eviction and error message must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu.serve import kv_cache as jkv
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.models.decode_cache import KVCache
from distributeddeeplearning_tpu_torch.serve import kv_cache as tkv
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

NUM_PAGES, PAGE_SIZE, PAGES_PER_SLOT = 12, 4, 3
HEADS, KVH, D = 4, 2, 8
ROW_TOL = 1e-5


def _pools(rng):
    shape = (NUM_PAGES, PAGE_SIZE, KVH, D)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _table():
    # Slot 0: pages 2, 5, 7; slot 1: 1, 6, 3; slot 2 (dead): arbitrary;
    # slot 3: 9, 0, 11.
    return np.array([[2, 5, 7], [1, 6, 3], [0, 0, 0], [9, 0, 11]], np.int64)


def _close_rows(out, ref):
    """Each output row (one slot, one block column) within ROW_TOL of its
    largest |ref|."""
    out = out.reshape(-1, out.shape[-1])
    ref = ref.reshape(-1, ref.shape[-1])
    assert np.isfinite(out).all()
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-30)
    np.testing.assert_array_less(np.abs(out - ref) / scale, ROW_TOL)


def _jax_state(cls, *arrays):
    return cls(*[jnp.asarray(a) for a in arrays])


def _torch_state(cls, *arrays):
    return cls(*[torch.as_tensor(a) for a in arrays])


@pytest.mark.parametrize("lengths", [[3, 11, 0, 5], [0, 4, 0, 8]])
def test_paged_attention_step_matches_jax(lengths):
    rng = np.random.default_rng(sum(lengths))
    pool_k, pool_v = _pools(rng)
    q = rng.standard_normal((4, 1, HEADS, D)).astype(np.float32)
    k_new = rng.standard_normal((4, 1, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((4, 1, KVH, D)).astype(np.float32)
    state = (_table(), np.array(lengths, np.int64),
             np.array([True, True, False, True]))
    ref, rk, rv = jkv.paged_attention_step(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(pool_k), jnp.asarray(pool_v),
        _jax_state(jkv.PagedState, *state))
    tk, tv = torch.tensor(pool_k), torch.tensor(pool_v)
    out = tkv.paged_attention_step(
        torch.tensor(q), torch.tensor(k_new), torch.tensor(v_new), tk, tv,
        _torch_state(tkv.PagedState, *state))
    assert out.shape == (4, 1, HEADS * D)
    _close_rows(out.numpy(), np.asarray(ref))
    # The writes (the dead slot's dropped) land where JAX's do.
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


@pytest.mark.parametrize("t_block,n_new", [(3, [3, 1, 2, 0]),
                                           (5, [2, 5, 0, 4])])
def test_paged_attention_block_matches_jax(t_block, n_new):
    rng = np.random.default_rng(t_block)
    pool_k, pool_v = _pools(rng)
    q = rng.standard_normal((4, t_block, HEADS, D)).astype(np.float32)
    k_new = rng.standard_normal((4, t_block, KVH, D)).astype(np.float32)
    v_new = rng.standard_normal((4, t_block, KVH, D)).astype(np.float32)
    # Slot 3's base 10 runs its later columns past the slot's 12
    # positions: their page index is clamped and their writes dropped.
    lengths = np.array([2, 6, 0, 10], np.int64)
    live = np.array([True, True, False, True])
    n_new = np.minimum(np.array(n_new, np.int64),
                       PAGE_SIZE * PAGES_PER_SLOT - lengths)
    state = (_table(), lengths, live, n_new)
    ref, rk, rv = jkv.paged_attention_block(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(pool_k), jnp.asarray(pool_v),
        _jax_state(jkv.PagedBlockState, *state))
    tk, tv = torch.tensor(pool_k), torch.tensor(pool_v)
    out = tkv.paged_attention_block(
        torch.tensor(q), torch.tensor(k_new), torch.tensor(v_new), tk, tv,
        _torch_state(tkv.PagedBlockState, *state))
    assert out.shape == (4, t_block, HEADS * D)
    _close_rows(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(rv))


def test_block_equals_sequential_steps():
    """The block path over T columns gives each slot what T one-token
    steps give, row for row (the masked keys underflow to exactly 0)."""
    rng = np.random.default_rng(7)
    pool_k, pool_v = _pools(rng)
    t_block = 3
    q = torch.tensor(rng.standard_normal((4, t_block, HEADS, D)),
                     dtype=torch.float32)
    k_new = torch.tensor(rng.standard_normal((4, t_block, KVH, D)),
                         dtype=torch.float32)
    v_new = torch.tensor(rng.standard_normal((4, t_block, KVH, D)),
                         dtype=torch.float32)
    table = torch.as_tensor(_table())
    lengths = torch.tensor([1, 4, 0, 7])
    live = torch.tensor([True, True, False, True])
    bk, bv = torch.tensor(pool_k), torch.tensor(pool_v)
    block = tkv.paged_attention_block(
        q, k_new, v_new, bk, bv,
        tkv.PagedBlockState(table, lengths, live,
                            torch.full((4,), t_block)))
    sk, sv = torch.tensor(pool_k), torch.tensor(pool_v)
    for t in range(t_block):
        step = tkv.paged_attention_step(
            q[:, t:t + 1], k_new[:, t:t + 1], v_new[:, t:t + 1], sk, sv,
            tkv.PagedState(table, lengths + t, live))
        for i in (0, 1, 3):
            _close_rows(block[i, t].numpy()[None], step[i, 0].numpy()[None])
    assert torch.equal(bk, sk) and torch.equal(bv, sv)


def _jax_dense_cache(keys, values):
    """A flax ``cache`` collection of a dense decode prefill: per layer the
    K/V buffers and a write index, plus GPT's position counter."""
    cache = {f"layer{i}": {"attention": {
        "cached_key": jnp.asarray(k), "cached_value": jnp.asarray(v),
        "cache_index": jnp.int32(k.shape[1])}}
        for i, (k, v) in enumerate(zip(keys, values))}
    cache["position"] = jnp.int32(0)
    return cache


def _jax_pools(keys, values):
    return {f"layer{i}": {"attention": {
        "pages_k": jnp.asarray(k), "pages_v": jnp.asarray(v)}}
        for i, (k, v) in enumerate(zip(keys, values))}


def _assert_pools_equal(tpools, jpools):
    for i, (k, v) in enumerate(zip(tpools.keys, tpools.values)):
        leaf = jpools[f"layer{i}"]["attention"]
        np.testing.assert_array_equal(k.numpy(), np.asarray(leaf["pages_k"]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(leaf["pages_v"]))


@pytest.mark.parametrize("plen", [1, 6, 9])
def test_pack_prefill_cache_matches_jax(plen):
    rng = np.random.default_rng(plen)
    layers, bucket = 2, 12
    dense_k = [rng.standard_normal((1, bucket, KVH, D)).astype(np.float32)
               for _ in range(layers)]
    dense_v = [rng.standard_normal((1, bucket, KVH, D)).astype(np.float32)
               for _ in range(layers)]
    pools = [_pools(rng) for _ in range(layers)]
    page_row = np.array([4, 10, 1], np.int64)
    ref = jkv.pack_prefill_cache(
        _jax_dense_cache(dense_k, dense_v),
        _jax_pools([p[0] for p in pools], [p[1] for p in pools]),
        page_row=jnp.asarray(page_row), plen=jnp.int32(plen))
    tpools = tkv.PagedPools(keys=[torch.tensor(p[0]) for p in pools],
                            values=[torch.tensor(p[1]) for p in pools])
    tkv.pack_prefill_cache(
        KVCache(keys=[torch.tensor(k) for k in dense_k],
                values=[torch.tensor(v) for v in dense_v]),
        tpools, page_row=torch.as_tensor(page_row), plen=plen)
    _assert_pools_equal(tpools, ref)


def test_clone_page_rows_matches_jax():
    rng = np.random.default_rng(3)
    pools = [_pools(rng) for _ in range(2)]
    ref = jkv.clone_page_rows(
        _jax_pools([p[0] for p in pools], [p[1] for p in pools]),
        jnp.int32(7), jnp.int32(2))
    tpools = tkv.PagedPools(keys=[torch.tensor(p[0]) for p in pools],
                            values=[torch.tensor(p[1]) for p in pools])
    tkv.clone_page_rows(tpools, 7, 2)
    _assert_pools_equal(tpools, ref)


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_init_pools_matches_jax_shapes(family):
    jmodel = {"gpt": jgpt.tiny_gpt, "llama": jllama.tiny_llama}[family](
        vocab_size=97)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0)}, jnp.ones((1, 4), jnp.int32),
        train=False))
    ref = jkv.init_pools(jmodel, variables, num_pages=6, page_size=4)
    model = get_model(f"{family}_tiny", dtype=torch.float32, device="cpu",
                      vocab_size=97)
    pools = tkv.init_pools(model, num_pages=6, page_size=4)
    assert len(pools.keys) == len(ref) == model.cfg.num_layers
    for i, (k, v) in enumerate(zip(pools.keys, pools.values)):
        leaf = ref[f"layer{i}"]["attention"]
        assert k.shape == v.shape == leaf["pages_k"].shape
        assert k.dtype == torch.float32 and not k.any()


def test_init_pools_refuses_a_model_without_decode():
    model = get_model("bert_tiny", dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="decode"):
        tkv.init_pools(model, num_pages=4, page_size=4)


def test_pages_needed_is_ceil_division():
    for n in range(1, 30):
        assert tkv.pages_needed(n, 4) == jkv.pages_needed(n, 4)


def _call(record, fn, *args):
    """Record ``fn(*args)``'s result, or its error's type and message."""
    try:
        out = fn(*args)
    except (ValueError, RuntimeError) as e:
        record.append(("error", type(e).__name__, str(e)))
        return None
    record.append(("ok", out))
    return out


def _drive(kv, seed: int, steps: int = 300) -> list:
    """One seeded sequence of allocator and radix-tree calls against
    module ``kv``; returns everything observable after each call."""
    rng = np.random.default_rng(seed)
    alloc = kv.PageAllocator(10)
    tree = kv.RadixPrefixCache(alloc, page_size=2)
    claims: list = []     # the slots' claims (a multiset of pages)
    record: list = []
    for _ in range(steps):
        op = rng.integers(10)
        page = int(rng.integers(10))
        if op == 0:
            got = _call(record, alloc.alloc, int(rng.integers(0, 4)))
            claims.extend(got or [])
        elif op == 1:
            _call(record, alloc.incref, [page])
            if record[-1][0] == "ok":
                claims.append(page)
        elif op == 2:
            _call(record, alloc.decref, [page])
            if page in claims and record[-1][0] == "ok":
                claims.remove(page)
        elif op == 3:
            _call(record, alloc.free, [page])
            if page in claims and record[-1][0] == "ok":
                claims.remove(page)
        elif op == 4:
            sample = [int(p) for p in rng.integers(10, size=2)]
            _call(record, alloc.release, sample)
            claims = [p for p in claims if p not in sample]
        elif op == 5:
            _call(record, alloc.assert_writable,
                  [int(p) for p in rng.integers(10, size=3)])
        elif op == 6:
            tokens = [int(t) for t in rng.integers(0, 3, rng.integers(1, 8))]
            pages = alloc.alloc(len(tokens) // 2)
            if pages is not None:
                claims.extend(pages)
                _call(record, tree.insert, tokens, pages)
        elif op == 7:
            tokens = [int(t) for t in rng.integers(0, 3, rng.integers(1, 8))]
            _call(record, tree.match, tokens)
        elif op == 8:
            _call(record, tree.evict, int(rng.integers(0, 4)))
        else:
            owned = claims + tree.owned_pages()
            if rng.integers(2):
                owned = owned + [page]   # a claim nobody holds
            _call(record, alloc.check_leaks, owned)
        record.append(("state", alloc.free_pages, list(alloc._free),
                       sorted(alloc._ref.items()),
                       sorted(tree.owned_pages()), tree.evictable_pages(),
                       tree.evictions))
    return record


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_and_radix_cache_follow_jax(seed):
    ref = _drive(jkv, seed)
    out = _drive(tkv, seed)
    kinds = {r[0] for r in ref}
    assert {"ok", "error", "state"} <= kinds   # the sequence hits errors
    for i, (a, b) in enumerate(zip(out, ref)):
        assert a == b, f"call {i}: port {a} != JAX {b}"
    assert len(out) == len(ref)


def test_double_free_and_shared_write_errors_match_jax():
    for kv in (jkv, tkv):
        alloc = kv.PageAllocator(4)
        (p,) = alloc.alloc(1)
        alloc.incref([p])
        with pytest.raises(RuntimeError, match=r"shared page\(s\) \[0\]"):
            alloc.assert_writable([p])
        alloc.free([p])
        alloc.free([p])
        with pytest.raises(ValueError, match="double-free of page 0"):
            alloc.free([p])
        with pytest.raises(ValueError, match="double-decref of page 0"):
            alloc.decref([p])
