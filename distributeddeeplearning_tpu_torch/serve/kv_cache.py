"""Paged KV cache: fixed-size pages from a preallocated pool.

Counterpart of ``distributeddeeplearning_tpu/serve/kv_cache.py``. The dense
decode cache (models/decode_cache.py) holds ``(B, capacity, heads, d)`` per
request, so its memory scales with batch x the static position bound.
Serving wants memory that scales with live tokens:

- one pool per attention layer and per K/V, ``(num_pages, page_size,
  kv_heads, head_dim)`` in the model's compute dtype, allocated once and
  kept in one :class:`PagedPools` object the engine owns; the decode
  forwards write it in place;
- a per-slot page table ``(max_slots, max_pages_per_slot)``: entry ``j``
  of a slot's row covers positions ``[j*page_size, (j+1)*page_size)``;
- a host-side refcounted free list (:class:`PageAllocator`), so a retiring
  slot's pages serve the next admission without a copy. A page may be
  shared by a radix prefix cache (:class:`RadixPrefixCache`) and any
  number of slots; in-place writes are legal only at refcount 1 (copy on
  write: ``assert_writable`` / :func:`clone_page_rows`).

The numerics are the dense decode branches': the same ``d**-0.5`` scale,
scores masked with ``finfo(f32).min`` and a softmax in f32 (masked keys
underflow to exactly 0.0, so dead rows stay finite and paged equals dense),
and a gather in page-table order, so a slot's context is the prefix of its
positions. JAX drops dead-slot and pad writes through an out-of-range index
(``mode="drop"``); here the valid rows are selected by their mask and only
those are written.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class PagedState(NamedTuple):
    """Per-step view of the slot table, passed to a decode forward.

    ``page_table`` (max_slots, max_pages_per_slot) int64 pool page ids in
    position order; entries past a slot's allocation are arbitrary (their
    keys are masked by ``lengths``). ``lengths`` (max_slots,) int64: tokens
    already cached per slot, which is also the position of the token
    decoded this step; 0 for dead slots. ``live`` (max_slots,) bool: the
    slot holds a request; dead slots' writes are dropped.
    """

    page_table: torch.Tensor
    lengths: torch.Tensor
    live: torch.Tensor


class PagedBlockState(NamedTuple):
    """Block variant of :class:`PagedState`: every slot advances up to
    ``T`` tokens in one forward (the suffix prefill after a radix prefix
    hit). ``n_new`` (max_slots,) int64: how many of the ``T`` block columns
    are real for each slot; the writes of the others (and of every column
    of a dead slot) are dropped and their outputs are garbage the caller
    ignores. ``lengths`` is the base position: column ``t`` of slot ``i``
    sits at ``lengths[i] + t``.
    """

    page_table: torch.Tensor
    lengths: torch.Tensor
    live: torch.Tensor
    n_new: torch.Tensor


@dataclasses.dataclass
class PagedPools:
    """Per-layer K and V pools, ``(num_pages, page_size, kv_heads, d)``."""

    keys: list[torch.Tensor]
    values: list[torch.Tensor]

    @property
    def page_size(self) -> int:
        return self.keys[0].shape[1]

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in self.keys + self.values)


def pages_needed(total_tokens: int, page_size: int) -> int:
    """Pages covering ``total_tokens`` positions (ceil division)."""
    return -(-int(total_tokens) // int(page_size))


def _write_rows(pool: torch.Tensor, flat_idx: torch.Tensor,
                valid: torch.Tensor, rows: torch.Tensor) -> None:
    """Write ``rows[valid]`` at flat pool rows ``flat_idx[valid]`` in place;
    the other rows are dropped (JAX's out-of-range index with
    ``mode="drop"``)."""
    num_pages, page_size, kvh, d = pool.shape
    flat = pool.view(num_pages * page_size, kvh, d)
    flat[flat_idx[valid]] = rows[valid].to(pool.dtype)


def _attend(q, k_ctx, v_ctx, visible):
    """Grouped attention of ``q`` (S, T, heads, d) over each slot's gathered
    context (S, ctx, kv_heads, d); ``visible`` (S, T, ctx) bool. Returns
    (S, T, heads * d)."""
    slots, t, heads, d = q.shape
    kvh = k_ctx.shape[2]
    qg = q.reshape(slots, t, kvh, heads // kvh, d)
    scores = torch.einsum("btgrd,bkgd->bgrtk", qg, k_ctx) * d ** -0.5
    scores = scores.float().masked_fill(~visible[:, None, None],
                                        torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrtk,bkgd->btgrd", probs, v_ctx)
    return out.reshape(slots, t, heads * d)


def _gather(pool: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Each slot's pages in page-table order: (S, pages * page_size, kvh,
    d), so slot i's context is the prefix of its positions."""
    slots = page_table.shape[0]
    return pool[page_table].reshape(slots, -1, *pool.shape[2:])


def paged_attention_step(q, k_new, v_new, pool_k, pool_v,
                         state: PagedState) -> torch.Tensor:
    """One decode step of paged attention for every slot at once.

    ``q`` (S, 1, heads, d); ``k_new``/``v_new`` (S, 1, kv_heads, d), the
    current token's projections per slot (RoPE already applied for Llama).
    Writes each live slot's K/V at position ``lengths[i]`` into its page (in
    place), then attends slot ``i``'s query over its own gathered pages.
    Returns ``out`` (S, 1, heads * d); dead slots give finite garbage rows.
    """
    page_size = pool_k.shape[1]
    lengths = state.lengths
    page_id = state.page_table.gather(1, (lengths // page_size)[:, None])[:, 0]
    flat_idx = page_id * page_size + lengths % page_size
    _write_rows(pool_k, flat_idx, state.live, k_new[:, 0])
    _write_rows(pool_v, flat_idx, state.live, v_new[:, 0])

    k_ctx = _gather(pool_k, state.page_table)
    v_ctx = _gather(pool_v, state.page_table)
    # The query sits at position lengths[i] (just written): it sees
    # positions 0..lengths[i], the dense branches' rule.
    ctx = torch.arange(k_ctx.shape[1], device=q.device)
    visible = (ctx[None, :] <= lengths[:, None])[:, None, :]
    return _attend(q, k_ctx, v_ctx, visible)


def paged_attention_block(q, k_new, v_new, pool_k, pool_v,
                          state: PagedBlockState) -> torch.Tensor:
    """A block of ``T`` tokens of paged attention for every slot at once.

    ``q`` (S, T, heads, d); ``k_new``/``v_new`` (S, T, kv_heads, d): column
    ``t`` of slot ``i`` is the token at position ``lengths[i] + t``. Writes
    columns ``t < n_new[i]`` of live slots into their pages, then attends
    each query over its slot's pages with the causal rule ``position <=
    lengths[i] + t``. Equal, row for row, to ``T`` sequential
    :func:`paged_attention_step` calls: each (query, key) product is
    independent of the block width, and masked keys underflow to 0.0.
    Returns ``out`` (S, T, heads * d).
    """
    page_size = pool_k.shape[1]
    t_block = q.shape[1]
    cols = torch.arange(t_block, device=q.device)
    t_pos = state.lengths[:, None] + cols[None, :]                # (S, T)
    valid = (cols[None, :] < state.n_new[:, None]) & state.live[:, None]
    page_col = (t_pos // page_size).clamp(0, state.page_table.shape[1] - 1)
    page_id = state.page_table.gather(1, page_col)
    flat_idx = page_id * page_size + t_pos % page_size
    _write_rows(pool_k, flat_idx, valid, k_new)
    _write_rows(pool_v, flat_idx, valid, v_new)

    k_ctx = _gather(pool_k, state.page_table)
    v_ctx = _gather(pool_v, state.page_table)
    ctx = torch.arange(k_ctx.shape[1], device=q.device)
    visible = ctx[None, None, :] <= t_pos[:, :, None]             # (S, T, K)
    return _attend(q, k_ctx, v_ctx, visible)


def paged_attention(q, k_new, v_new, pool_k, pool_v, state):
    """The model branches' entry: the block path for a
    :class:`PagedBlockState`, the one-token step for a :class:`PagedState`.
    """
    if isinstance(state, PagedBlockState):
        return paged_attention_block(q, k_new, v_new, pool_k, pool_v, state)
    return paged_attention_step(q, k_new, v_new, pool_k, pool_v, state)


def check_paged_call(model, s: int, state, pools, cache) -> None:
    """The models' refusals of a paged forward: the pools are the engine's
    (a model never sizes pool memory), ``paged=`` replaces ``cache=``, it is
    a decode-mode construct (eval mode), and a plain :class:`PagedState`
    advances exactly one token a slot."""
    if pools is None:
        raise ValueError(
            "paged decode needs the page pools (pools=, built by the serve "
            "engine through kv_cache.init_pools); models never size pool "
            "memory themselves")
    if cache is not None:
        raise ValueError("paged= replaces the dense cache=; pass one of "
                         "them")
    if model.training:
        raise ValueError("paged_state is a decode-mode construct; call the "
                         "model in eval mode")
    if not isinstance(state, PagedBlockState) and s != 1:
        raise ValueError(
            f"paged decode advances exactly one token per slot per step "
            f"(got a block of {s}); prompts prefill through the dense "
            f"decode path and are packed into pages "
            f"(serve/kv_cache.pack_prefill_cache), or pass a "
            f"PagedBlockState for the block fast path")


def init_pools(model, *, num_pages: int, page_size: int) -> PagedPools:
    """Zeroed per-layer pools for ``model`` in its compute dtype, on its
    device: ``(num_pages, page_size, kv_heads, head_dim)`` per layer and per
    K/V, the shapes read from the model's config (JAX discovers them by
    ``eval_shape`` of a dense decode). Raises for a model without a decode
    mode."""
    cfg = getattr(model, "cfg", None)
    if not hasattr(model, "init_cache") or cfg is None:
        raise ValueError(
            f"{type(model).__name__} has no dense K/V decode cache — paged "
            f"serving needs the GPT/Llama decode mode")
    kvh = getattr(cfg, "num_kv_heads", cfg.num_heads)
    shape = (int(num_pages), int(page_size), kvh, cfg.head_dim)
    device = next(model.parameters()).device

    def pools():
        return [torch.zeros(shape, dtype=model.compute_dtype, device=device)
                for _ in range(cfg.num_layers)]
    return PagedPools(keys=pools(), values=pools())


def pack_prefill_cache(dense_cache, pools: PagedPools, *,
                       page_row: torch.Tensor, plen: int) -> None:
    """Scatter one slot's dense prefill cache into its pages, in place.

    ``dense_cache`` is the :class:`~distributeddeeplearning_tpu_torch.
    models.decode_cache.KVCache` of a batch-1 dense decode prefill (prompt
    right-padded to a bucket length); ``page_row`` (max_pages_per_slot,) is
    the slot's page-table row; positions ``[0, plen)`` are written and the
    pad positions are dropped."""
    page_size = pools.page_size
    t = torch.arange(int(plen), device=page_row.device)
    flat_idx = page_row[t // page_size] * page_size + t % page_size
    for dense, pool in zip(dense_cache.keys + dense_cache.values,
                           pools.keys + pools.values):
        num_pages, _, kvh, d = pool.shape
        pool.view(num_pages * page_size, kvh, d)[flat_idx] = \
            dense[0, :int(plen)].to(pool.dtype)


def clone_page_rows(pools: PagedPools, src: int, dst: int) -> None:
    """Copy pool page ``src`` onto page ``dst`` in every pool, in place:
    the copy-on-write primitive. A page held at refcount > 1 (a radix node
    and/or another slot reads it) is never written in place; the engine
    clones it into a private page first."""
    for pool in pools.keys + pools.values:
        pool[dst] = pool[src]


class PageAllocator:
    """Host-side refcounted page allocator: admission takes, retirement
    returns, and a page may be shared by several holders (slots mapping a
    cached prefix, radix-tree nodes). A page returns to the free list only
    when its last claim drops. A claim released twice raises (the page
    would be handed out while still mapped, corrupting both sequences), and
    in-place writes to a shared page are refused by :meth:`assert_writable`
    (copy on write via :func:`clone_page_rows`)."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages={num_pages}: need >= 1")
        self.num_pages = int(num_pages)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self._ref: dict[int, int] = {}
        # Running totals for the engine's gauges: how often the pool was
        # asked, and how often it said no (an allocation stall that the
        # occupancy gauge cannot tell from healthy high use).
        self.alloc_calls = 0
        self.alloc_failures = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> Optional[list[int]]:
        """``n`` fresh page ids at refcount 1, or None (all or nothing)
        when the pool cannot cover them: admission's budget check."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        self.alloc_calls += 1
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def refcount(self, page) -> int:
        """Claims on ``page`` (0 = free)."""
        return self._ref.get(int(page), 0)

    def incref(self, pages) -> None:
        """One more claim per page: a new holder of an allocated page.
        Incref of a free page raises."""
        for p in pages:
            p = int(p)
            if p not in self._ref:
                raise ValueError(
                    f"incref of page {p}: it is not currently allocated — "
                    f"only a live page can gain a second holder")
            self._ref[p] += 1

    def _drop(self, p: int) -> None:
        self._ref[p] -= 1
        if self._ref[p] == 0:
            del self._ref[p]
            self._free.append(p)

    def decref(self, pages) -> None:
        """Drop one claim per page; the page is freed with its last claim.
        Decref of a free page raises."""
        for p in pages:
            p = int(p)
            if p not in self._ref:
                raise ValueError(
                    f"double-decref of page {p}: it is not currently "
                    f"allocated — a claim released twice would free a page "
                    f"another holder still maps")
            self._drop(p)

    def free(self, pages) -> None:
        """Strict single-claim release: ``decref``, but a second release of
        the same page reads as a double free."""
        for p in pages:
            p = int(p)
            if p not in self._ref:
                raise ValueError(
                    f"double-free of page {p}: it is not currently "
                    f"allocated — a page on two page tables would corrupt "
                    f"both slots' K/V")
            self._drop(p)

    def release(self, pages) -> int:
        """Idempotent release for victim retirement: drops one claim per
        page still allocated, skips free ones, and returns how many claims
        it dropped. Holders clear their page lists after releasing."""
        freed = 0
        for p in pages:
            p = int(p)
            if p in self._ref:
                self._drop(p)
                freed += 1
        return freed

    def assert_writable(self, pages) -> None:
        """Raise unless every page is held exclusively (refcount 1): a write
        to a shared page would corrupt the cached prefix under every other
        holder."""
        shared = sorted(p for p in (int(p) for p in pages)
                        if self._ref.get(p, 0) > 1)
        if shared:
            raise RuntimeError(
                f"write to shared page(s) {shared} (refcount > 1): "
                f"in-place writes are only legal at refcount 1 — "
                f"copy-on-write the page first (kv_cache.clone_page_rows)")

    def check_leaks(self, owned_pages) -> None:
        """Raise unless the refcounts balance the live holders' claims
        exactly: ``owned_pages`` is a multiset (each slot's page-table row,
        one entry per radix node), each page's multiplicity must equal its
        refcount, and free + held == num_pages."""
        counts: dict[int, int] = {}
        for p in owned_pages:
            p = int(p)
            counts[p] = counts.get(p, 0) + 1
        over = sorted(p for p, c in counts.items()
                      if c > self._ref.get(p, 0) and p in self._ref)
        if over:
            raise RuntimeError(
                f"page-table corruption: page(s) {over} appear on more "
                f"live tables than their refcount allows — an unshared "
                f"page on two slots' tables corrupts both")
        phantom = sorted(p for p in counts if p not in self._ref)
        leaked = sorted(p for p, c in self._ref.items()
                        if counts.get(p, 0) < c)
        if leaked or phantom:
            raise RuntimeError(
                f"KV page leak: allocator refcounts {dict(self._ref)} vs "
                f"live claims {counts} "
                f"(leaked={leaked}, phantom={phantom})")
        if len(self._free) + len(self._ref) != self.num_pages:
            raise RuntimeError(
                f"allocator accounting broken: free={len(self._free)} + "
                f"held={len(self._ref)} != num_pages={self.num_pages}")


class _RadixNode:
    """One radix-tree node: owns one pool page holding a full
    ``page_size``-token chunk, keyed by that chunk's token ids."""

    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key, page, parent):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict = {}
        self.last_used = 0


class RadixPrefixCache:
    """Token-prefix -> KV-page radix tree over the shared page pool.

    Nodes are full pages only; a node holds one allocator claim on its
    page, so a retired slot's prefix pages survive in the tree and the next
    request with the same prompt head maps them instead of recomputing
    them. The partial trailing page of a fully cached prompt is never
    shared in place: the engine clones it.

    Eviction is LRU over leaves whose page has no holder besides the tree
    (refcount 1), children before parents, and never touches a page a live
    slot maps.
    """

    def __init__(self, allocator: PageAllocator, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size={page_size}: need >= 1")
        self.allocator = allocator
        self.page_size = int(page_size)
        self._root = _RadixNode(None, None, None)
        self._tick = 0
        self.evictions = 0

    def _chunks(self, tokens):
        ps = self.page_size
        for j in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    def match(self, tokens) -> tuple[int, list[int]]:
        """Longest cached full-page prefix of ``tokens``: ``(matched_tokens,
        pages)``, ``pages`` in position order. Touches every node on the
        path (LRU recency)."""
        self._tick += 1
        node = self._root
        pages: list[int] = []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = self._tick
            pages.append(child.page)
            node = child
        return len(pages) * self.page_size, pages

    def insert(self, tokens, pages) -> int:
        """Register the full pages of a prefilled sequence: ``pages[j]``
        holds positions ``[j*page_size, (j+1)*page_size)``. New nodes take
        one claim on their page; a chunk already cached is left as it is.
        Returns how many nodes were created."""
        self._tick += 1
        node = self._root
        created = 0
        for j, chunk in enumerate(self._chunks(tokens)):
            child = node.children.get(chunk)
            if child is None:
                page = int(pages[j])
                self.allocator.incref([page])
                child = _RadixNode(chunk, page, node)
                node.children[chunk] = child
                created += 1
            child.last_used = self._tick
            node = child
        return created

    def _evictable_leaves(self) -> list:
        out = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif self.allocator.refcount(n.page) == 1:
                out.append(n)
        return out

    def evict(self, need: int) -> int:
        """Free at least ``need`` pages by dropping LRU tree-only leaves,
        cascading into parents as they become leaves. Returns how many
        pages were freed (fewer when live slots pin the rest)."""
        freed = 0
        while freed < need:
            leaves = self._evictable_leaves()
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for n in leaves:
                if freed >= need:
                    break
                self.allocator.decref([n.page])
                del n.parent.children[n.key]
                self.evictions += 1
                freed += 1
        return freed

    def evictable_pages(self) -> int:
        """Pages the tree could free on demand: nodes whose whole subtree
        is tree-only (refcount 1)."""
        def count(node) -> tuple[int, bool]:
            total, all_free = 0, True
            for c in node.children.values():
                sub, ok = count(c)
                total += sub
                all_free &= ok
            if node is self._root:
                return total, all_free
            if all_free and self.allocator.refcount(node.page) == 1:
                return total + 1, True
            return total, False
        return count(self._root)[0]

    def owned_pages(self) -> list[int]:
        """One entry per node: the tree's part of the leak check's claim
        multiset."""
        out: list[int] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n.page)
            stack.extend(n.children.values())
        return out

    def num_nodes(self) -> int:
        return len(self.owned_pages())
