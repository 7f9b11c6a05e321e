"""Continuous-batching generation engine: prefill and decode over a paged KV
cache, slots admitted and retired every step.

Counterpart of ``distributeddeeplearning_tpu/serve/engine.py``.
``generate()`` (models/generate.py) runs one batch shape to completion: the
card idles whenever sequences finish early, and a long prompt stalls every
other request in the batch. This engine runs two kinds of forward instead:

- **prefill**, one request at a time: a batch-1 dense decode forward over
  the prompt right-padded to a bucket length, its K/V packed into the
  slot's pages (``kv_cache.pack_prefill_cache``), the first token the
  argmax at the prompt's last position. With the prefix cache on, the
  prompt's cached full pages are mapped from the radix tree and only the
  suffix runs, over the models' paged block branch;
- **decode**, one forward for every slot: each live slot advances exactly
  one token through the models' paged branch. Slots join and leave between
  steps by flipping rows of the page table, lengths and live mask, so the
  decode forward keeps one shape.

Host state is numpy (page table, lengths, live mask, the fed tokens) and is
uploaded every step; device state is the model and the pools, written in
place.

Greedy (temperature 0) only: preemption re-queues a request with its
generated tokens folded into the prompt, and greedy decoding is what makes
that continuation exact. The tests hold the tokens to sequential
``generate(use_cache=True)`` and to the JAX engine, across preemption,
mid-stream retire and admit, and prefix-cache hits with copy on write.

Left for later slices of the port, as the JAX engine has them:
speculative decoding (``spec_draft_model``/``spec_k``, refused here) and
beam search; serve fault plans (``fault_plan``, refused: the operational
layers, ``robustness/faults.py``); request tracing (``serve/tracing.py``,
with ``observability/telemetry``) and the metrics gauges and flight
events (the observability layers); ``serve_fingerprint`` and the AOT
executable cache (``compile_cache_dir`` is accepted and has no effect, so a
JAX ``config.json`` loads), whose counterpart, CUDA graphs of the decode
step, comes with the compile-cache layer; the multi-replica supervisor
(``launch.run_serve``).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import resolve_device
from distributeddeeplearning_tpu_torch.models.decode_cache import KVCache
from distributeddeeplearning_tpu_torch.models.generate import (
    _require_decode, decode_capacity)
from distributeddeeplearning_tpu_torch.serve import kv_cache
from distributeddeeplearning_tpu_torch.serve.scheduler import (
    BrownoutController, SloScheduler)

SPEC_SLICE = ("speculative decoding (spec_draft_model/spec_k) comes with a "
              "later slice of the port: the drafter decode and the batched "
              "verify, with the gpt_nano/llama_nano drafters")
FAULT_SLICE = ("serve fault plans (fault_plan) come with a later slice of "
               "the port: the operational layers, robustness/faults.py")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The JAX engine's config, field for field. ``compile_cache_dir`` has
    no effect here; the spec fields are refused by :class:`Engine`."""

    model: str = "gpt_tiny"
    vocab_size: int = 1024
    dtype: str = "float32"
    max_slots: int = 4                      # decode batch rows
    page_size: int = 16                     # tokens per KV page
    num_pages: int = 64                     # pool size, all slots share it
    max_pages_per_slot: int = 8             # page-table width
    prefill_buckets: tuple = (16, 32, 64)   # padded prompt lengths
    seed: int = 0
    # Radix-tree prefix reuse over the shared page pool: admission maps
    # cached full prompt pages into the slot's table and prefills only the
    # unmatched suffix.
    prefix_cache: bool = False
    spec_draft_model: Optional[str] = None
    spec_k: int = 0
    compile_cache_dir: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "ServeConfig":
        """From a JSON object (a JAX ``config.json``): lists become
        tuples."""
        d = dict(d)
        if "prefill_buckets" in d:
            d["prefill_buckets"] = tuple(int(b) for b in d["prefill_buckets"])
        return cls(**d)

    @property
    def slot_capacity(self) -> int:
        """Max prompt + generated tokens a single slot can ever hold."""
        return self.page_size * self.max_pages_per_slot


@dataclasses.dataclass
class Request:
    """One generation request and its accumulated lifecycle state."""

    uid: int
    tenant: str
    prompt: list
    max_new_tokens: int
    arrival_s: float
    tokens: list = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    itl_s: list = dataclasses.field(default_factory=list)
    finished_s: Optional[float] = None
    preemptions: int = 0
    retries: int = 0            # re-admissions after preemption
    not_before_s: float = 0.0   # retry backoff: ineligible before this
    failed: Optional[str] = None  # "deadline"/"shed"/"retries_exhausted"
    _last_emit_s: Optional[float] = None

    @property
    def total_tokens(self) -> int:
        """Full page budget: prompt + every token it may ever emit."""
        return len(self.prompt) + self.max_new_tokens

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.tokens)

    @property
    def prefill_ids(self) -> list:
        """What a (re-)admission prefills: the prompt plus everything
        already emitted."""
        return list(self.prompt) + list(self.tokens)

    def emit(self, token: int, now: float) -> None:
        if self.ttft_s is None:
            self.ttft_s = now - self.arrival_s
        elif self._last_emit_s is not None:
            self.itl_s.append(now - self._last_emit_s)
        self.tokens.append(int(token))
        self._last_emit_s = now


class _SlotView(NamedTuple):
    """What the scheduler sees of a live slot."""

    slot: int
    tenant: str
    num_pages: int
    admitted_seq: int
    arrival_s: float = 0.0


@dataclasses.dataclass
class _Slot:
    request: Request
    pages: list
    admitted_seq: int


def _dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"dtype {name!r} is not a torch dtype")
    return dtype


class Engine:
    """Continuous-batching engine over one model replica on one device.

    ``model``: a GPT or Llama module of the port (eval mode is set here);
    by default the registry's ``config.model`` built with ``config.seed``.
    ``state_dict``: weights loaded into it, e.g. JAX ``variables["params"]``
    carried by ``utils/weights.py`` ``params_from_flax``. ``device``:
    ``cuda`` unless ``"cpu"`` is asked for; a given model moves there.
    ``clock`` is injectable (tests drive a fake one).
    """

    def __init__(self, config: ServeConfig, *, model=None,
                 state_dict: Optional[dict] = None, device=None,
                 scheduler: Optional[SloScheduler] = None,
                 clock: Optional[Callable[[], float]] = None,
                 brownout: Optional[BrownoutController] = None,
                 fault_plan: Optional[str] = None):
        cfg = config
        if cfg.spec_k or cfg.spec_draft_model is not None:
            raise ValueError(SPEC_SLICE)
        if fault_plan:
            raise ValueError(FAULT_SLICE)
        if not cfg.prefill_buckets:
            raise ValueError("prefill_buckets must name at least one "
                             "padded prompt length")
        self.config = cfg
        self.device = resolve_device(device)
        self.scheduler = scheduler or SloScheduler()
        self.brownout = brownout
        self._clock = clock or time.monotonic
        if model is None:
            from distributeddeeplearning_tpu_torch.models import model_spec
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(cfg.seed)
                model = model_spec(cfg.model).build(
                    vocab_size=cfg.vocab_size, dtype=_dtype(cfg.dtype))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

        capacity = decode_capacity(self.model)
        if capacity is not None and cfg.slot_capacity > capacity:
            raise ValueError(
                f"slot capacity {cfg.slot_capacity} tokens (page_size x "
                f"max_pages_per_slot) exceeds the model's decode bound "
                f"{capacity} — positions past it cannot be generated")
        if max(cfg.prefill_buckets) > cfg.slot_capacity:
            raise ValueError(
                f"largest prefill bucket {max(cfg.prefill_buckets)} "
                f"exceeds slot capacity {cfg.slot_capacity}")

        self.pools = kv_cache.init_pools(self.model, num_pages=cfg.num_pages,
                                         page_size=cfg.page_size)
        self.allocator = kv_cache.PageAllocator(cfg.num_pages)
        # Radix prefix cache: tree nodes hold allocator claims on cached
        # full prompt pages, so a retired slot's prefix survives for the
        # next request with the same prompt head.
        self.prefix = (kv_cache.RadixPrefixCache(self.allocator,
                                                 cfg.page_size)
                       if cfg.prefix_cache else None)
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_reused = 0
        self.cow_copies = 0

        s, p = cfg.max_slots, cfg.max_pages_per_slot
        self._page_table = np.zeros((s, p), np.int64)
        self._lengths = np.zeros((s,), np.int64)
        self._live = np.zeros((s,), bool)
        self._feed = np.zeros((s, 1), np.int64)
        self._slots: list = [None] * s
        self.waiting: collections.deque = collections.deque()
        self.finished: list = []
        self.failed: list = []
        self._uid = 0
        self._admitted_seq = 0
        self.steps = 0
        self.preemptions = 0
        self.sheds = 0
        self.deadline_misses = 0
        self.retries = 0

    # -- public surface ---------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int,
               tenant: str = "default",
               arrival_s: Optional[float] = None) -> Request:
        """Queue one request; admission happens on a later ``step()``."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt: prefill needs >= 1 token")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}: a request "
                             f"that emits nothing never leaves its slot")
        total = len(prompt) + max_new_tokens
        _require_decode(self.model, total)
        if total > self.config.slot_capacity:
            raise ValueError(
                f"request needs {total} tokens (prompt {len(prompt)} + "
                f"max_new {max_new_tokens}) but a slot holds at most "
                f"{self.config.slot_capacity} (page_size "
                f"{self.config.page_size} x max_pages_per_slot "
                f"{self.config.max_pages_per_slot})")
        if len(prompt) > max(self.config.prefill_buckets):
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds the largest "
                f"prefill bucket {max(self.config.prefill_buckets)}")
        req = Request(uid=self._uid, tenant=tenant, prompt=prompt,
                      max_new_tokens=max_new_tokens,
                      arrival_s=(self._clock() if arrival_s is None
                                 else arrival_s))
        self._uid += 1
        self.waiting.append(req)
        return req

    @property
    def num_live(self) -> int:
        return int(self._live.sum())

    @property
    def idle(self) -> bool:
        return not self.waiting and self.num_live == 0

    def step(self) -> list:
        """One engine step: shed under brownout pressure, schedule,
        cancel and expire deadline-blown work, preempt, admit (and
        prefill), advance every live slot one token, retire the finished.
        Returns the requests that finished during this step."""
        now = self._clock()
        finished_before = len(self.finished)
        if self.brownout is not None:
            for req in self.brownout.plan_shed(
                    now=now, waiting=list(self.waiting),
                    scheduler=self.scheduler,
                    free_pages=self._free_page_budget(),
                    num_pages=self.config.num_pages):
                self.waiting.remove(req)
                self._fail(req, "shed", now)
        plan = self.scheduler.plan(
            now=now, waiting=list(self.waiting), live=self._slot_views(),
            free_slots=self.config.max_slots - self.num_live,
            free_pages=self._free_page_budget(),
            page_size=self.config.page_size,
            need_pages=(self._need_pages if self.prefix is not None
                        else None))
        for slot in plan.cancel:
            self._cancel(slot, now)
        for req in plan.expire:
            self.waiting.remove(req)
            self._fail(req, "deadline", now)
        for slot in plan.preempt:
            self._preempt(slot, now)
        for req in plan.admit:
            self.waiting.remove(req)
            self._admit(req)
        if self.num_live:
            self._decode_step()
        self.steps += 1
        return self.finished[finished_before:]

    def run_until_idle(self, *, max_steps: int = 10_000) -> list:
        """Drain queue and slots; returns all finished requests. The step
        bound turns a scheduling livelock into a loud failure."""
        for _ in range(max_steps):
            if self.idle:
                return self.finished
            self.step()
        raise RuntimeError(
            f"engine not idle after {max_steps} steps: "
            f"{len(self.waiting)} waiting, {self.num_live} live — "
            f"scheduling livelock or a request that cannot ever fit")

    def warmup(self) -> dict:
        """Run each prefill bucket and the decode forward once without
        touching pool contents (dummy prefills pack no position, the dummy
        decode has no live row, the dummy clone copies page 0 onto itself)
        and return each one's first-call seconds."""
        cfg = self.config
        zero_row = np.zeros((cfg.max_pages_per_slot,), np.int64)
        seconds = {}
        for bucket in sorted(cfg.prefill_buckets):
            t0 = time.perf_counter()
            padded = np.zeros((1, bucket), np.int64)
            if self.prefix is not None:
                self._run_block_prefill(padded, n_suffix=0, prefix_len=0,
                                        page_row=zero_row)
            else:
                self._run_prefill(padded, plen=0, page_row=zero_row)
            seconds[f"prefill_{bucket}"] = time.perf_counter() - t0
        if self.prefix is not None:
            t0 = time.perf_counter()
            kv_cache.clone_page_rows(self.pools, 0, 0)
            self._sync()
            seconds["page_clone"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._run_decode()
        seconds["decode"] = time.perf_counter() - t0
        return seconds

    def check_integrity(self) -> None:
        """Reconcile the three views of page ownership (slot page-table
        rows, slot page lists, allocator accounting) and raise on any
        divergence: a leaked page starves admission later; a corrupt row
        serves another slot's K/V now."""
        owned: list = []
        for i, entry in enumerate(self._slots):
            if entry is None:
                continue
            row = [int(p) for p in self._page_table[i, :len(entry.pages)]]
            pages = [int(p) for p in entry.pages]
            if row != pages:
                raise RuntimeError(
                    f"page-table corruption: slot {i} row {row} != owned "
                    f"pages {pages}")
            owned.extend(pages)
        if self.prefix is not None:
            # One claim per tree node, on top of the slots' claims.
            owned.extend(self.prefix.owned_pages())
        self.allocator.check_leaks(owned)

    def shutdown(self) -> None:
        """The final gate: raises RuntimeError unless page accounting
        balances (allocated == the live page tables + the tree's nodes)."""
        self.check_integrity()

    # -- internals --------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, device=self.device)

    def _slot_views(self) -> list:
        return [_SlotView(slot=i, tenant=s.request.tenant,
                          num_pages=len(s.pages),
                          admitted_seq=s.admitted_seq,
                          arrival_s=s.request.arrival_s)
                for i, s in enumerate(self._slots) if s is not None]

    def _bucket_for(self, plen: int) -> int:
        for b in sorted(self.config.prefill_buckets):
            if plen <= b:
                return b
        raise ValueError(
            f"prefill of {plen} tokens exceeds the largest bucket "
            f"{max(self.config.prefill_buckets)} — after preemption the "
            f"generated prefix re-prefills too; size buckets to "
            f"prompt + max_new_tokens")

    def _free_page_budget(self) -> int:
        """Pages admission may count on: the allocator's free list plus
        everything the prefix cache could evict on demand."""
        free = self.allocator.free_pages
        if self.prefix is not None:
            free += self.prefix.evictable_pages()
        return free

    def _need_pages(self, req: Request) -> int:
        """Scheduler callback under the prefix cache: charge only the new
        pages an admission would allocate (the clone of a partial trailing
        page counts as new)."""
        cfg = self.config
        matched, _ = self.prefix.match(req.prefill_ids)
        prefix_len = min(matched, len(req.prefill_ids) - 1)
        return (kv_cache.pages_needed(req.total_tokens, cfg.page_size)
                - prefix_len // cfg.page_size)

    def _assert_cow_writable(self, slot: int, start: int,
                             count: int) -> None:
        """Pages about to receive in-place writes for positions ``[start,
        start + count)`` of ``slot`` must be held exclusively."""
        if self.prefix is None or count <= 0:
            return
        ps = self.config.page_size
        row = self._page_table[slot]
        pages = {int(row[j]) for j in range(start // ps,
                                            (start + count - 1) // ps + 1)}
        self.allocator.assert_writable(pages)

    @torch.inference_mode()
    def _run_prefill(self, padded: np.ndarray, *, plen: int,
                     page_row: np.ndarray) -> int:
        """Batch-1 dense decode forward over the bucket-padded prompt, its
        positions [0, plen) packed into the slot's pages."""
        cfg = self.model.cfg
        bucket = padded.shape[1]
        cache = KVCache.zeros(
            cfg.num_layers,
            (1, bucket, getattr(cfg, "num_kv_heads", cfg.num_heads),
             cfg.head_dim),
            dtype=self.model.compute_dtype, device=self.device)
        logits = self.model(self._upload(padded), cache=cache)
        kv_cache.pack_prefill_cache(cache, self.pools,
                                    page_row=self._upload(page_row),
                                    plen=plen)
        return int(logits[0, max(plen - 1, 0)].argmax())

    @torch.inference_mode()
    def _run_block_prefill(self, padded: np.ndarray, *, n_suffix: int,
                           prefix_len: int, page_row: np.ndarray) -> int:
        """Suffix prefill over the paged block branch: ``n_suffix`` tokens
        at base position ``prefix_len`` against a page row whose leading
        pages already hold the cached prefix."""
        state = kv_cache.PagedBlockState(
            page_table=self._upload(page_row[None]),
            lengths=self._upload(np.array([prefix_len], np.int64)),
            live=self._upload(np.ones((1,), bool)),
            n_new=self._upload(np.array([n_suffix], np.int64)))
        logits = self.model(self._upload(padded), paged=state,
                            pools=self.pools)
        return int(logits[0, max(n_suffix - 1, 0)].argmax())

    @torch.inference_mode()
    def _run_decode(self) -> np.ndarray:
        """One paged decode forward over every slot: the greedy token of
        each row (dead rows' are garbage)."""
        state = kv_cache.PagedState(self._upload(self._page_table),
                                    self._upload(self._lengths),
                                    self._upload(self._live))
        logits = self.model(self._upload(self._feed), paged=state,
                            pools=self.pools)
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    def _run_page_copy(self, src: int, dst: int) -> None:
        """Copy on write: a shared page into a slot-private one."""
        self.cow_copies += 1
        kv_cache.clone_page_rows(self.pools, src, dst)

    def _admit(self, req: Request) -> None:
        cfg = self.config
        slot = next(i for i, s in enumerate(self._slots) if s is None)
        ids = req.prefill_ids
        plen = len(ids)

        # Radix walk: matched full pages map in shared; the partially
        # reused trailing page of a fully cached prompt is cloned (at least
        # one suffix token always re-runs so the prefill can emit). Matched
        # pages are pinned up front so the eviction below cannot free them.
        prefix_len = 0
        shared: list = []
        cow_src: Optional[int] = None
        if self.prefix is not None:
            matched, mpages = self.prefix.match(ids)
            prefix_len = min(matched, plen - 1)
            full = prefix_len // cfg.page_size
            shared = [int(p) for p in mpages[:full]]
            self.allocator.incref(shared)
            if prefix_len % cfg.page_size:
                cow_src = int(mpages[full])
                self.allocator.incref([cow_src])
        need_total = kv_cache.pages_needed(req.total_tokens, cfg.page_size)
        need_new = need_total - len(shared)
        new_pages = self.allocator.alloc(need_new)
        if new_pages is None and self.prefix is not None:
            # Short of free pages but the tree holds reclaimable ones:
            # evict LRU refcount-1 nodes and retry.
            self.prefix.evict(need_new - self.allocator.free_pages)
            new_pages = self.allocator.alloc(need_new)
        if new_pages is None:  # the scheduler raced itself: re-queue
            self.allocator.decref(shared)
            if cow_src is not None:
                self.allocator.decref([cow_src])
            self.waiting.appendleft(req)
            return
        pages = shared + new_pages
        self._admitted_seq += 1
        self._slots[slot] = _Slot(request=req, pages=pages,
                                  admitted_seq=self._admitted_seq)
        page_row = np.zeros((cfg.max_pages_per_slot,), np.int64)
        page_row[:need_total] = pages
        self._page_table[slot] = page_row

        if self.prefix is not None:
            if prefix_len > 0:
                self.prefix_hits += 1
                self.prefix_tokens_reused += prefix_len
            else:
                self.prefix_misses += 1
        if cow_src is not None:
            self._run_page_copy(cow_src, pages[len(shared)])
            self.allocator.decref([cow_src])  # unpin the clone source
        if self.prefix is not None:
            n_suffix = plen - prefix_len
            self._assert_cow_writable(slot, prefix_len, n_suffix)
            padded = np.zeros((1, self._bucket_for(n_suffix)), np.int64)
            padded[0, :n_suffix] = ids[prefix_len:]
            tok = self._run_block_prefill(padded, n_suffix=n_suffix,
                                          prefix_len=prefix_len,
                                          page_row=page_row)
            self.prefix.insert(ids, pages)
        else:
            padded = np.zeros((1, self._bucket_for(plen)), np.int64)
            padded[0, :plen] = ids
            tok = self._run_prefill(padded, plen=plen, page_row=page_row)
        now = self._clock()
        req.emit(tok, now)
        self._lengths[slot] = plen
        self._live[slot] = True
        self._feed[slot, 0] = tok
        if req.remaining == 0:
            self._retire(slot, now)

    def _decode_step(self) -> None:
        for i in np.flatnonzero(self._live):
            self._assert_cow_writable(int(i), int(self._lengths[i]), 1)
        toks = self._run_decode()
        now = self._clock()
        for i in np.flatnonzero(self._live):
            req = self._slots[i].request
            req.emit(toks[i], now)
            self._lengths[i] += 1
            self._feed[i, 0] = toks[i]
            if req.remaining == 0:
                self._retire(int(i), now)

    def _release_slot(self, slot: int) -> Request:
        """Return a slot's pages (``release`` + an emptied list, so a
        second cleanup of the same request is a no-op) and clear its
        row."""
        entry = self._slots[slot]
        self.allocator.release(entry.pages)
        entry.pages = []
        self._slots[slot] = None
        self._live[slot] = False
        self._lengths[slot] = 0
        self._feed[slot, 0] = 0
        self._page_table[slot] = 0
        return entry.request

    def _retire(self, slot: int, now: float) -> None:
        req = self._release_slot(slot)
        req.finished_s = now
        self.finished.append(req)

    def _preempt(self, slot: int, now: float) -> None:
        req = self._release_slot(slot)
        req.preemptions += 1
        req._last_emit_s = None  # the gap back through the queue is not ITL
        self.preemptions += 1
        # Bounded retry with exponential backoff: the scheduler owns the
        # policy, the engine applies it on every re-queue.
        req.retries += 1
        self.retries += 1
        max_r = self.scheduler.max_retries
        if max_r is not None and req.retries > max_r:
            self._fail(req, "retries_exhausted", now)
            return
        delay = self.scheduler.retry_delay_s(req.retries)
        if delay > 0:
            req.not_before_s = now + delay
        self.waiting.append(req)

    def _cancel(self, slot: int, now: float) -> None:
        """A live slot whose request blew its total-latency deadline."""
        self._fail(self._release_slot(slot), "deadline", now)

    def _fail(self, req: Request, reason: str, now: float) -> None:
        req.failed = reason
        req.finished_s = now
        self.failed.append(req)
        if reason == "deadline":
            self.deadline_misses += 1
        else:
            self.sheds += 1
