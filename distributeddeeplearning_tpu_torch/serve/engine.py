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
  decode forward keeps one shape;
- with **speculative decoding** (``spec_draft_model`` and ``spec_k``), a
  drafter over its own pools, in the same page-id space (one allocator,
  one page table), proposes up to ``spec_k`` tokens a slot by paged
  decode steps, and one target forward over the paged block branch
  verifies every slot's ``[fed token, proposals]`` block; the longest
  prefix matching the target's own greedy tokens is accepted, plus the
  target's next token.

Host state is numpy (page table, lengths, live mask, the fed tokens) and is
uploaded every step; device state is the model and the pools, written in
place.

Greedy (temperature 0) only: preemption re-queues a request with its
generated tokens folded into the prompt, and greedy decoding is what makes
that continuation exact. The tests hold the tokens to sequential
``generate(use_cache=True)`` and to the JAX engine, across preemption,
mid-stream retire and admit, and prefix-cache hits with copy on write.

Observability, as in the JAX engine: lifecycle events (``serve_admit``,
``serve_prefill``, ``serve_first_token``, ``serve_retire``,
``serve_preempt``, ``serve_shed``, ``serve_deadline_miss``,
``serve_cow_copy``, ``serve_shutdown``) go to the flight recorder, the
engine's gauges to ``observability/metrics.py`` every step. When telemetry
is enabled at construction, ``serve/tracing.py`` adds request-scoped span
trees and exact TTFT and latency attribution; when it is not, the engine
holds no tracer and every site pays one ``is not None`` check. The engine
reads its clock at the JAX engine's points, traced or not, so both give
the same times on the same fake clock.

Left for later slices of the port, as the JAX engine has them: serve
fault plans (``fault_plan``, refused: the operational layers,
``robustness/faults.py``) and the multi-replica supervisor
(``launch.run_serve``); ``serve_fingerprint`` and the AOT executable cache
(``compile_cache_dir`` is accepted and has no effect, so a JAX
``config.json`` loads), whose counterpart, CUDA graphs of the decode step,
comes with the compile-cache layer.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from distributeddeeplearning_tpu_torch import resolve_device
from distributeddeeplearning_tpu_torch.models.decode_cache import KVCache
from distributeddeeplearning_tpu_torch.models.generate import (
    _require_decode, decode_capacity)
from distributeddeeplearning_tpu_torch.observability import flight, metrics
from distributeddeeplearning_tpu_torch.serve import kv_cache
from distributeddeeplearning_tpu_torch.serve import tracing
from distributeddeeplearning_tpu_torch.serve.scheduler import (
    BrownoutController, SloScheduler)

FAULT_SLICE = ("serve fault plans (fault_plan) come with a later slice of "
               "the port: the operational layers, robustness/faults.py")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The JAX engine's config, field for field. ``compile_cache_dir`` has
    no effect here."""

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
    # Speculative decoding: a drafter proposes spec_k tokens a round, one
    # batched target verify accepts the longest greedy-matching prefix
    # (token-identical by construction). Both must be set together.
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

    @property
    def spec_enabled(self) -> bool:
        return self.spec_k > 0 and self.spec_draft_model is not None


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
    # tracing.RequestTrace when the engine was built with telemetry on;
    # None otherwise.
    trace: Any = None

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
    carried by ``utils/weights.py`` ``params_from_flax``. ``draft_model``
    and ``draft_state_dict``: the same for the speculative drafter; by
    default the registry's ``config.spec_draft_model`` built with
    ``config.seed`` when its name is the target's (equal weights) and
    ``config.seed + 1`` otherwise, the JAX engine's rule. ``device``:
    ``cuda`` unless ``"cpu"`` is asked for; given models move there.
    ``clock`` is injectable (tests drive a fake one). Telemetry must be
    configured before construction for the engine to trace.
    """

    def __init__(self, config: ServeConfig, *, model=None,
                 state_dict: Optional[dict] = None, draft_model=None,
                 draft_state_dict: Optional[dict] = None, device=None,
                 scheduler: Optional[SloScheduler] = None,
                 clock: Optional[Callable[[], float]] = None,
                 brownout: Optional[BrownoutController] = None,
                 fault_plan: Optional[str] = None):
        cfg = config
        if fault_plan:
            raise ValueError(FAULT_SLICE)
        if not cfg.prefill_buckets:
            raise ValueError("prefill_buckets must name at least one "
                             "padded prompt length")
        if (cfg.spec_k > 0) != (cfg.spec_draft_model is not None):
            raise ValueError(
                f"speculative decoding needs BOTH spec_draft_model and "
                f"spec_k > 0 (got draft={cfg.spec_draft_model!r}, "
                f"k={cfg.spec_k})")
        self.config = cfg
        self.device = resolve_device(device)
        self.scheduler = scheduler or SloScheduler()
        self.brownout = brownout
        self._clock = clock or time.monotonic
        # Resolved once: None is the disabled path, and no per-request
        # trace state is ever allocated then.
        self._tracer = tracing.maybe_tracer()
        self.model = self._build(cfg.model, cfg.seed, model, state_dict)

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

        # Speculative decoding: the drafter's own pools over the same
        # page ids, so shared prefix pages carry drafter K/V too.
        self.draft_model = None
        self.draft_pools = None
        if cfg.spec_enabled:
            dseed = (cfg.seed if cfg.spec_draft_model == cfg.model
                     else cfg.seed + 1)
            try:
                self.draft_model = self._build(cfg.spec_draft_model, dseed,
                                               draft_model, draft_state_dict)
            except KeyError as e:
                raise ValueError(
                    f"speculative decoding refused: drafter {e.args[0]}"
                ) from None
            dcap = decode_capacity(self.draft_model)
            if dcap is not None and cfg.slot_capacity > dcap:
                raise ValueError(
                    f"slot capacity {cfg.slot_capacity} exceeds the "
                    f"drafter's decode bound {dcap}")
            self.draft_pools = kv_cache.init_pools(
                self.draft_model, num_pages=cfg.num_pages,
                page_size=cfg.page_size)
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0

        s, p = cfg.max_slots, cfg.max_pages_per_slot
        # The drafter's cached length per slot: it may lag the target by
        # one token after a fully accepted round.
        self._d_len = np.zeros((s,), np.int64)
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

    def _build(self, name: str, seed: int, model, state_dict):
        """``model`` (or the registry's ``name`` built with ``seed``) with
        ``state_dict`` loaded, on the engine's device in eval mode."""
        if model is None:
            from distributeddeeplearning_tpu_torch.models import model_spec
            spec = model_spec(name)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = spec.build(vocab_size=self.config.vocab_size,
                                   dtype=_dtype(self.config.dtype))
        if state_dict is not None:
            model.load_state_dict(state_dict)
        return model.to(self.device).eval()

    # -- public surface ---------------------------------------------------

    def submit(self, prompt: Sequence[int], *, max_new_tokens: int,
               tenant: str = "default",
               arrival_s: Optional[float] = None,
               trace_id: Optional[int] = None,
               resumed: bool = False) -> Request:
        """Queue one request; admission happens on a later ``step()``.
        ``trace_id``/``resumed`` are tracing metadata (a caller's own id
        for the request's flow, and whether it continues a flow opened
        elsewhere); both are ignored when tracing is off."""
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
        if self._tracer is not None:
            self._tracer.on_submit(req, trace_id, resumed=resumed)
        return req

    @property
    def tracer(self):
        """The serve tracer (``serve/tracing.ServeTracer``), or None when
        telemetry was disabled at construction."""
        return self._tracer

    @property
    def num_live(self) -> int:
        return int(self._live.sum())

    @property
    def idle(self) -> bool:
        return not self.waiting and self.num_live == 0

    def step(self) -> list:
        """One engine step: shed under brownout pressure, schedule,
        cancel and expire deadline-blown work, preempt, admit (and
        prefill), advance every live slot (one token, or a speculative
        round), retire the finished. Returns the requests that finished
        during this step."""
        now = self._clock()
        finished_before = len(self.finished)
        tr = self._tracer
        if tr is not None:
            # Time since the previous step's end is queue time for
            # everything still waiting (before the shed pass, so a shed
            # request's attribution is complete when it is finalized).
            tr.on_step_start(self.waiting, now)
        if self.brownout is not None:
            for req in self.brownout.plan_shed(
                    now=now, waiting=list(self.waiting),
                    scheduler=self.scheduler,
                    free_pages=self._free_page_budget(),
                    num_pages=self.config.num_pages):
                self.waiting.remove(req)
                self._fail(req, "shed", now)
        t_plan0 = self._clock() if tr is not None else 0.0
        plan = self.scheduler.plan(
            now=now, waiting=list(self.waiting), live=self._slot_views(),
            free_slots=self.config.max_slots - self.num_live,
            free_pages=self._free_page_budget(),
            page_size=self.config.page_size,
            need_pages=(self._need_pages if self.prefix is not None
                        else None))
        if tr is not None:
            tr.on_plan(plan, t_plan0, self._clock(), step=self.steps,
                       waiting=len(self.waiting))
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
            if self.draft_model is not None:
                self._spec_decode_step()
            else:
                self._decode_step()
        if tr is not None:
            # This step's waiting time per request, classified by the
            # scheduler's reason (an allocator-race requeue overrides it).
            tr.on_step_end(self.waiting, plan, self._clock())
        self.steps += 1
        self._observe_gauges()
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
        """Run every forward this engine's features dispatch once without
        touching pool contents (dummy prefills pack no position, the dummy
        decode, drafter decode and verify have no live row, the dummy
        clone copies page 0 onto itself) and return each one's first-call
        seconds."""
        cfg = self.config
        zero_row = np.zeros((cfg.max_pages_per_slot,), np.int64)
        seconds = {}

        def timed(name, fn, *args, **kw):
            t0 = time.perf_counter()
            fn(*args, **kw)
            self._sync()
            seconds[name] = time.perf_counter() - t0

        for bucket in sorted(cfg.prefill_buckets):
            padded = np.zeros((1, bucket), np.int64)
            if self.prefix is not None:
                timed(f"prefill_{bucket}", self._run_block_prefill, padded,
                      n_suffix=0, prefix_len=0, page_row=zero_row)
            else:
                timed(f"prefill_{bucket}", self._run_prefill, padded,
                      plen=0, page_row=zero_row)
            if self.draft_model is not None:
                timed(f"draft_prefill_{bucket}", self._run_block_prefill,
                      padded, n_suffix=0, prefix_len=0, page_row=zero_row,
                      draft=True)
        if self.prefix is not None:
            timed("page_clone", self._clone_pages, 0, 0)
        if self.draft_model is not None:
            timed("draft_decode", self._run_draft_decode, self._feed,
                  self._d_len, self._live)
            timed("verify", self._run_verify,
                  np.zeros((cfg.max_slots, cfg.spec_k + 1), np.int64),
                  np.zeros((cfg.max_slots,), np.int64))
        else:
            timed("decode", self._run_decode)
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
        """The final gate: flight-record the lifetime counters, then raise
        RuntimeError unless page accounting balances (allocated == the
        live page tables + the tree's nodes)."""
        flight.get().record("serve_shutdown", steps=self.steps,
                            finished=len(self.finished),
                            failed=len(self.failed),
                            preemptions=self.preemptions,
                            sheds=self.sheds,
                            deadline_misses=self.deadline_misses,
                            prefix_hits=self.prefix_hits,
                            prefix_misses=self.prefix_misses,
                            prefix_tokens_reused=self.prefix_tokens_reused,
                            prefix_evictions=(self.prefix.evictions
                                              if self.prefix is not None
                                              else 0),
                            cow_copies=self.cow_copies,
                            spec_rounds=self.spec_rounds,
                            spec_proposed=self.spec_proposed,
                            spec_accepted=self.spec_accepted)
        self.check_integrity()

    # -- internals --------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _upload(self, array: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(array, device=self.device)

    def _observe_gauges(self) -> None:
        """The JAX engine's per-step gauges, under its series names."""
        reg = metrics.get()
        step = self.steps
        reg.observe("serve_live_slots", self.num_live, step=step)
        reg.observe("serve_page_occupancy",
                    self.allocator.pages_in_use / self.config.num_pages,
                    step=step)
        reg.observe("serve_queue_depth", len(self.waiting), step=step)
        reg.observe("serve_shed_total", self.sheds, step=step)
        reg.observe("serve_deadline_miss_total", self.deadline_misses,
                    step=step)
        reg.observe("serve_retry_total", self.retries, step=step)
        reg.observe("serve_alloc_failures", self.allocator.alloc_failures,
                    step=step)
        if self.prefix is not None:
            admits = self.prefix_hits + self.prefix_misses
            reg.observe("serve_prefix_hit_rate",
                        (self.prefix_hits / admits) if admits else 0.0,
                        step=step)
        if self.draft_model is not None:
            reg.observe("serve_spec_acceptance",
                        (self.spec_accepted / self.spec_proposed)
                        if self.spec_proposed else 0.0, step=step)

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
                           prefix_len: int, page_row: np.ndarray,
                           draft: bool = False) -> int:
        """Suffix prefill over the paged block branch: ``n_suffix`` tokens
        at base position ``prefix_len`` against a page row whose leading
        pages already hold the cached prefix; the drafter's, over its
        pools, with ``draft``."""
        model, pools = ((self.draft_model, self.draft_pools) if draft
                        else (self.model, self.pools))
        state = kv_cache.PagedBlockState(
            page_table=self._upload(page_row[None]),
            lengths=self._upload(np.array([prefix_len], np.int64)),
            live=self._upload(np.ones((1,), bool)),
            n_new=self._upload(np.array([n_suffix], np.int64)))
        logits = model(self._upload(padded), paged=state, pools=pools)
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

    @torch.inference_mode()
    def _run_draft_decode(self, feed: np.ndarray, lengths: np.ndarray,
                          active: np.ndarray) -> np.ndarray:
        """One drafter token for every slot at its drafter length, over
        the drafter's pools; rows outside ``active`` write nothing."""
        state = kv_cache.PagedState(self._upload(self._page_table),
                                    self._upload(lengths),
                                    self._upload(active))
        logits = self.draft_model(self._upload(feed), paged=state,
                                  pools=self.draft_pools)
        return logits[:, -1].argmax(dim=-1).cpu().numpy()

    @torch.inference_mode()
    def _run_verify(self, block: np.ndarray, n_new: np.ndarray) -> np.ndarray:
        """One target forward over every slot's ``[fed token, proposals]``
        block through the paged block branch: the target's greedy token at
        every block position. Rejected columns' writes land past the
        accepted length, where the next block overwrites them."""
        state = kv_cache.PagedBlockState(
            page_table=self._upload(self._page_table),
            lengths=self._upload(self._lengths),
            live=self._upload(self._live), n_new=self._upload(n_new))
        logits = self.model(self._upload(block), paged=state,
                            pools=self.pools)
        return logits.argmax(dim=-1).cpu().numpy()

    @torch.inference_mode()
    def _clone_pages(self, src: int, dst: int) -> None:
        kv_cache.clone_page_rows(self.pools, src, dst)
        if self.draft_model is not None:
            kv_cache.clone_page_rows(self.draft_pools, src, dst)

    def _run_page_copy(self, src: int, dst: int) -> None:
        """Copy on write: a shared page into a slot-private one, in the
        target's pools and the drafter's. Recorded before the copy."""
        flight.get().record("serve_cow_copy", src=int(src), dst=int(dst))
        self.cow_copies += 1
        self._clone_pages(src, dst)

    def _admit(self, req: Request) -> None:
        cfg = self.config
        tr = self._tracer
        t_adm0 = self._clock() if tr is not None else 0.0
        if tr is not None:
            # Time from step start to here served other requests.
            tr.on_admit_start(req, t_adm0)
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
            if tr is not None:
                tr.on_requeue(req, self._clock(), step=self.steps)
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
        flight.get().record("serve_admit", request=req.uid,
                            tenant=req.tenant, slot=slot, pages=need_total,
                            new_pages=need_new, prefix_tokens=prefix_len,
                            resumed=bool(req.tokens))
        if tr is not None:
            tr.on_alloc(req, t_adm0, self._clock(), step=self.steps,
                        slot=slot, new_pages=need_new,
                        shared_pages=len(shared), prefix_tokens=prefix_len,
                        prefix_cache=self.prefix is not None,
                        cow=cow_src is not None)
        if cow_src is not None:
            t_cow0 = self._clock() if tr is not None else 0.0
            self._run_page_copy(cow_src, pages[len(shared)])
            self.allocator.decref([cow_src])  # unpin the clone source
            if tr is not None:
                self._sync()  # the span ends when the copy has
                tr.on_cow_copy(req, t_cow0, self._clock(), step=self.steps,
                               src=cow_src, dst=pages[len(shared)])
        n_suffix = plen - prefix_len
        t_pf0 = self._clock() if tr is not None else 0.0
        if self.prefix is not None:
            self._assert_cow_writable(slot, prefix_len, n_suffix)
            bucket = self._bucket_for(n_suffix)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n_suffix] = ids[prefix_len:]
            tok = self._run_block_prefill(padded, n_suffix=n_suffix,
                                          prefix_len=prefix_len,
                                          page_row=page_row)
        else:
            bucket = self._bucket_for(plen)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :plen] = ids
            tok = self._run_prefill(padded, plen=plen, page_row=page_row)
        if self.draft_model is not None:
            # The drafter prefills the same suffix over its own pools
            # (shared prefix pages hold drafter K/V from their first
            # admission), so proposals start from a caught-up drafter.
            dpadded = np.zeros((1, self._bucket_for(n_suffix)), np.int64)
            dpadded[0, :n_suffix] = ids[prefix_len:]
            self._run_block_prefill(dpadded, n_suffix=n_suffix,
                                    prefix_len=prefix_len,
                                    page_row=page_row, draft=True)
            self._d_len[slot] = plen
        if self.prefix is not None:
            self.prefix.insert(ids, pages)
        now = self._clock()
        flight.get().record("serve_prefill", request=req.uid, slot=slot,
                            bucket=bucket, prompt_tokens=plen)
        first = req.ttft_s is None
        resumed = bool(req.tokens)  # read before emit appends
        req.emit(tok, now)
        if tr is not None:
            tr.on_prefill(req, t_pf0, now, step=self.steps, slot=slot,
                          bucket=bucket,
                          prefill_tokens=(n_suffix if self.prefix is not None
                                          else plen),
                          prefix_tokens=prefix_len, first=first,
                          resumed=resumed)
        if first:
            metrics.get().observe("serve_ttft_s", req.ttft_s,
                                  step=self.steps)
            flight.get().record("serve_first_token", request=req.uid,
                                slot=slot, ttft_s=round(req.ttft_s, 6))
        self._lengths[slot] = plen
        self._live[slot] = True
        self._feed[slot, 0] = tok
        if req.remaining == 0:
            self._retire(slot, now)

    def _decode_step(self) -> None:
        tr = self._tracer
        t_d0 = self._clock() if tr is not None else 0.0
        for i in np.flatnonzero(self._live):
            self._assert_cow_writable(int(i), int(self._lengths[i]), 1)
        toks = self._run_decode()
        now = self._clock()
        if tr is not None:
            # Decode accrues for every participant before the retire loop
            # below finalizes any of them.
            tr.on_decode(t_d0, now, step=self.steps,
                         slots=[(int(i), self._slots[i].request)
                                for i in np.flatnonzero(self._live)])
        for i in np.flatnonzero(self._live):
            req = self._slots[i].request
            req.emit(toks[i], now)
            self._lengths[i] += 1
            self._feed[i, 0] = toks[i]
            if req.remaining == 0:
                self._retire(int(i), now)

    def _spec_decode_step(self) -> None:
        """One speculative round for every live slot: the drafter proposes
        up to ``spec_k`` tokens (catching up its one-token lag first), one
        batched target forward verifies the whole ``[feed, proposals]``
        block, and the longest prefix of proposals matching the target's
        own greedy tokens is accepted, plus the target's next token after
        it, so even an all-rejected round advances one token as
        ``_decode_step`` does. Every emitted token is the target's argmax
        given the same cached context.

        Per slot, ``n <= remaining - 1`` (the round emits at most ``n + 1``
        tokens), and the drafter steps only while a slot still needs
        catch-up or proposals (the ``active`` mask), so its writes never
        run past the slot's page budget."""
        cfg = self.config
        tr = self._tracer
        t_d0 = self._clock() if tr is not None else 0.0
        live_idx = [int(i) for i in np.flatnonzero(self._live)]
        L = self._lengths.copy()
        d = self._d_len.copy()
        n_prop = np.zeros((cfg.max_slots,), np.int64)
        steps_needed = np.zeros((cfg.max_slots,), np.int64)
        proposals: list = [[] for _ in range(cfg.max_slots)]
        for i in live_idx:
            req = self._slots[i].request
            lag = int(L[i]) - int(d[i])
            n_prop[i] = min(cfg.spec_k, req.remaining - 1)
            steps_needed[i] = lag + int(n_prop[i])
            # The drafter writes [d, L + n) and the verify [L, L + n]:
            # all of it must be on pages held exclusively.
            self._assert_cow_writable(i, int(d[i]),
                                      int(L[i]) + int(n_prop[i]) + 1
                                      - int(d[i]))
        feed = np.zeros((cfg.max_slots, 1), np.int64)
        for r in range(int(steps_needed.max()) if live_idx else 0):
            active = np.zeros((cfg.max_slots,), bool)
            for i in live_idx:
                if r >= steps_needed[i]:
                    continue
                active[i] = True
                pos = int(d[i])
                if pos <= int(L[i]):
                    # Catch-up or first proposal: the token at this
                    # position is known (prompt + emitted).
                    req = self._slots[i].request
                    n = len(req.prompt)
                    feed[i, 0] = (req.prompt[pos] if pos < n
                                  else req.tokens[pos - n])
                else:
                    feed[i, 0] = proposals[i][pos - int(L[i]) - 1]
            toks = self._run_draft_decode(feed, d, active)
            for i in live_idx:
                if active[i]:
                    if int(d[i]) >= int(L[i]):
                        proposals[i].append(int(toks[i]))
                    d[i] += 1
        t_draft1 = self._clock() if tr is not None else 0.0
        block = np.zeros((cfg.max_slots, cfg.spec_k + 1), np.int64)
        n_new = np.zeros((cfg.max_slots,), np.int64)
        for i in live_idx:
            block[i, 0] = self._feed[i, 0]
            block[i, 1:1 + int(n_prop[i])] = proposals[i][:int(n_prop[i])]
            n_new[i] = int(n_prop[i]) + 1
        greedy = self._run_verify(block, n_new)
        now = self._clock()
        self.spec_rounds += 1
        round_proposed = round_accepted = 0
        if tr is not None:
            tr.on_decode(t_d0, now, step=self.steps,
                         slots=[(i, self._slots[i].request,
                                 {"spec": True, "proposed": int(n_prop[i])})
                                for i in live_idx])
        for i in live_idx:
            req = self._slots[i].request
            n = int(n_prop[i])
            m = 0
            while m < n and proposals[i][m] == int(greedy[i, m]):
                m += 1
            self.spec_proposed += n
            self.spec_accepted += m
            round_proposed += n
            round_accepted += m
            for j in range(m + 1):
                req.emit(int(greedy[i, j]), now)
            new_len = int(L[i]) + m + 1
            self._lengths[i] = new_len
            self._feed[i, 0] = int(greedy[i, m])
            # The drafter's cache is valid through the last position fed a
            # true token: at most one behind the target after a fully
            # accepted round.
            self._d_len[i] = min(int(d[i]), new_len)
            if req.remaining == 0:
                self._retire(i, now)
        if tr is not None:
            tr.on_spec_phases(
                t_d0, t_draft1, now, step=self.steps,
                rounds=int(steps_needed.max()) if live_idx else 0,
                proposed=round_proposed, accepted=round_accepted)

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
        self._d_len[slot] = 0
        self._feed[slot, 0] = 0
        self._page_table[slot] = 0
        return entry.request

    def _retire(self, slot: int, now: float) -> None:
        req = self._release_slot(slot)
        req.finished_s = now
        self.finished.append(req)
        flight.get().record("serve_retire", request=req.uid, slot=slot,
                            tokens=len(req.tokens),
                            preemptions=req.preemptions)
        if self._tracer is not None:
            self._tracer.finalize(req, now, status="ok")

    def _preempt(self, slot: int, now: float) -> None:
        req = self._release_slot(slot)
        req.preemptions += 1
        req._last_emit_s = None  # the gap back through the queue is not ITL
        self.preemptions += 1
        flight.get().record("serve_preempt", request=req.uid, slot=slot,
                            tenant=req.tenant, tokens_done=len(req.tokens))
        if self._tracer is not None:
            self._tracer.on_preempt(req, now, step=self.steps, slot=slot)
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
        req = self._release_slot(slot)
        if self._tracer is not None:
            self._tracer.on_cancel(req, now)
        self._fail(req, "deadline", now)

    def _fail(self, req: Request, reason: str, now: float) -> None:
        req.failed = reason
        req.finished_s = now
        self.failed.append(req)
        if reason == "deadline":
            self.deadline_misses += 1
            flight.get().record("serve_deadline_miss", request=req.uid,
                                tenant=req.tenant,
                                waited_s=round(now - req.arrival_s, 6),
                                tokens_done=len(req.tokens))
        else:
            self.sheds += 1
            flight.get().record("serve_shed", request=req.uid,
                                tenant=req.tenant, reason=reason,
                                tokens_done=len(req.tokens))
        if self._tracer is not None:
            self._tracer.on_fail(req, now, reason=reason)
