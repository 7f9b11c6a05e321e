"""Per-request tracing and TTFT attribution for the serve engine.

Counterpart of ``distributeddeeplearning_tpu/serve/tracing.py``, over the
port's own telemetry and metrics (``observability/``): the same span
names, components, reasons and event arguments, so a port trace and a JAX
trace of the same run read alike. Every request carries a trace id from
arrival and emits a span tree through the serve path: queue wait,
scheduler decisions, page allocation and radix prefix hit or miss, copy on
write, prefill, every decode tick it takes part in, speculative draft and
verify, preempt / requeue / deadline events.

1. **Spans** land in the telemetry ring buffer (Chrome-trace JSON). Every
   emitted ``serve:*`` name is registered in :data:`REGISTERED_PHASES`,
   and the tests hold every emitted name to it.
2. **Attribution** splits each request's TTFT and total latency into the
   :data:`COMPONENTS` (``queue`` / ``admission_stall`` / ``prefill`` /
   ``interference`` / ``decode``) by moving a per-request mark through
   the engine's clock: every accounting point charges the elapsed
   interval to exactly one component, so the components sum to the
   measured latency by construction (float addition error only). Waiting
   time is classified by the scheduler's per-request reason for not
   admitting (``Plan.reasons``): resource starvation (``no_pages``, an
   allocator race) is an admission stall; policy holds (``no_slot``,
   ``tenant_cap``, ``backoff``, ``priority``: the engine is busy with
   other requests) are interference; everything else (gaps between
   steps) is queue time.

**The disabled path is a no-op.** The engine holds ``tracer = None`` when
telemetry is off at construction; every instrumentation site is behind one
``is not None`` check, no :class:`RequestTrace` is allocated, and a test
pins zero allocations in this module per decode tick.

Trace and flow ids are the request uid unless the caller passes another
(``Engine.submit(trace_id=...)``): the first admission opens the flow
(``ph: "s"``), a resumed one continues it (``"t"``), and retirement
closes it (``"f"``).
"""

from __future__ import annotations

from typing import Any, Optional

from distributeddeeplearning_tpu_torch.observability import (
    metrics, telemetry)

# ---------------------------------------------------------------------------
# Span-name registry — the schema every serve emission must come from.
# ---------------------------------------------------------------------------

#: Complete ("X") spans the serve stack emits.
SERVE_SPANS = (
    "serve:scheduler_plan",   # one per engine step: the Plan computation
    "serve:page_alloc",       # admission: radix walk + incref + alloc
    "serve:cow_copy",         # copy-on-write clone of a shared page
    "serve:prefill",          # dense or block prefill to first token
    "serve:decode",           # one engine decode dispatch (all slots)
    "serve:decode_tick",      # per-slot view of one decode/spec round
    "serve:spec_draft",       # drafter proposal rounds
    "serve:spec_verify",      # batched target verify forward
)

#: Instant ("i") markers.
SERVE_INSTANTS = (
    "serve:submit",           # request entered the wait queue
    "serve:prefix_match",     # radix cache hit/miss at admission
    "serve:preempt",          # victim evicted back to the queue
    "serve:requeue",          # admission raced the allocator; retried
    "serve:shed",             # brownout / retries_exhausted failure
    "serve:deadline_miss",    # hard deadline blown
    "serve:attribution",      # final per-request latency decomposition
    "serve:dispatch",         # supervisor: request dropped in an inbox
    "serve:redispatch",       # supervisor: victim re-sent to a survivor
    "serve:replica_lost",     # supervisor: a replica died mid-flight
)

#: Async ("b"/"e") request-lifetime track and the cross-process flow.
SERVE_TRACKS = (
    "serve:request",          # async span: arrival -> retire/fail
    "serve:request_flow",     # flow: links one request across processes
)

REGISTERED_PHASES = frozenset(SERVE_SPANS + SERVE_INSTANTS + SERVE_TRACKS)

#: Attribution components, exhaustive by construction: every accrued
#: interval lands in exactly one, and their sum equals the measured
#: latency. Order is the report order (arrival -> first token -> done).
COMPONENTS = ("queue", "admission_stall", "prefill", "interference",
              "decode")

#: Scheduler non-admission reasons that mean RESOURCE starvation (the
#: pool cannot cover the request) rather than policy/priority.
STALL_REASONS = frozenset({"no_pages", "alloc_race"})

#: Chrome tid base for per-slot decode-tick tracks: slot k renders on
#: tid PER_SLOT_TID + k, a stable lane per slot instead of the host
#: thread id (which would interleave every slot onto one row).
PER_SLOT_TID = 0x5150


def component_for_reason(reason: str) -> str:
    """Map a scheduler non-admission reason to the waiting component it
    charges: resource starvation -> ``admission_stall``; policy holds
    (slots busy with other requests, tenant cap, retry backoff,
    priority) -> ``interference``."""
    return "admission_stall" if reason in STALL_REASONS else "interference"


class RequestTrace:
    """Per-request attribution state: one trace id, one moving mark, one
    component accumulator. Allocated only when tracing is on."""

    __slots__ = ("trace_id", "comp", "ttft_comp", "last_mark_s",
                 "forced_reason", "resumed_origin", "opened", "done")

    def __init__(self, trace_id: int, arrival_s: float,
                 resumed_origin: bool = False):
        self.trace_id = int(trace_id)
        self.comp = {k: 0.0 for k in COMPONENTS}
        self.ttft_comp: Optional[dict] = None
        self.last_mark_s = float(arrival_s)
        self.forced_reason: Optional[str] = None  # alloc_race override
        # True when this engine-local request CONTINUES a flow another
        # process opened (supervisor re-dispatch after replica loss).
        self.resumed_origin = bool(resumed_origin)
        self.opened = False   # flow "s"/"t" emitted at first admission
        self.done = False

    def accrue(self, t_s: float, component: str) -> None:
        """Charge ``[last_mark, t_s]`` to ``component`` and advance the
        mark — the one mutation that keeps the decomposition exact."""
        dt = t_s - self.last_mark_s
        if dt > 0.0:
            self.comp[component] += dt
        self.last_mark_s = t_s


class ServeTracer:
    """The engine's tracing/attribution sidecar.

    Built by :func:`maybe_tracer` only when the telemetry singleton is
    enabled at engine construction; a ``None`` tracer IS the disabled
    path. All methods take explicit monotonic timestamps from the
    engine's injectable clock, so fake-clock tests get exact sums.
    """

    def __init__(self, tele: telemetry.Telemetry):
        self.tele = tele
        # Interval accumulators for the anomaly cadence
        # (queue-wait regression / allocation stall / decode stall).
        self._iv_finished = 0
        self._iv_queue_wait = 0.0
        self._iv_alloc_stall = 0.0
        self._iv_decode_sum = 0.0
        self._iv_decode_n = 0

    # -- request lifecycle -------------------------------------------------

    def on_submit(self, req, trace_id: Optional[int],
                  resumed: bool = False) -> None:
        rt = RequestTrace(req.uid if trace_id is None else trace_id,
                          req.arrival_s, resumed_origin=resumed)
        req.trace = rt
        self.tele.instant("serve:submit", request=req.uid,
                          trace=rt.trace_id, tenant=req.tenant)
        self.tele.async_begin("serve:request", rt.trace_id,
                              ts_s=req.arrival_s, request=req.uid,
                              tenant=req.tenant)

    def on_step_start(self, waiting, now: float) -> None:
        """Inter-step gaps (host scheduling, idle sleeps before this
        step) are queue time for everything still waiting."""
        for req in waiting:
            rt = req.trace
            if rt is not None:
                rt.accrue(now, "queue")

    def on_plan(self, plan, t0: float, t1: float, *, step: int,
                waiting: int) -> None:
        self.tele.record_span(
            "serve:scheduler_plan", t0, t1, step=step, waiting=waiting,
            admit=len(plan.admit), preempt=len(plan.preempt),
            expire=len(plan.expire), cancel=len(plan.cancel),
            reasons={str(u): r for u, r in sorted(plan.reasons.items())})

    def on_step_end(self, waiting, plan, t_end: float) -> None:
        """Classify this step's waiting time per request from the
        scheduler's non-admission reason (an allocator-race requeue
        overrides with ``alloc_race``)."""
        for req in waiting:
            rt = req.trace
            if rt is None:
                continue
            reason = rt.forced_reason or plan.reasons.get(req.uid,
                                                          "priority")
            rt.forced_reason = None
            rt.accrue(t_end, component_for_reason(reason))

    # -- admission ---------------------------------------------------------

    def on_admit_start(self, req, t: float) -> None:
        """Time from step start to this admission (earlier admissions'
        prefills, preempt/expire handling) served OTHER requests."""
        req.trace.accrue(t, "interference")

    def on_requeue(self, req, t: float, *, step: int) -> None:
        rt = req.trace
        rt.accrue(t, "admission_stall")
        rt.forced_reason = "alloc_race"
        self.tele.instant("serve:requeue", step=step, request=req.uid,
                          trace=rt.trace_id, reason="alloc_race")

    def on_alloc(self, req, t0: float, t1: float, *, step: int, slot: int,
                 new_pages: int, shared_pages: int, prefix_tokens: int,
                 prefix_cache: bool, cow: bool) -> None:
        rt = req.trace
        self.tele.record_span(
            "serve:page_alloc", t0, t1, step=step, request=req.uid,
            trace=rt.trace_id, slot=slot, new_pages=new_pages,
            shared_pages=shared_pages, cow=cow)
        if prefix_cache:
            self.tele.instant(
                "serve:prefix_match", step=step, request=req.uid,
                trace=rt.trace_id, hit=prefix_tokens > 0,
                prefix_tokens=prefix_tokens, shared_pages=shared_pages)

    def on_cow_copy(self, req, t0: float, t1: float, *, step: int,
                    src: int, dst: int) -> None:
        self.tele.record_span("serve:cow_copy", t0, t1, step=step,
                              request=req.uid, trace=req.trace.trace_id,
                              src=src, dst=dst)

    def on_prefill(self, req, t0: float, t1: float, *, step: int,
                   slot: int, bucket: int, prefill_tokens: int,
                   prefix_tokens: int, first: bool,
                   resumed: bool) -> None:
        """Everything from admission entry to the first emitted token —
        allocation, COW, the prefill program(s) — is the request's own
        service time: charge it to ``prefill`` and, on a first token,
        freeze the TTFT attribution snapshot."""
        rt = req.trace
        rt.accrue(t1, "prefill")
        self.tele.record_span(
            "serve:prefill", t0, t1, step=step, request=req.uid,
            trace=rt.trace_id, slot=slot, bucket=bucket,
            prefill_tokens=prefill_tokens, prefix_tokens=prefix_tokens,
            resumed=resumed)
        if first:
            rt.ttft_comp = dict(rt.comp)
        if not rt.opened:
            rt.opened = True
            # Flow binding: the event must land INSIDE a slice on the
            # same pid/tid, so stamp it mid-prefill-span. A fresh
            # admission opens the flow; a resumed one (preemption, or a
            # re-dispatch after replica loss where this is a different
            # process — ``resumed_origin``) continues it under the same
            # id.
            cont = resumed or rt.resumed_origin
            self.tele.flow("serve:request_flow", rt.trace_id,
                           "t" if cont else "s",
                           ts_s=(t0 + t1) / 2.0, request=req.uid,
                           resumed=cont)

    # -- decode ------------------------------------------------------------

    def on_decode(self, t0: float, t1: float, *, step: int,
                  slots) -> None:
        """One engine decode dispatch: a step-level span plus a per-slot
        tick span on a stable per-slot lane, and a ``decode`` accrual
        for every participant. ``slots``: (slot, request[, args]) rows."""
        self.tele.record_span("serve:decode", t0, t1, step=step,
                              live=len(slots))
        self._iv_decode_sum += max(t1 - t0, 0.0)
        self._iv_decode_n += 1
        for row in slots:
            slot, req = row[0], row[1]
            extra = row[2] if len(row) > 2 else {}
            rt = req.trace
            self.tele.record_span(
                "serve:decode_tick", t0, t1, step=step, request=req.uid,
                trace=rt.trace_id, slot=slot,
                tid=PER_SLOT_TID + slot, **extra)
            rt.accrue(t1, "decode")

    def on_spec_phases(self, t_draft0: float, t_draft1: float,
                       t_verify1: float, *, step: int, rounds: int,
                       proposed: int, accepted: int) -> None:
        self.tele.record_span("serve:spec_draft", t_draft0, t_draft1,
                              step=step, rounds=rounds, proposed=proposed)
        self.tele.record_span("serve:spec_verify", t_draft1, t_verify1,
                              step=step, proposed=proposed,
                              accepted=accepted)

    # -- exits -------------------------------------------------------------

    def on_preempt(self, req, t: float, *, step: int, slot: int) -> None:
        rt = req.trace
        rt.accrue(t, "decode")  # in-slot time since its last tick
        self.tele.instant("serve:preempt", step=step, request=req.uid,
                          trace=rt.trace_id, slot=slot,
                          tokens_done=len(req.tokens),
                          retries=req.retries)

    def on_cancel(self, req, t: float) -> None:
        req.trace.accrue(t, "decode")

    def on_fail(self, req, t: float, *, reason: str) -> None:
        """A failed request: the matching instant, then the same
        finalize path a retirement takes (attribution still holds — the
        components account for where its latency went before it died)."""
        rt = req.trace
        if rt is None or rt.done:
            return
        name = ("serve:deadline_miss" if reason == "deadline"
                else "serve:shed")
        self.tele.instant(name, request=req.uid, trace=rt.trace_id,
                          tenant=req.tenant, reason=reason,
                          tokens_done=len(req.tokens))
        self.finalize(req, t, status=reason)

    def finalize(self, req, t: float, *, status: str) -> None:
        """Close the request's track: residue to ``queue``, emit the
        attribution instant + flow close + async end, feed the metric
        series and the anomaly interval accumulators. Idempotent."""
        rt = req.trace
        if rt is None or rt.done:
            return
        rt.done = True
        rt.accrue(t, "queue")
        total = t - req.arrival_s
        comp = {k: round(v, 9) for k, v in rt.comp.items()}
        args: dict[str, Any] = {
            "request": req.uid, "trace": rt.trace_id,
            "tenant": req.tenant, "status": status,
            "total_s": round(total, 9), "components": comp,
            "sum_err_s": round(total - sum(rt.comp.values()), 9),
        }
        if req.ttft_s is not None and rt.ttft_comp is not None:
            args["ttft_s"] = round(req.ttft_s, 9)
            args["ttft_components"] = {k: round(v, 9)
                                       for k, v in rt.ttft_comp.items()}
            args["ttft_sum_err_s"] = round(
                req.ttft_s - sum(rt.ttft_comp.values()), 9)
        self.tele.instant("serve:attribution", **args)
        if rt.opened:
            self.tele.flow("serve:request_flow", rt.trace_id, "f",
                           ts_s=t, request=req.uid, status=status)
        self.tele.async_end("serve:request", rt.trace_id, ts_s=t,
                            status=status)
        reg = metrics.get()
        reg.observe("serve_total_latency_s", total)
        if rt.ttft_comp is not None:
            for k, v in rt.ttft_comp.items():
                reg.observe(f"serve_ttft_{k}_s", v)
            self._iv_queue_wait += (rt.ttft_comp["queue"]
                                    + rt.ttft_comp["interference"])
            self._iv_alloc_stall += rt.ttft_comp["admission_stall"]
        self._iv_finished += 1

    # -- anomaly cadence ---------------------------------------------------

    def interval_signals(self, *, reset: bool = True) -> dict:
        """Mean attribution signals since the last call, for
        ``AnomalyDetector.update_serve``: queue wait (queue +
        interference) and admission stall per completion, mean decode
        dispatch duration per step."""
        n = max(self._iv_finished, 1)
        out = {
            "queue_wait_s": (self._iv_queue_wait / n
                             if self._iv_finished else None),
            "alloc_stall_s": (self._iv_alloc_stall / n
                              if self._iv_finished else None),
            "decode_tick_s": (self._iv_decode_sum / self._iv_decode_n
                              if self._iv_decode_n else None),
            "finished": self._iv_finished,
        }
        if reset:
            self._iv_finished = 0
            self._iv_queue_wait = self._iv_alloc_stall = 0.0
            self._iv_decode_sum = 0.0
            self._iv_decode_n = 0
        return out


def maybe_tracer(tele: Optional[telemetry.Telemetry] = None
                 ) -> Optional[ServeTracer]:
    """A :class:`ServeTracer` over the (given or active) telemetry
    registry when it is enabled, else None — the engine's whole
    disabled-tracing story is this None."""
    tele = telemetry.get() if tele is None else tele
    return ServeTracer(tele) if tele.enabled else None
