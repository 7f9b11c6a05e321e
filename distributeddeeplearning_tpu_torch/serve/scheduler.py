"""Per-tenant SLO-aware admission / preemption for the serve engine.

Counterpart of ``distributeddeeplearning_tpu/serve/scheduler.py``, a copy
of its policy with the same ordering, tie-breaks and caps. Pure host-side
policy, fully deterministic, no tensors: the engine hands it
the wait queue and the live-slot table each step, and it returns a
:class:`Plan` — who to admit (in order) and at most one slot to preempt.
Keeping it pure makes every policy decision unit-testable without a model.

Policy, in the order it is applied:

1. **Priority = deadline slack.** Each waiting request's slack is
   ``(arrival + tenant.ttft_slo_s) - now``; the queue is served most
   negative (most overdue) first, ties broken by arrival then uid — FIFO
   within a tenant class.
2. **Admission by free-page budget.** A request needs
   ``pages_needed(prompt + max_new_tokens)`` pages and one free slot,
   allocate-all-or-nothing — a slot that could run out of pages mid-decode
   would corrupt its own tail, so the full budget is reserved up front.
   A tenant with ``max_pages`` set is also capped across its live slots:
   over-budget tenants simply stop admitting.
3. **Preemption (at most one per plan).** When the most urgent
   *within-budget* request is starved — of a slot or of pages — the most
   recently admitted live slot of an OVER-budget tenant is preempted:
   its slot and pages return, and its request re-queues with everything
   generated so far folded into the prompt (greedy decoding makes the
   continuation deterministic, so no work is lost — tests pin
   token-identity across preemption). One per step bounds thrash; the
   next step re-evaluates.
4. **Deadlines (opt-in).** A tenant may carry hard budgets on top of the
   soft TTFT SLO: ``ttft_deadline_s`` (a waiting request that has not
   produced its first token by then is expired rather than served
   uselessly late) and ``total_deadline_s`` (a request — waiting or live —
   past its total-latency budget is expired/cancelled, returning its slot
   and pages). Both default to None: no enforcement.
5. **Bounded retry with backoff.** A re-queued victim (preemption, replica
   loss) is re-admitted at most ``max_retries`` times; each re-admission
   waits ``retry_backoff_s * 2**(retries-1)`` before becoming eligible
   (``Request.not_before_s``), so a thrashing tenant cannot hot-loop the
   admission path. Defaults: 0 backoff, unbounded retries (an
   immediate re-queue).

The brownout controller (:class:`BrownoutController`) rides on the same
slack computation: under page-pool or queue pressure it sheds the waiting
requests that are already past their deadline-slack floor — work that is
doomed anyway — instead of letting it collapse p99 for every tenant.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from distributeddeeplearning_tpu_torch.serve.kv_cache import pages_needed


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """What the engine owes a tenant (TTFT SLO) and what the tenant may
    hold (page cap across its live slots; None = uncapped). The deadlines
    are hard budgets, distinct from the soft SLO: past ``ttft_deadline_s``
    a still-waiting request is expired; past ``total_deadline_s`` a request
    is expired/cancelled wherever it is. None (default) = unenforced."""

    name: str
    ttft_slo_s: float = 1.0
    max_pages: Optional[int] = None
    ttft_deadline_s: Optional[float] = None
    total_deadline_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Plan:
    """One step's scheduling decision: requests to admit, in priority
    order, at most one live slot id to preempt first, waiting requests to
    expire (deadline missed before first token), and live slot ids to
    cancel (total-latency budget blown mid-decode).

    ``reasons`` maps uid -> why an eligible waiting request was NOT
    admitted this step (``backoff`` / ``tenant_cap`` / ``no_slot`` /
    ``no_pages``); requests held only by admission order carry
    ``priority``. The tracing layer classifies waiting time from it:
    resource starvation (``no_pages``) is an admission stall, policy
    holds are scheduler interference."""

    admit: tuple
    preempt: tuple
    expire: tuple = ()
    cancel: tuple = ()
    reasons: dict = dataclasses.field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return (not self.admit and not self.preempt and not self.expire
                and not self.cancel)


class SloScheduler:
    """Deadline-slack scheduler over the engine's wait queue.

    ``policies`` maps tenant name -> :class:`TenantPolicy`; unknown
    tenants get ``default_policy``. ``max_retries``/``retry_backoff_s``
    bound re-admission of preempted/re-queued victims: the engine consults
    them when it re-queues a request.
    """

    def __init__(self, policies: Optional[Sequence[TenantPolicy]] = None,
                 default_policy: Optional[TenantPolicy] = None,
                 *, max_retries: Optional[int] = None,
                 retry_backoff_s: float = 0.0):
        self.default_policy = default_policy or TenantPolicy("default")
        self.policies = {p.name: p for p in (policies or ())}
        self.max_retries = max_retries
        self.retry_backoff_s = float(retry_backoff_s)

    def retry_delay_s(self, retries: int) -> float:
        """Exponential backoff before re-admission eligibility: the Nth
        retry waits ``retry_backoff_s * 2**(N-1)`` seconds. 0 when backoff
        is unconfigured — an immediate re-queue."""
        if self.retry_backoff_s <= 0 or retries <= 0:
            return 0.0
        return self.retry_backoff_s * (2.0 ** (retries - 1))

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default_policy)

    def slack_s(self, request, now: float) -> float:
        """Seconds until (negative: since) the tenant's TTFT deadline."""
        return (request.arrival_s + self.policy(request.tenant).ttft_slo_s
                - now)

    def plan(self, *, now: float, waiting: Sequence, live: Sequence,
             free_slots: int, free_pages: int, page_size: int,
             need_pages=None) -> Plan:
        """``waiting``: requests (``tenant``/``arrival_s``/``uid`` plus
        ``total_tokens`` = prompt+emitted+remaining). ``live``: slot views
        with ``slot``/``tenant``/``num_pages``/``admitted_seq``.

        ``need_pages``: optional callable ``req -> int`` overriding the
        page charge for a waiting request. The prefix-cache engine passes
        one that charges only the NEW pages an admission would allocate —
        radix-matched full pages are mapped shared (refcount++), not
        drawn from the free list. ``free_pages`` from that engine is the
        allocator free list plus on-demand-evictable tree pages, so the
        all-or-nothing budget check keeps its meaning. Preemption
        accounting is deliberately conservative: a victim's ``num_pages``
        counts every page it maps, but releasing a shared page only
        drops a refcount — the freed total may be smaller, and the next
        step's re-plan corrects for it."""
        tenant_pages: dict[str, int] = {}
        for s in live:
            tenant_pages[s.tenant] = (tenant_pages.get(s.tenant, 0)
                                      + s.num_pages)

        # Deadline enforcement first: expired work must not consume a slot.
        expire: list = []
        cancel: list = []
        pending: list = []
        for req in waiting:
            pol = self.policy(req.tenant)
            age = now - req.arrival_s
            if (pol.total_deadline_s is not None
                    and age > pol.total_deadline_s):
                expire.append(req)
            elif (pol.ttft_deadline_s is not None
                    and age > pol.ttft_deadline_s
                    and getattr(req, "ttft_s", None) is None):
                # Past the first-token budget with no token out (a resumed
                # victim that already streamed keeps its original TTFT).
                expire.append(req)
            else:
                pending.append(req)
        survivors: list = []
        for s in live:
            pol = self.policy(s.tenant)
            arrival = getattr(s, "arrival_s", None)
            if (pol.total_deadline_s is not None and arrival is not None
                    and now - arrival > pol.total_deadline_s):
                cancel.append(s.slot)
                tenant_pages[s.tenant] -= s.num_pages
                free_slots += 1
                free_pages += s.num_pages
            else:
                survivors.append(s)
        live = survivors

        order = sorted(pending,
                       key=lambda r: (self.slack_s(r, now), r.arrival_s,
                                      r.uid))
        admit: list = []
        preempt: list = []
        reasons: dict = {}
        preempted_tenants: set[str] = set()
        for idx, req in enumerate(order):
            if getattr(req, "not_before_s", 0.0) > now:
                reasons[req.uid] = "backoff"
                continue  # backing off after a retry: holds its place
            pol = self.policy(req.tenant)
            need = (need_pages(req) if need_pages is not None
                    else pages_needed(req.total_tokens, page_size))
            if (pol.max_pages is not None
                    and tenant_pages.get(req.tenant, 0) + need
                    > pol.max_pages):
                reasons[req.uid] = "tenant_cap"
                continue  # over-budget tenant: holds its place, no slot
            if free_slots <= 0 or need > free_pages:
                starve = "no_slot" if free_slots <= 0 else "no_pages"
                if preempt:  # at most one eviction per plan
                    for r in order[idx:]:
                        reasons.setdefault(r.uid, starve)
                    break
                # Slot- and page-starvation evict alike: the victim's
                # slot AND pages both return.
                victim = self._victim(live, tenant_pages,
                                      exclude=preempted_tenants)
                if victim is not None and (free_pages + victim.num_pages
                                           >= need):
                    preempt.append(victim.slot)
                    preempted_tenants.add(victim.tenant)
                    tenant_pages[victim.tenant] -= victim.num_pages
                    free_pages += victim.num_pages
                    free_slots += 1
                else:
                    # Starved and nothing evictable: everything behind
                    # this request (itself included) waits for the same
                    # resource.
                    for r in order[idx:]:
                        reasons.setdefault(r.uid, starve)
                    break
            admit.append(req)
            free_slots -= 1
            free_pages -= need
            tenant_pages[req.tenant] = tenant_pages.get(req.tenant, 0) + need
        return Plan(admit=tuple(admit), preempt=tuple(preempt),
                    expire=tuple(expire), cancel=tuple(cancel),
                    reasons=reasons)

    def _victim(self, live: Sequence, tenant_pages: dict,
                exclude: set):
        """Most recently admitted slot of an over-budget tenant (newest
        first minimizes wasted decode work), or None when every tenant is
        within budget — within-budget work is never evicted."""
        candidates = []
        for s in live:
            pol = self.policy(s.tenant)
            if s.tenant in exclude or pol.max_pages is None:
                continue
            if tenant_pages.get(s.tenant, 0) > pol.max_pages:
                candidates.append(s)
        if not candidates:
            return None
        return max(candidates, key=lambda s: s.admitted_seq)


class BrownoutController:
    """Graceful degradation under overload: shed doomed work, save p99.

    When the page pool or the wait queue is pressured, requests whose
    deadline slack has fallen below ``shed_slack_s`` (i.e. already overdue
    by more than that margin) are shed — they were going to blow their SLO
    anyway, and serving them late steals decode steps and pages from every
    request that can still make its deadline. With no pressure, nothing is
    ever shed: a healthy engine behaves exactly as before.

    Pure host-side policy like the scheduler — deterministic and
    unit-testable without a model.
    """

    def __init__(self, *, page_pressure: float = 0.95,
                 queue_pressure: int = 8, shed_slack_s: float = 0.0,
                 max_shed_per_step: int = 2):
        if not 0.0 < page_pressure <= 1.0:
            raise ValueError(f"page_pressure={page_pressure}: need (0, 1]")
        self.page_pressure = float(page_pressure)
        self.queue_pressure = int(queue_pressure)
        self.shed_slack_s = float(shed_slack_s)
        self.max_shed_per_step = int(max_shed_per_step)

    def pressured(self, *, waiting_depth: int, free_pages: int,
                  num_pages: int) -> bool:
        occupancy = 1.0 - free_pages / max(1, num_pages)
        return (occupancy >= self.page_pressure
                or waiting_depth >= self.queue_pressure)

    def plan_shed(self, *, now: float, waiting: Sequence,
                  scheduler: SloScheduler, free_pages: int,
                  num_pages: int) -> list:
        """Waiting requests to shed this step, lowest slack (most overdue)
        first, at most ``max_shed_per_step`` — empty without pressure."""
        if not self.pressured(waiting_depth=len(waiting),
                              free_pages=free_pages, num_pages=num_pages):
            return []
        overdue = [r for r in waiting
                   if scheduler.slack_s(r, now) < -self.shed_slack_s]
        overdue.sort(key=lambda r: (scheduler.slack_s(r, now), r.uid))
        return overdue[:self.max_shed_per_step]
