"""The port's SLO scheduler and brownout controller (distributeddeeplearning_
tpu_torch/serve/scheduler.py) against the JAX package's.

Both are pure host-side policy, so the same seeded queues, live tables,
policies and clocks go to each and the plans must be equal: the admit
order, the preempted slot, the expired and cancelled work and every
non-admission reason; likewise the shed lists, slacks and retry delays.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import pytest

from distributeddeeplearning_tpu.serve import scheduler as jsched
from distributeddeeplearning_tpu_torch.serve import scheduler as tsched

TENANTS = ("rt", "batch", "bg", "default")


@dataclasses.dataclass
class _Req:
    uid: int
    tenant: str
    arrival_s: float
    total_tokens: int
    not_before_s: float = 0.0
    ttft_s: Optional[float] = None


class _Live(NamedTuple):
    slot: int
    tenant: str
    num_pages: int
    admitted_seq: int
    arrival_s: float = 0.0


def _case(seed: int):
    """One seeded scheduling situation: policies, a wait queue, a live
    table, a clock and the free slots and pages."""
    rng = np.random.default_rng(seed)

    def maybe(value):
        return value if rng.random() < 0.4 else None

    policies = [dict(name=t, ttft_slo_s=float(rng.uniform(0.0, 2.0)),
                     max_pages=maybe(int(rng.integers(0, 12))),
                     ttft_deadline_s=maybe(float(rng.uniform(0.0, 3.0))),
                     total_deadline_s=maybe(float(rng.uniform(0.5, 5.0))))
                for t in TENANTS[:3] if rng.random() < 0.8]
    now = float(rng.uniform(0.0, 4.0))
    waiting = [_Req(uid=int(u), tenant=str(rng.choice(TENANTS)),
                    # Coarse arrivals, so slack and arrival ties happen.
                    arrival_s=float(rng.integers(0, 8)) / 2,
                    total_tokens=int(rng.integers(1, 40)),
                    not_before_s=float(rng.choice([0.0, now + 1.0,
                                                   now - 1.0])),
                    ttft_s=maybe(0.1))
               for u in rng.permutation(int(rng.integers(0, 9)))]
    live = [_Live(slot=i, tenant=str(rng.choice(TENANTS)),
                  num_pages=int(rng.integers(1, 8)),
                  admitted_seq=int(seq), arrival_s=float(rng.uniform(0, 4)))
            for i, seq in enumerate(rng.permutation(int(rng.integers(0, 5))))]
    return dict(policies=policies, now=now, waiting=waiting, live=live,
                free_slots=int(rng.integers(0, 4)),
                free_pages=int(rng.integers(0, 20)),
                page_size=int(rng.choice([2, 4])),
                max_retries=maybe(int(rng.integers(0, 3))),
                retry_backoff_s=float(rng.choice([0.0, 0.25])),
                need_offset=maybe(int(rng.integers(0, 3))))


def _plan(mod, case):
    sched = mod.SloScheduler(
        [mod.TenantPolicy(**p) for p in case["policies"]],
        max_retries=case["max_retries"],
        retry_backoff_s=case["retry_backoff_s"])
    need = None
    if case["need_offset"] is not None:
        # A prefix-cache engine's charge: fewer pages than the full need.
        def need(req):
            return max(0, mod.pages_needed(req.total_tokens,
                                           case["page_size"])
                       - case["need_offset"])
    plan = sched.plan(now=case["now"], waiting=case["waiting"],
                      live=case["live"], free_slots=case["free_slots"],
                      free_pages=case["free_pages"],
                      page_size=case["page_size"], need_pages=need)
    return {"admit": [r.uid for r in plan.admit], "preempt": plan.preempt,
            "expire": [r.uid for r in plan.expire], "cancel": plan.cancel,
            "reasons": plan.reasons, "empty": plan.empty,
            "slack": [sched.slack_s(r, case["now"])
                      for r in case["waiting"]],
            "delays": [sched.retry_delay_s(n) for n in range(5)]}


@pytest.mark.parametrize("block", range(4))
def test_plans_equal_jax(block):
    seen = set()
    for seed in range(block * 100, (block + 1) * 100):
        case = _case(seed)
        ref = _plan(jsched, case)
        assert _plan(tsched, case) == ref, f"seed {seed}"
        seen.update(k for k in ("admit", "preempt", "expire", "cancel")
                    if ref[k])
        seen.update(ref["reasons"].values())
    # The cases reach every branch of the policy.
    assert {"admit", "expire", "cancel", "backoff", "tenant_cap",
            "no_slot", "no_pages"} <= seen


def _shed(mod, case, ctrl_kw):
    sched = mod.SloScheduler([mod.TenantPolicy(**p)
                              for p in case["policies"]])
    ctrl = mod.BrownoutController(**ctrl_kw)
    shed = ctrl.plan_shed(now=case["now"], waiting=case["waiting"],
                          scheduler=sched, free_pages=case["free_pages"],
                          num_pages=20)
    return [r.uid for r in shed], ctrl.pressured(
        waiting_depth=len(case["waiting"]), free_pages=case["free_pages"],
        num_pages=20)


@pytest.mark.parametrize("ctrl_kw", [
    {}, {"queue_pressure": 3, "max_shed_per_step": 2},
    {"page_pressure": 0.5, "queue_pressure": 99, "shed_slack_s": 0.5},
    {"page_pressure": 1.0, "queue_pressure": 1, "max_shed_per_step": 5}])
def test_brownout_sheds_equal_jax(ctrl_kw):
    shed_any = False
    for seed in range(200):
        case = _case(seed)
        ref = _shed(jsched, case, ctrl_kw)
        assert _shed(tsched, case, ctrl_kw) == ref, f"seed {seed}"
        shed_any |= bool(ref[0])
    assert shed_any


@pytest.mark.parametrize("kw", [{"page_pressure": 0.0},
                                {"page_pressure": 1.5}])
def test_brownout_refuses_pressure_outside_unit_interval(kw):
    for mod in (jsched, tsched):
        with pytest.raises(ValueError, match="page_pressure"):
            mod.BrownoutController(**kw)
