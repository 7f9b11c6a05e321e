"""Per-request tracing and TTFT attribution of the port's engine
(serve/tracing.py over observability/telemetry.py), against the JAX
engine's (the scenarios of tests/test_serve_tracing.py).

Both engines are built with their own telemetry, metrics and flight
singletons enabled, run the same requests on the shared fake clock with
the same weights, and are held to:

- **attribution components**: every request's TTFT and total-latency
  components equal to JAX's to 1e-9 s, and summing to the measured TTFT
  and latency to 1e-9 s;
- **span names**: the multiset of emitted span names per request equal
  (and the engine-level spans' multiset equal), every ``serve:*`` name
  registered;
- **gauges**: the metrics registries' Prometheus text equal;
- **flight events**: the same events with the same fields, in order.

One traced pair queues four requests through two slots, then runs
deadlines, bounded retry and brownout; a second, with speculative decoding
and the prefix cache, runs a copy on write and a preemption. Around them,
port-only checks: the disabled tracer allocates nothing in the tracing
stack per decode tick (tracemalloc, as JAX's test), a resumed submit
continues its flow, the scheduler's reasons map to components, and
``--serve-trace-dir`` writes a merged trace whose attributions add up.
"""

import collections
import json
import tracemalloc

import pytest
import torch

from distributeddeeplearning_tpu.observability import flight as jflight
from distributeddeeplearning_tpu.observability import metrics as jmetrics
from distributeddeeplearning_tpu.observability import telemetry as jtele
from distributeddeeplearning_tpu.serve import tracing as jtracing
from distributeddeeplearning_tpu_torch.observability import flight
from distributeddeeplearning_tpu_torch.observability import metrics
from distributeddeeplearning_tpu_torch.observability import telemetry
from distributeddeeplearning_tpu_torch.serve import cli, tracing
from distributeddeeplearning_tpu_torch.serve.engine import Engine, ServeConfig
from distributeddeeplearning_tpu_torch.serve.scheduler import SloScheduler
from tests.test_torch_serve_engine import _deadlines
from tests.test_torch_serve_spec import _preemption
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from tests.torch_serve_helpers import (VOCAB, assert_same, engine_pair,
                                       prompts, run_pair)

ATTRIBUTION_TOL = 1e-9
# Flight fields that differ between two runs by nature.
VOLATILE = {"t", "mono", "run", "seq", "host", "attempt", "_file"}


def _reset_all():
    for mod in (telemetry, jtele, metrics, jmetrics, flight, jflight):
        mod.reset()


class _TracedPair:
    """One engine pair built and driven with every observability layer on
    (each side its own), the events and registries kept for the tests."""

    def __init__(self, tmp, scenarios, **config):
        telemetry.configure(enabled=True)
        jtele.configure(enabled=True)
        metrics.configure(run_id="r")
        jmetrics.configure(run_id="r")
        flight.configure(str(tmp / "port"), run_id="r")
        jflight.configure(str(tmp / "jax"), run_id="r")
        try:
            jeng, teng = engine_pair(**config)
            assert teng.tracer is not None and jeng.tracer is not None
            self.pairs = []
            for scenario in scenarios:
                jreqs, treqs = run_pair(scenario, jeng, teng)
                assert_same(jeng, teng, jreqs, treqs)
                self.pairs.extend(zip(jreqs, treqs))
            self.events = telemetry.get().snapshot()
            self.jevents = jtele.get().snapshot()
            self.prom = metrics.get().prometheus_text()
            self.jprom = jmetrics.get().prometheus_text()
            flight.get().close()
            jflight.get().close()
            self.flight = flight.read_all(str(tmp / "port"))
            self.jflight = jflight.read_all(str(tmp / "jax"))
            self.spec_rounds = teng.spec_rounds
        finally:
            _reset_all()


def _queued(eng, sched):
    """Four requests through two slots: real queueing and interference."""
    reqs = [eng.submit([(7 * i + j) % VOCAB + 1 for j in range(6)],
                       max_new_tokens=4) for i in range(4)]
    eng.run_until_idle()
    return reqs


def _shared_head(eng, sched):
    """A page-aligned prompt twice: the second maps its pages from the
    tree and copies the trailing one on write."""
    prompt = list(range(1, 9))
    reqs = []
    for _ in range(2):
        reqs.append(eng.submit(prompt, max_new_tokens=5))
        eng.run_until_idle()
    return reqs


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    return _TracedPair(tmp_path_factory.mktemp("plain"),
                       [_queued, _deadlines], model="gpt_tiny",
                       prefill_buckets=(8,))


@pytest.fixture(scope="module")
def spec_run(tmp_path_factory):
    return _TracedPair(tmp_path_factory.mktemp("spec"),
                       [_shared_head, _preemption], model="gpt_tiny",
                       num_pages=8, prefix_cache=True,
                       spec_draft_model="gpt_nano", spec_k=3)


@pytest.fixture(params=["plain", "spec"])
def run(request):
    return request.getfixturevalue(f"{request.param}_run")


def _by_request(events) -> dict:
    """Per request uid (None: engine-level), the multiset of serve names."""
    out: dict = collections.defaultdict(collections.Counter)
    for e in events:
        if str(e.get("name", "")).startswith("serve:"):
            out[(e.get("args") or {}).get("request")][e["name"]] += 1
    return dict(out)


def test_attribution_components_equal_jax(run):
    finished = 0
    for jreq, treq in run.pairs:
        a, b = treq.trace, jreq.trace
        assert a is not None and a.done == b.done
        assert set(a.comp) == set(tracing.COMPONENTS)
        for k in tracing.COMPONENTS:
            assert abs(a.comp[k] - b.comp[k]) <= ATTRIBUTION_TOL, (
                treq.uid, k)
        assert (a.ttft_comp is None) == (b.ttft_comp is None)
        if a.ttft_comp is not None:
            for k in tracing.COMPONENTS:
                assert abs(a.ttft_comp[k] - b.ttft_comp[k]) \
                    <= ATTRIBUTION_TOL, (treq.uid, "ttft", k)
            assert abs(sum(a.ttft_comp.values()) - treq.ttft_s) \
                <= ATTRIBUTION_TOL
        total = treq.finished_s - treq.arrival_s
        assert abs(sum(a.comp.values()) - total) <= ATTRIBUTION_TOL
        finished += treq.failed is None
    assert finished >= 2
    atts = [e for e in run.events if e["name"] == "serve:attribution"]
    assert len(atts) == len(run.pairs)
    for e in atts:
        assert abs(e["args"]["sum_err_s"]) < ATTRIBUTION_TOL


def test_span_name_multisets_equal_jax_and_registered(run):
    ours, theirs = _by_request(run.events), _by_request(run.jevents)
    assert ours == theirs
    emitted = {name for counts in ours.values() for name in counts}
    assert emitted <= tracing.REGISTERED_PHASES
    for must in ("serve:submit", "serve:scheduler_plan", "serve:page_alloc",
                 "serve:prefill", "serve:decode", "serve:decode_tick",
                 "serve:attribution", "serve:request",
                 "serve:request_flow"):
        assert must in emitted, must


def test_spec_and_prefix_spans_emitted(spec_run, plain_run):
    emitted = {e["name"] for e in spec_run.events}
    for must in ("serve:spec_draft", "serve:spec_verify", "serve:cow_copy",
                 "serve:prefix_match", "serve:preempt"):
        assert must in emitted, must
    assert spec_run.spec_rounds > 0
    emitted = {e["name"] for e in plain_run.events}
    assert {"serve:deadline_miss", "serve:shed"} <= emitted


def test_registries_match_jax_and_name_every_series(run):
    assert run.prom == run.jprom
    for series in ("serve_live_slots", "serve_page_occupancy",
                   "serve_queue_depth", "serve_ttft_s",
                   "serve_total_latency_s", "serve_ttft_queue_s",
                   "serve_alloc_failures"):
        assert f"ddl_{series}{{" in run.prom, series


def test_flight_events_equal_jax(run):
    (ours, errors), (theirs, jerrors) = run.flight, run.jflight
    assert errors == [] and jerrors == []
    strip = [[{k: v for k, v in e.items() if k not in VOLATILE}
              for e in evs] for evs in (ours, theirs)]
    assert strip[0] == strip[1]
    kinds = {e["ev"] for e in ours}
    assert {"serve_admit", "serve_prefill", "serve_first_token",
            "serve_retire", "serve_shutdown"} <= kinds


def test_flight_kinds_cover_the_nine_events(plain_run, spec_run):
    kinds = {e["ev"] for run in (plain_run, spec_run) for e in run.flight[0]}
    assert kinds == {"serve_cow_copy", "serve_admit", "serve_prefill",
                     "serve_first_token", "serve_retire", "serve_preempt",
                     "serve_deadline_miss", "serve_shed", "serve_shutdown"}


def test_registry_schema_is_jax_s():
    assert tracing.REGISTERED_PHASES == jtracing.REGISTERED_PHASES
    assert tracing.COMPONENTS == jtracing.COMPONENTS
    assert tracing.STALL_REASONS == jtracing.STALL_REASONS
    for reason in ("priority", "no_slot", "no_pages", "backoff",
                   "tenant_cap", "alloc_race", "anything-else"):
        assert (tracing.component_for_reason(reason)
                == jtracing.component_for_reason(reason))


def test_plan_reasons_classify_every_skipped_request():
    class R:
        def __init__(self, uid, not_before=0.0):
            self.uid, self.tenant, self.arrival_s = uid, "default", 0.0
            self.total_tokens, self.not_before_s = 8, not_before

    sched = SloScheduler()
    plan = sched.plan(now=1.0, waiting=[R(0), R(1)], live=[], free_slots=0,
                      free_pages=100, page_size=4)
    assert plan.reasons == {0: "no_slot", 1: "no_slot"}
    plan = sched.plan(now=1.0, waiting=[R(0), R(1)], live=[], free_slots=2,
                      free_pages=0, page_size=4)
    assert plan.reasons == {0: "no_pages", 1: "no_pages"}
    assert tracing.component_for_reason("no_pages") == "admission_stall"
    assert tracing.component_for_reason("no_slot") == "interference"
    plan = sched.plan(now=1.0, waiting=[R(5, not_before=9.0)], live=[],
                      free_slots=2, free_pages=100, page_size=4)
    assert plan.reasons == {5: "backoff"} and not plan.admit


def _cpu_engine(**kw):
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]
    return Engine(ServeConfig(vocab_size=VOCAB, max_slots=2, page_size=4,
                              num_pages=32, max_pages_per_slot=8,
                              prefill_buckets=(8,), **kw),
                  device="cpu", clock=clock)


def test_disabled_tracing_is_zero_allocation():
    """Tracing off: no tracer, no per-request trace state, and a decode
    step allocates nothing in serve/tracing.py or
    observability/telemetry.py."""
    _reset_all()
    eng = _cpu_engine()
    eng.warmup()
    assert eng.tracer is None
    req = eng.submit([2, 7, 1, 8, 2, 8], max_new_tokens=6)
    assert req.trace is None
    eng.step()  # admission and prefill before the pinned window
    filters = [tracemalloc.Filter(True, "*serve/tracing.py"),
               tracemalloc.Filter(True, "*observability/telemetry.py")]
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot().filter_traces(filters)
        for _ in range(3):
            eng.step()
        after = tracemalloc.take_snapshot().filter_traces(filters)
    finally:
        tracemalloc.stop()
    diff = [d for d in after.compare_to(before, "filename")
            if d.size_diff > 0 or d.count_diff > 0]
    assert diff == []
    assert telemetry.get().snapshot() == []


def test_resumed_submit_continues_the_flow():
    tele = telemetry.configure(enabled=True)
    try:
        eng = _cpu_engine()
        eng.submit([3, 1, 4, 1, 5, 9], max_new_tokens=3, trace_id=424242,
                   resumed=True)
        with torch.inference_mode():
            eng.run_until_idle()
        flows = [e for e in tele.snapshot()
                 if e["name"] == "serve:request_flow"]
    finally:
        _reset_all()
    assert [e["ph"] for e in flows] == ["t", "f"]
    assert all(e["id"] == 424242 for e in flows)


def test_serve_trace_dir_merges_a_trace_that_adds_up(tmp_path, capsys):
    reqs = [{"prompt": p, "max_new_tokens": 4, "arrival_s": 0.0}
            for p in prompts(5, [6, 6, 6])]
    (tmp_path / "requests.json").write_text(json.dumps(reqs))
    (tmp_path / "config.json").write_text(json.dumps(dict(
        vocab_size=VOCAB, max_slots=2, page_size=4, num_pages=32,
        max_pages_per_slot=8, prefill_buckets=[8], prefix_cache=True)))
    trace_dir = tmp_path / "trace"
    try:
        rc = cli.main(["--serve", str(tmp_path / "requests.json"),
                       "--serve-config", str(tmp_path / "config.json"),
                       "--serve-out", str(tmp_path / "out.json"),
                       "--serve-trace-dir", str(trace_dir),
                       "--device", "cpu"])
        assert not telemetry.get().enabled  # the CLI leaves it as it was
    finally:
        _reset_all()
    assert rc == 0
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["trace_dir"] == str(trace_dir)
    assert out["merged_trace"] == str(trace_dir / "trace.merged.json")
    events, error = telemetry.load_events_tolerant(out["merged_trace"])
    assert error is None
    names = {e["name"] for e in events if e["name"].startswith("serve:")}
    assert names <= tracing.REGISTERED_PHASES
    atts = [e["args"] for e in events if e["name"] == "serve:attribution"]
    assert len(atts) == len(reqs)
    for a in atts:
        assert abs(a["sum_err_s"]) < 1e-3 and abs(a["ttft_sum_err_s"]) < 1e-3
    assert set(out["ttft_components_s"]) == set(tracing.COMPONENTS)
