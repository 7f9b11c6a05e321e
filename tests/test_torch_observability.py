"""The port's observability layers (distributeddeeplearning_tpu_torch/
observability/: telemetry, metrics, flight) against the JAX package's.

They are copies of pure standard-library modules, so the contracts of
tests/test_telemetry.py hold for them as they are: the ring bound, the
Chrome-trace schema, export that drains and merges, the disabled path's
shared no-op span, the step window, phase totals and the singleton. Beside
them, each layer is held to the JAX package's on the same inputs: a port
trace loads in JAX's reader with the same events, merged and truncated
files salvage alike, percentiles equal JAX's to 1e-12 on seeded data, the
Prometheus text of the same observations is equal, and a port flight file
reads alike through both readers.
"""

import json
import time

import numpy as np
import pytest

from distributeddeeplearning_tpu.observability import flight as jflight
from distributeddeeplearning_tpu.observability import metrics as jmetrics
from distributeddeeplearning_tpu.observability import telemetry as jtele
from distributeddeeplearning_tpu_torch.observability import (flight, metrics,
                                                             telemetry)

PERCENTILE_TOL = 1e-12


# --- telemetry core (the contracts of tests/test_telemetry.py) -------------

def test_span_nesting_and_ring_bound():
    tele = telemetry.Telemetry(enabled=True, max_events=8)
    with tele.span("outer", step=1):
        with tele.span("inner", step=1):
            pass
    events = tele.snapshot()
    assert [e["name"] for e in events] == ["inner", "outer"]
    assert all(e["args"]["step"] == 1 for e in events)
    for k in range(100):
        tele.instant(f"i{k}")
    events = tele.snapshot()
    assert len(events) == 8
    assert events[-1]["name"] == "i99"


def test_chrome_trace_schema(tmp_path):
    tele = telemetry.Telemetry(enabled=True, trace_dir=str(tmp_path),
                               process_index=3, process_name="t")
    with tele.span("phase_a", step=0, detail="x"):
        pass
    tele.record_span("phase_b", telemetry.now_s() - 0.5, telemetry.now_s())
    tele.instant("fault:crash", step=2)
    tele.gauge("hbm/d0", 123.0, step=0)
    tele.counter("bad_steps")
    path = tele.export()
    assert path == telemetry.trace_path(str(tmp_path), 3)
    assert path == jtele.trace_path(str(tmp_path), 3)
    obj = json.load(open(path))
    assert obj["displayTimeUnit"] == "ms"
    by_name = {e["name"]: e for e in obj["traceEvents"]}
    for e in obj["traceEvents"]:
        assert {"name", "ph", "ts", "pid"} <= set(e), e
    for name in ("phase_a", "phase_b"):
        assert by_name[name]["ph"] == "X" and by_name[name]["dur"] >= 0
    assert by_name["fault:crash"]["ph"] == "i"
    assert by_name["fault:crash"]["s"] == "p"
    assert by_name["hbm/d0"]["ph"] == "C"
    assert by_name["hbm/d0"]["args"]["value"] == 123.0
    assert by_name["process_name"]["args"]["name"] == "t p3"
    assert by_name["phase_b"]["dur"] == pytest.approx(500_000, rel=0.05)
    # The JAX package's reader sees the same file.
    assert jtele.load_events(path) == obj["traceEvents"]


def test_export_drains_and_merges(tmp_path):
    path = str(tmp_path / "trace.json")
    tele = telemetry.Telemetry(enabled=True)
    tele.instant("first")
    assert tele.export(path) == path
    assert tele.export(path) is None
    tele.instant("second")
    tele.export(path)
    other = telemetry.Telemetry(enabled=True, process_index=7)
    other.instant("launcher:restart")
    other.export(path)
    # A JAX registry folds into the port's file the same way.
    jax_side = jtele.Telemetry(enabled=True, process_index=9)
    jax_side.instant("jax")
    jax_side.export(path)
    names = [e["name"] for e in telemetry.load_events(path)]
    assert names.count("first") == 1 and names.count("second") == 1
    assert "launcher:restart" in names and "jax" in names
    metas = [e for e in telemetry.load_events(path) if e["ph"] == "M"]
    assert len(metas) == 3


def test_disabled_path_is_noop():
    tele = telemetry.Telemetry(enabled=False)
    assert tele.span("x") is telemetry._NULL_SPAN
    tele.record_span("x", 0.0, 1.0)
    tele.instant("x")
    tele.gauge("x", 1.0)
    tele.counter("x")
    tele.flow("x", 1, "s")
    tele.async_begin("x", 1)
    tele.async_end("x", 1)
    assert tele.snapshot() == []
    assert tele.export("/nonexistent/should/never/be/written") is None
    t0 = time.perf_counter()
    for _ in range(50_000):
        with tele.span("step"):
            pass
    assert time.perf_counter() - t0 < 0.5


def test_trace_steps_window():
    tele = telemetry.Telemetry(enabled=True, trace_steps=(10, 20))
    with tele.span("in", step=10):
        pass
    assert tele.span("out", step=20) is telemetry._NULL_SPAN
    tele.record_span("out", 0.0, 1.0, step=9)
    tele.gauge("out", 1.0, step=25)
    with tele.span("stepless"):
        pass
    assert [e["name"] for e in tele.snapshot()] == ["in", "stepless"]


def test_phase_totals_equal_jax():
    rng = np.random.default_rng(3)
    events = [{"name": f"p{int(rng.integers(0, 4))}", "ph": "X", "ts": 0,
               "dur": int(rng.integers(0, 10_000))} for _ in range(50)]
    events.append({"name": "skip", "ph": "i", "ts": 0})
    totals = telemetry.phase_totals(events)
    assert totals == jtele.phase_totals(events)
    assert list(totals) == sorted(totals,
                                  key=lambda k: -totals[k]["total_ms"])


def test_configure_singleton_roundtrip(tmp_path):
    try:
        tele = telemetry.configure(trace_dir=str(tmp_path))
        assert tele.enabled
        assert telemetry.get() is tele
        assert not telemetry.configure().enabled
    finally:
        telemetry.reset()
    assert not telemetry.get().enabled


def test_configure_from_env_reads_the_jax_variable(tmp_path, monkeypatch):
    assert telemetry.ENV_TRACE_DIR == jtele.ENV_TRACE_DIR
    monkeypatch.delenv(telemetry.ENV_TRACE_DIR, raising=False)
    assert telemetry.configure_from_env() is None
    monkeypatch.setenv(telemetry.ENV_TRACE_DIR, str(tmp_path))
    try:
        tele = telemetry.configure_from_env(process_index=2)
        assert tele.enabled and tele.trace_dir == str(tmp_path)
        assert tele.process_index == 2
    finally:
        telemetry.reset()


def test_flows_and_async_tracks_match_jax():
    def record(mod):
        tele = mod.Telemetry(enabled=True)
        tele.async_begin("serve:request", 5, ts_s=1.0, request=5)
        tele.flow("serve:request_flow", 5, "s", ts_s=1.5)
        tele.flow("serve:request_flow", 5, "f", ts_s=2.0)
        tele.async_end("serve:request", 5, ts_s=2.0, status="ok")
        return [{k: v for k, v in e.items() if k != "tid"}
                for e in tele.snapshot()]

    assert record(telemetry) == record(jtele)


def test_truncated_trace_salvaged_as_jax_does(tmp_path):
    t0 = telemetry.Telemetry(enabled=True, trace_dir=str(tmp_path),
                             process_index=0, process_name="replica-0")
    for i in range(3):
        t0.instant(f"ok{i}")
    t0.export()
    t1 = telemetry.Telemetry(enabled=True, trace_dir=str(tmp_path),
                             process_index=1, process_name="replica-1")
    for i in range(3):
        t1.instant(f"cut{i}")
    p1 = t1.export()
    text = open(p1).read()
    with open(p1, "w") as fh:
        fh.write(text[:text.rindex('"cut2"') + 3])
    assert telemetry.load_events_tolerant(p1) == jtele.load_events_tolerant(
        p1)
    merged, errors = telemetry.merge_trace_dir(str(tmp_path))
    assert merged == str(tmp_path / "trace.merged.json")
    assert errors and "truncated" in errors[0]
    names = {e["name"] for e in telemetry.load_events(merged)}
    assert {"ok0", "ok1", "ok2", "cut0", "cut1"} <= names
    assert "cut2" not in names


# --- metrics ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_percentiles_equal_jax_and_numpy(seed):
    rng = np.random.default_rng(seed)
    values = rng.exponential(0.2, int(rng.integers(1, 300))).tolist()
    values += [float("nan"), float("inf")]     # dropped by both
    for pct in (0, 1, 50, 90, 99, 99.9, 100):
        ours = metrics.percentile(values, pct)
        assert abs(ours - jmetrics.percentile(values, pct)) <= PERCENTILE_TOL
        finite = [v for v in values if np.isfinite(v)]
        assert abs(ours - float(np.percentile(finite, pct))) \
            <= PERCENTILE_TOL
    assert metrics.percentile([], 50) is None
    assert metrics.percentile([5.0], 99) == 5.0


def test_registry_text_and_aggregate_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    ours = metrics.MetricsRegistry(run_id="r1")
    theirs = jmetrics.MetricsRegistry(run_id="r1")
    for step in range(1, 101):
        for reg in (ours, theirs):
            reg.observe("serve_ttft_s", step / 100.0, step=step)
            reg.observe("serve_live_slots", int(step % 7), step=step)
            reg.observe("loss", float("nan"), step=step)   # dropped
    for reg in (ours, theirs):
        reg.observe_many({"step": 3, "a": 1.5, "b": "x"}, host=1)
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert 'ddl_serve_ttft_s_p99{run="r1"} 0.9901' in ours.prometheus_text()
    a, b = ours.aggregate(), theirs.aggregate()
    a.pop("generated_at")
    b.pop("generated_at")
    assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))
    path = ours.write_snapshot(str(tmp_path / "m.json"))
    assert json.load(open(path))["metrics"]["serve_ttft_s"]["samples"] == 100


def test_metrics_singleton():
    try:
        reg = metrics.configure(run_id="x")
        assert metrics.get() is reg and reg.run_id == "x"
    finally:
        metrics.reset()
    assert metrics.get().run_id == ""


# --- flight ---------------------------------------------------------------

def test_flight_file_reads_alike_through_both_readers(tmp_path,
                                                      monkeypatch):
    assert (flight.ENV_FLIGHT_DIR, flight.ENV_RUN_ID) == (
        jflight.ENV_FLIGHT_DIR, jflight.ENV_RUN_ID)
    monkeypatch.setenv(flight.ENV_FLIGHT_DIR, str(tmp_path))
    monkeypatch.setenv(flight.ENV_RUN_ID, "run-x")
    try:
        rec = flight.configure_from_env(host=0)
        assert rec.enabled and rec.run_id == "run-x"
        for i in range(5):
            flight.get().record("serve_admit", request=i, slot=i % 2)
        flight.get().record("serve_shed", request=9, reason="shed")
    finally:
        flight.reset()
    assert not flight.get().enabled
    flight.get().record("dropped")      # the disabled recorder: a no-op
    path = flight.flight_path(str(tmp_path), 0)
    assert path == jflight.flight_path(str(tmp_path), 0)
    ours, err = flight.read_file(path)
    theirs, jerr = jflight.read_file(path)
    assert ours == theirs and err is None and jerr is None
    assert [e["seq"] for e in ours] == list(range(1, 7))
    assert flight.read_all(str(tmp_path)) == jflight.read_all(str(tmp_path))
    # A torn tail line is skipped and reported, the rest salvaged.
    with open(path, "a") as fh:
        fh.write('{"ev": "torn')
    events, err = flight.read_file(path)
    assert len(events) == 6 and "unparseable" in err
