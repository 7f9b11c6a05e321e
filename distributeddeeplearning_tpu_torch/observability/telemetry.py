"""Phase telemetry: spans, instants, async tracks, flows, counters and
gauges in a bounded ring buffer, exported as Chrome-trace JSON.

The port's own copy of ``distributeddeeplearning_tpu/observability/
telemetry.py`` (pure stdlib, so it is copied whole): the same event
layout, the same ``DDL_TRACE_DIR`` variable, the same per-process file
names (:func:`trace_path`) and merge (:func:`merge_trace_dir`), so the
JAX package's trace tools read the port's traces as they are.

1. **Cheap enough to leave on.** Events are small dicts appended to a
   ``collections.deque(maxlen=...)`` under a lock, with no I/O until
   :meth:`Telemetry.export`. The disabled path is a no-op: ``span()``
   returns a shared do-nothing context manager and every record method
   returns after one attribute check.
2. **Mergeable.** ``export`` folds its events into any trace file already
   at the destination path (under an advisory lock), and every timestamp
   is CLOCK_MONOTONIC, shared by the processes of one host, so merged
   events stay ordered.

The module-level singleton (:func:`get` / :func:`configure`) is what the
instrumentation sites (the serve engine's tracer, serve/tracing.py)
record through; tests construct :class:`Telemetry` directly.
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from collections import deque
from typing import Any, Optional

try:  # POSIX advisory locking for multi-process export merges
    import fcntl
except ImportError:  # pragma: no cover - non-POSIX fallback
    fcntl = None  # type: ignore[assignment]

DEFAULT_MAX_EVENTS = 200_000

#: Child processes (serve replicas) inherit their trace destination from
#: the supervisor through this env var — the serve counterpart of the
#: launcher's coordinator env plumbing.
ENV_TRACE_DIR = "DDL_TRACE_DIR"


def now_s() -> float:
    """Monotonic seconds — the clock every span endpoint must come from."""
    return time.monotonic()


def trace_path(trace_dir: str, process_index: int) -> str:
    """Canonical per-process trace file: one file per training process;
    the launcher merges its own events into process 0's file."""
    return os.path.join(trace_dir, f"trace.p{process_index}.json")


class _NullSpan:
    """Shared no-op span: the entire disabled/off-window code path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tele", "_name", "_args", "_t0")

    def __init__(self, tele: "Telemetry", name: str, args: dict):
        self._tele, self._name, self._args = tele, name, args

    def __enter__(self):
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        self._tele._emit({
            "name": self._name, "ph": "X", "ts": self._t0 // 1000,
            "dur": max((time.monotonic_ns() - self._t0) // 1000, 0),
            "pid": self._tele.process_index,
            "tid": threading.get_ident() & 0xFFFF,
            "args": self._args})
        return False


class Telemetry:
    """Thread-safe span/counter/gauge registry over a bounded ring buffer.

    ``trace_steps=(lo, hi)`` restricts *step-tagged* events to the
    half-open window [lo, hi); events with no step (bucket trace spans,
    fault/restart instants) are always kept. ``max_events`` bounds memory:
    the deque drops the oldest events, so a long run's export holds the
    most recent window — the part a post-mortem wants.
    """

    def __init__(self, enabled: bool = False,
                 trace_dir: Optional[str] = None,
                 trace_steps: Optional[tuple[int, int]] = None,
                 max_events: int = DEFAULT_MAX_EVENTS,
                 process_index: int = 0,
                 process_name: str = "ddl"):
        self.enabled = bool(enabled)
        self.trace_dir = trace_dir
        self.trace_steps = tuple(trace_steps) if trace_steps else None
        self.process_index = int(process_index)
        self.process_name = process_name
        self._events: deque = deque(maxlen=max(int(max_events), 1))
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}

    # -- recording ----------------------------------------------------------

    def _in_window(self, step: Optional[int]) -> bool:
        if self.trace_steps is None or step is None:
            return True
        lo, hi = self.trace_steps
        return lo <= step < hi

    def _emit(self, event: dict) -> None:
        with self._lock:
            self._events.append(event)

    def span(self, name: str, *, step: Optional[int] = None, **args: Any):
        """Context manager timing a phase; ``with tele.span("data_wait",
        step=i): ...``. Returns the shared no-op span when disabled or when
        ``step`` falls outside the trace window."""
        if not self.enabled or not self._in_window(step):
            return _NULL_SPAN
        if step is not None:
            args["step"] = step
        return _Span(self, name, args)

    def record_span(self, name: str, start_s: float, end_s: float, *,
                    step: Optional[int] = None, tid: Optional[int] = None,
                    **args: Any) -> None:
        """Record an already-measured span from two :func:`now_s` readings
        — for call sites that time unconditionally (the hot loop shares one
        clock read between telemetry and the straggler monitor) or that
        only decide to record after the fact (checkpoint_save records only
        when a save actually launched). ``tid`` overrides the thread-id
        lane: the serve engine renders per-slot decode ticks on one stable
        track per slot instead of interleaving every slot onto the host
        thread's row."""
        if not self.enabled or not self._in_window(step):
            return
        if step is not None:
            args["step"] = step
        self._emit({
            "name": name, "ph": "X", "ts": int(start_s * 1e6),
            "dur": max(int((end_s - start_s) * 1e6), 0),
            "pid": self.process_index,
            "tid": (threading.get_ident() & 0xFFFF if tid is None
                    else int(tid)),
            "args": args})

    def flow(self, name: str, flow_id: int, phase: str, *,
             ts_s: Optional[float] = None, cat: str = "serve",
             **args: Any) -> None:
        """A flow event: ``phase`` is ``"s"`` (start), ``"t"`` (step), or
        ``"f"`` (finish). Events sharing ``cat`` + ``flow_id`` draw one
        arrow chain in the trace viewer ACROSS processes — how a request
        re-dispatched after a replica death stays one visual thread. Flow
        events bind to the enclosing slice on their pid/tid/ts, so stamp
        ``ts_s`` inside the span the arrow should anchor to."""
        if not self.enabled:
            return
        event = {
            "name": name, "cat": cat, "ph": phase, "id": int(flow_id),
            "ts": (time.monotonic_ns() // 1000 if ts_s is None
                   else int(ts_s * 1e6)),
            "pid": self.process_index,
            "tid": threading.get_ident() & 0xFFFF, "args": args}
        if phase == "f":
            event["bp"] = "e"  # bind the finish to the enclosing slice
        self._emit(event)

    def async_begin(self, name: str, async_id: int, *,
                    ts_s: Optional[float] = None, cat: str = "serve",
                    **args: Any) -> None:
        """Open an async ("b") span — a wall-clock track whose begin/end
        can be in different steps (a request's whole life from arrival to
        retirement). Matched to :meth:`async_end` by ``cat`` + id +
        name."""
        if not self.enabled:
            return
        self._emit({
            "name": name, "cat": cat, "ph": "b", "id": int(async_id),
            "ts": (time.monotonic_ns() // 1000 if ts_s is None
                   else int(ts_s * 1e6)),
            "pid": self.process_index, "tid": 0, "args": args})

    def async_end(self, name: str, async_id: int, *,
                  ts_s: Optional[float] = None, cat: str = "serve",
                  **args: Any) -> None:
        """Close an async span opened by :meth:`async_begin`."""
        if not self.enabled:
            return
        self._emit({
            "name": name, "cat": cat, "ph": "e", "id": int(async_id),
            "ts": (time.monotonic_ns() // 1000 if ts_s is None
                   else int(ts_s * 1e6)),
            "pid": self.process_index, "tid": 0, "args": args})

    def instant(self, name: str, *, step: Optional[int] = None,
                **args: Any) -> None:
        """A zero-duration marker (fault fired, restart scheduled, ...)."""
        if not self.enabled:
            return
        if step is not None:
            args["step"] = step
        self._emit({
            "name": name, "ph": "i", "s": "p",
            "ts": time.monotonic_ns() // 1000, "pid": self.process_index,
            "tid": threading.get_ident() & 0xFFFF, "args": args})

    def gauge(self, name: str, value, *, step: Optional[int] = None) -> None:
        """A sampled value (HBM bytes, queue depth) -> Chrome counter
        track."""
        if not self.enabled or not self._in_window(step):
            return
        self._emit({
            "name": name, "ph": "C", "ts": time.monotonic_ns() // 1000,
            "pid": self.process_index, "tid": 0,
            "args": {"value": float(value)}})

    def counter(self, name: str, inc: float = 1.0, *,
                step: Optional[int] = None) -> None:
        """A monotonically accumulating count (faults fired, bad steps);
        each increment emits the running total as a counter event."""
        if not self.enabled:
            return
        with self._lock:
            total = self._counters.get(name, 0.0) + float(inc)
            self._counters[name] = total
        if not self._in_window(step):
            return
        self._emit({
            "name": name, "ph": "C", "ts": time.monotonic_ns() // 1000,
            "pid": self.process_index, "tid": 0,
            "args": {"value": total}})

    # -- inspection / export ------------------------------------------------

    def snapshot(self) -> list[dict]:
        """The buffered events, oldest first, without draining them."""
        with self._lock:
            return list(self._events)

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write (and DRAIN) the buffered events as Chrome-trace JSON.

        Merges into an existing file at ``path`` — a restarted attempt or
        the launcher folds its events into the same trace. Returns the
        path written, or None when there is nowhere/nothing to write.
        """
        if path is None:
            if self.trace_dir is None:
                return None
            path = trace_path(self.trace_dir, self.process_index)
        with self._lock:
            events = list(self._events)
            self._events.clear()
        if not events:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        # The merge below is read-modify-write; two processes (or threads
        # of one process through separate registries) exporting to the
        # same path would otherwise race and lose whichever write landed
        # first. Serialize through an advisory lock on a sidecar file —
        # the trace itself is still replaced atomically, so readers never
        # need the lock.
        lock_fh = None
        if fcntl is not None:
            lock_fh = open(f"{path}.lock", "a")
            fcntl.flock(lock_fh.fileno(), fcntl.LOCK_EX)
        try:
            existing: list = []
            try:
                with open(path) as fh:
                    prior = json.load(fh)
                existing = (prior.get("traceEvents", [])
                            if isinstance(prior, dict) else list(prior))
            except (OSError, ValueError):
                pass  # first write, or an unreadable prior file
            meta = []
            if not any(e.get("ph") == "M"
                       and e.get("pid") == self.process_index
                       for e in existing):
                meta.append({
                    "name": "process_name", "ph": "M", "ts": 0,
                    "pid": self.process_index,
                    "args": {"name":
                             f"{self.process_name} p{self.process_index}"}})
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w") as fh:
                json.dump({"traceEvents": existing + meta + events,
                           "displayTimeUnit": "ms"}, fh)
            os.replace(tmp, path)
        finally:
            if lock_fh is not None:
                fcntl.flock(lock_fh.fileno(), fcntl.LOCK_UN)
                lock_fh.close()
        return path


# ---------------------------------------------------------------------------
# Module singleton — what the instrumentation sites record through.
# ---------------------------------------------------------------------------

_active = Telemetry()


def get() -> Telemetry:
    return _active


def configure(enabled: Optional[bool] = None,
              trace_dir: Optional[str] = None,
              trace_steps: Optional[tuple[int, int]] = None,
              max_events: int = DEFAULT_MAX_EVENTS,
              process_index: int = 0,
              process_name: str = "ddl") -> Telemetry:
    """Install a fresh module-level registry (one per run). ``enabled``
    defaults to "a trace destination was given"."""
    global _active
    if enabled is None:
        enabled = trace_dir is not None or trace_steps is not None
    _active = Telemetry(enabled=enabled, trace_dir=trace_dir,
                        trace_steps=trace_steps, max_events=max_events,
                        process_index=process_index,
                        process_name=process_name)
    return _active


def configure_from_env(process_index: int = 0,
                       process_name: str = "ddl") -> Optional[Telemetry]:
    """Child-process side of the serve trace plumbing: install a registry
    pointed at :data:`ENV_TRACE_DIR` when the supervisor set it, else
    leave the (disabled) singleton alone and return None. Replicas call
    this before building their engine so the engine's tracer resolves."""
    trace_dir = os.environ.get(ENV_TRACE_DIR)
    if not trace_dir:
        return None
    return configure(enabled=True, trace_dir=trace_dir,
                     process_index=process_index,
                     process_name=process_name)


def reset() -> None:
    """Back to the disabled singleton (tests)."""
    global _active
    _active = Telemetry()


# ---------------------------------------------------------------------------
# Trace analysis helpers.
# ---------------------------------------------------------------------------

def load_events(path: str) -> list[dict]:
    """Events from a Chrome-trace JSON file (object or bare-array form)."""
    with open(path) as fh:
        obj = json.load(fh)
    return obj.get("traceEvents", []) if isinstance(obj, dict) else list(obj)


def load_events_tolerant(path: str) -> tuple[list[dict], Optional[str]]:
    """Like :func:`load_events`, but salvages a truncated file.

    A crashed process can leave a trace cut mid-write (the export itself
    is atomic, but ctrl-C'd copies and half-synced artifact pulls are
    not). Returns ``(events, error)``: on clean parse ``error`` is None;
    on damage, every complete event object that precedes the cut is
    recovered one ``raw_decode`` at a time and ``error`` says what was
    lost — the caller decides how loudly to say it (an analysis that
    silently drops the tail would misreport phase totals as complete).
    """
    try:
        return load_events(path), None
    except OSError as e:
        return [], f"{path}: {e}"
    except ValueError:
        pass
    try:
        with open(path, errors="replace") as fh:
            text = fh.read()
    except OSError as e:
        return [], f"{path}: {e}"
    # Find the events array (object form) or the array start (bare form),
    # then decode complete {...} entries until the truncation point.
    start = text.find('"traceEvents"')
    start = text.find("[", start if start >= 0 else 0)
    if start < 0:
        return [], f"{path}: unparseable trace (no event array found)"
    dec = json.JSONDecoder()
    events: list[dict] = []
    i = start + 1
    n = len(text)
    while i < n:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            break
        try:
            obj, end = dec.raw_decode(text, i)
        except ValueError:
            break  # the truncated tail — everything before it is saved
        if isinstance(obj, dict):
            events.append(obj)
        i = end
    return events, (f"{path}: truncated trace; recovered "
                    f"{len(events)} complete event(s)")


def merge_traces(paths, out_path: str) -> tuple[Optional[str], list[str]]:
    """Fold several per-process trace files into ONE Chrome-trace JSON.

    Every timestamp is CLOCK_MONOTONIC on the one host the serve fleet
    runs on, so a plain concatenation is already time-coherent; events
    are sorted metadata-first then by timestamp so viewers name the
    process tracks before drawing them. Damaged inputs (a SIGKILL'd
    replica's final file) go through the tolerant loader — whatever was
    recovered is merged and the loss is reported, not hidden. Returns
    ``(out_path or None-if-no-events, errors)``.
    """
    events: list[dict] = []
    errors: list[str] = []
    for p in paths:
        evs, err = load_events_tolerant(p)
        events.extend(evs)
        if err:
            errors.append(err)
    if not events:
        return None, errors
    events.sort(key=lambda e: (0 if e.get("ph") == "M" else 1,
                               e.get("ts", 0)))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    tmp = f"{out_path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, fh)
    os.replace(tmp, out_path)
    return out_path, errors


def merge_trace_dir(trace_dir: str, out_name: str = "trace.merged.json"
                    ) -> tuple[Optional[str], list[str]]:
    """Merge every ``trace.p*.json`` in ``trace_dir`` (the per-replica
    layout :func:`trace_path` writes) into ``trace_dir/out_name``. The
    merged name deliberately does not match the per-process glob, so
    directory-mode tools never double-count it."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "trace.p*.json")))
    if not paths:
        return None, [f"{trace_dir}: no trace.p*.json files to merge"]
    return merge_traces(paths, os.path.join(trace_dir, out_name))


def phase_totals(events) -> dict[str, dict[str, float]]:
    """Per-phase aggregate over the complete ("X") spans: count, total and
    mean duration in milliseconds, keyed by span name, largest total
    first."""
    acc: dict[str, list[float]] = {}
    for e in events:
        if e.get("ph") == "X":
            acc.setdefault(e["name"], []).append(float(e.get("dur", 0)))
    out = {}
    for name, durs in sorted(acc.items(),
                             key=lambda kv: -sum(kv[1])):
        total_us = sum(durs)
        out[name] = {"count": len(durs),
                     "total_ms": total_us / 1000.0,
                     "mean_ms": total_us / len(durs) / 1000.0}
    return out

