"""Metrics registry: gauges observed over a run, summarised as series.

The port's own copy of ``distributeddeeplearning_tpu/observability/
metrics.py`` (pure stdlib), with the same series names:

- ``observe(name, value, host=...)`` keeps the latest value per
  ``(metric, host)`` and a bounded per-metric series of ``(step, value)``
  samples;
- ``prometheus_text()`` renders the current state in Prometheus text
  exposition format (``# TYPE`` + ``ddl_<metric>{run=...,host=...}``
  gauge lines, with p50/p90/p99 lines per series);
- ``write_snapshot()`` publishes a JSON aggregate (min / max / mean /
  last / percentiles per metric, plus the recent series).

The serve engine observes its gauges here every step (live slots, page
occupancy, queue depth, TTFT, shed / deadline-miss / retry totals, the
prefix hit rate and the speculative acceptance), and the serve tracer its
TTFT components. Plain host-side Python: no device reads of its own.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from collections import deque
from typing import Any, Optional

DEFAULT_MAX_SAMPLES = 512

#: Quantiles every observed series is summarized at — p99 is the SLO the
#: serve stack is run against, p50/p90 give the shape of the body.
PERCENTILES = (50, 90, 99)

_RE_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def percentile(values, pct: float) -> Optional[float]:
    """The ``pct``-th percentile of ``values`` by linear interpolation
    between closest ranks (numpy's default method, in the standard
    library alone). None on an empty input."""
    vals = sorted(v for v in values if _finite(v) is not None)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    rank = (len(vals) - 1) * (float(pct) / 100.0)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return float(vals[lo] + (vals[hi] - vals[lo]) * frac)


def _sane(name: str) -> str:
    out = _RE_SANITIZE.sub("_", name)
    return out if not out[:1].isdigit() else "_" + out


def _finite(value: Any) -> Optional[float]:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return v if math.isfinite(v) else None


class MetricsRegistry:
    """Run-level gauge store with Prometheus + JSON snapshot export."""

    def __init__(self, *, run_id: str = "", max_samples: int =
                 DEFAULT_MAX_SAMPLES):
        self.run_id = run_id
        self.max_samples = int(max_samples)
        self._lock = threading.Lock()
        # (name, host) -> latest value; name -> deque[(step, value)]
        self._last: dict[tuple[str, Any], float] = {}
        self._series: dict[str, deque] = {}

    # -- ingest ----------------------------------------------------------

    def observe(self, name: str, value: Any, *, step: Optional[int] = None,
                host: Any = 0) -> None:
        """Record one gauge sample. Non-numeric / non-finite values are
        dropped (NaN loss is the anomaly detector's job, not the
        scraper's)."""
        v = _finite(value)
        if v is None:
            return
        with self._lock:
            self._last[(name, host)] = v
            series = self._series.get(name)
            if series is None:
                series = self._series[name] = deque(maxlen=self.max_samples)
            series.append((int(step) if step is not None else None, v))

    def observe_many(self, record: dict[str, Any], *,
                     step: Optional[int] = None, host: Any = 0) -> None:
        """Ingest every numeric field of a metrics record (the dict
        ``MetricLogger.log`` returns) in one call."""
        if step is None:
            step = record.get("step")
        for name, value in record.items():
            if name == "step":
                continue
            self.observe(name, value, step=step, host=host)

    # -- views -----------------------------------------------------------

    def hosts(self) -> list:
        with self._lock:
            return sorted({h for (_, h) in self._last}, key=str)

    def aggregate(self) -> dict[str, Any]:
        """Run-level summary: per metric, stats over the per-host latest
        values plus the tail of the series."""
        with self._lock:
            out: dict[str, Any] = {"run": self.run_id,
                                   "generated_at": time.time(),
                                   "metrics": {}}
            by_name: dict[str, dict[Any, float]] = {}
            for (name, host), v in self._last.items():
                by_name.setdefault(name, {})[host] = v
            for name, per_host in sorted(by_name.items()):
                vals = list(per_host.values())
                series = list(self._series.get(name, ()))
                svals = [v for (_, v) in series]
                out["metrics"][name] = {
                    "last": vals[-1] if len(vals) == 1 else per_host[
                        sorted(per_host, key=str)[0]],
                    "per_host": {str(h): v
                                 for h, v in sorted(per_host.items(),
                                                    key=lambda kv:
                                                    str(kv[0]))},
                    "min": min(vals), "max": max(vals),
                    "mean": sum(vals) / len(vals),
                    "samples": len(series),
                    "series_tail": series[-32:],
                    # Quantiles over the OBSERVED SERIES (all samples in
                    # the window), not the per-host latest values — for
                    # per-request observations like serve_ttft_s these
                    # ARE the p50/p90/p99 an SLO is stated against.
                    "percentiles": {f"p{p}": percentile(svals, p)
                                    for p in PERCENTILES},
                }
            return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, one gauge per (metric,
        host) with ``run`` and ``host`` labels."""
        with self._lock:
            lines: list[str] = []
            by_name: dict[str, dict[Any, float]] = {}
            for (name, host), v in self._last.items():
                by_name.setdefault(name, {})[host] = v
            for name, per_host in sorted(by_name.items()):
                metric = f"ddl_{_sane(name)}"
                lines.append(f"# TYPE {metric} gauge")
                for host, v in sorted(per_host.items(),
                                      key=lambda kv: str(kv[0])):
                    labels = f'run="{self.run_id}",host="{host}"'
                    lines.append(f"{metric}{{{labels}}} {v:.10g}")
                svals = [v for (_, v) in self._series.get(name, ())]
                if len(svals) > 1:
                    # Series quantiles as separate gauge families (the
                    # summary type would claim these are streaming
                    # quantiles; they are window quantiles over the
                    # bounded sample deque).
                    for p in PERCENTILES:
                        q = percentile(svals, p)
                        qm = f"{metric}_p{p}"
                        lines.append(f"# TYPE {qm} gauge")
                        lines.append(
                            f'{qm}{{run="{self.run_id}"}} {q:.10g}')
            return "\n".join(lines) + ("\n" if lines else "")

    # -- export ----------------------------------------------------------

    def write_prometheus(self, path: str) -> Optional[str]:
        return _publish(path, self.prometheus_text())

    def write_snapshot(self, path: str) -> Optional[str]:
        return _publish(path, json.dumps(self.aggregate(), indent=2,
                                         sort_keys=True) + "\n")


def _publish(path: str, text: str) -> Optional[str]:
    """Atomic best-effort write (same contract as sidecars.write)."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(text)
        os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001
        return None


# -- module singleton (telemetry-style) ----------------------------------

_active = MetricsRegistry()


def get() -> MetricsRegistry:
    return _active


def configure(*, run_id: str = "", max_samples: int =
              DEFAULT_MAX_SAMPLES) -> MetricsRegistry:
    global _active
    _active = MetricsRegistry(run_id=run_id, max_samples=max_samples)
    return _active


def reset() -> None:
    configure()
