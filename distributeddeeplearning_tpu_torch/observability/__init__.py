"""Observability of the port: the standard-library layers the serve engine
records through, copies of the JAX package's (``distributeddeeplearning_
tpu/observability/``) with the same event layouts, series names and
environment variables.

- :mod:`.telemetry`: span/instant/flow/counter/gauge registry over a
  bounded ring buffer, exported as Chrome-trace JSON.
- :mod:`.metrics`: gauge registry with Prometheus-text and JSON-snapshot
  export and p50/p90/p99 summaries.
- :mod:`.flight`: the crash-surviving fsync'd JSONL event log.
"""

from distributeddeeplearning_tpu_torch.observability import (
    flight, metrics, telemetry)

__all__ = ["flight", "metrics", "telemetry"]
