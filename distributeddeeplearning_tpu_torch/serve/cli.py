#!/usr/bin/env python
"""One-replica serving entry point of the PyTorch port.

    python -m distributeddeeplearning_tpu_torch.serve \
        --serve requests.json --serve-config config.json \
        --serve-out out.json [--params gpt2_small.npz] [--device cpu]

The one-replica form of the JAX launcher's serve mode (``launch.py
--serve``), with its flags where they apply. ``requests.json`` is a
non-empty list of ``{"prompt": [ids], "max_new_tokens": n, "tenant"?,
"arrival_s"?, "uid"?}``; ``config.json`` holds ``ServeConfig`` fields (a
JAX ``config.json`` loads as it is). One in-process ``Engine`` runs on the
``time.monotonic`` clock and admits each request once its ``arrival_s``
(seconds after the start) has passed. Weights come from ``--params``, an
``.npz`` of the JAX package's ``params`` collection with ``/``-joined
paths, or else from the registry model built with the config's seed.

``--serve-out`` gets ``results`` keyed by uid (``tokens``, ``finished``,
``failed``, ``ttft_s``, ``itl_s``, ``preemptions``) with ``leak_check_ok``,
the engine's counters (the speculative ones included) and the run's
figures; the engine's ``warmup`` runs before the clock starts. The drained
line is printed last; the exit code is 0 only if every request finished
and the leak check held. A config with ``spec_draft_model`` and ``spec_k``
serves speculatively, the drafter from the registry (see ``Engine``).

``--serve-trace-dir DIR`` (the JAX launcher's flag, for one replica)
enables telemetry before the engine is built, so every request records its
span tree and TTFT attribution (serve/tracing.py); after the drain the
replica's trace is exported to ``DIR/trace.p0.json`` and merged into
``DIR/trace.merged.json``, and ``--serve-out`` gains ``trace_dir``,
``merged_trace`` and the p50/p99 of each TTFT and latency component.

The engine's gauges (``observability/metrics.py``, under the JAX engine's
series names: live slots, page occupancy, queue depth, sheds, deadline
misses, retries, allocation failures, prefix hit rate, speculative
acceptance, each request's TTFT) are summed up under ``metrics`` in
``--serve-out``.
With ``DDL_FLIGHT_DIR`` set, the engine's lifecycle events (admit, prefill,
first token, retire, preempt, shed, copy on write, shutdown) are appended
to ``$DDL_FLIGHT_DIR/flight.p0.jsonl`` as they happen, run id from
``DDL_RUN_ID``, as the JAX replica records them.
Several replicas (``--num-processes`` above 1) and ``--serve-autoscale``
need the replica supervisor, a later slice of the port.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from distributeddeeplearning_tpu_torch.observability import (
    flight, metrics, telemetry)
from distributeddeeplearning_tpu_torch.serve import tracing
from distributeddeeplearning_tpu_torch.serve.engine import Engine, ServeConfig

SUPERVISOR_SLICE = ("the replica supervisor (JAX launch.py run_serve: "
                    "several replicas, restarts, re-dispatch, autoscale) "
                    "comes with a later slice of the port, with the "
                    "operational layers")
# A drain that takes more engine steps than this is a livelock.
MAX_STEPS = 1_000_000
COUNTERS = ("steps", "preemptions", "sheds", "deadline_misses", "retries",
            "prefix_hits", "prefix_misses", "prefix_tokens_reused",
            "cow_copies", "spec_rounds", "spec_proposed", "spec_accepted")


def _quantiles(values) -> dict:
    if not values:
        return {"p50": None, "p99": None}
    arr = np.asarray(values, np.float64)
    return {"p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99))}


def serve(requests: Sequence[dict], config: ServeConfig, *,
          state_dict: Optional[dict] = None, device=None,
          clock: Callable[[], float] = time.monotonic,
          sleep: Callable[[float], None] = time.sleep,
          trace_dir: Optional[str] = None, **engine_kw):
    """Drive one engine over ``requests`` (dicts as in the module doc),
    admitting each at its ``arrival_s`` after the start on ``clock``.
    Returns ``(out, engine)``: ``out`` is what ``--serve-out`` holds. With
    ``trace_dir`` the run is traced into it (``--serve-trace-dir``); the
    telemetry singleton is reset to its disabled state afterwards.
    ``engine_kw`` goes to the ``Engine`` (``model=``, ``draft_model=``,
    ``draft_state_dict=``)."""
    if trace_dir is None:
        return _serve(requests, config, state_dict=state_dict,
                      device=device, clock=clock, sleep=sleep, **engine_kw)
    os.makedirs(trace_dir, exist_ok=True)
    tele = telemetry.configure(enabled=True, trace_dir=trace_dir,
                               process_index=0, process_name="replica-0")
    try:
        out, engine = _serve(requests, config, state_dict=state_dict,
                             device=device, clock=clock, sleep=sleep,
                             **engine_kw)
        tele.export(telemetry.trace_path(trace_dir, 0))
    finally:
        telemetry.reset()
    merged, errors = telemetry.merge_trace_dir(trace_dir)
    out["trace_dir"] = trace_dir
    out["merged_trace"] = merged
    if errors:
        out["trace_merge_errors"] = errors
    done = [r for r in engine.finished if r.trace is not None]
    out["ttft_components_s"] = {
        k: _quantiles([r.trace.ttft_comp[k] for r in done
                       if r.trace.ttft_comp is not None])
        for k in tracing.COMPONENTS}
    out["latency_components_s"] = {
        k: _quantiles([r.trace.comp[k] for r in done])
        for k in tracing.COMPONENTS}
    return out, engine


def _serve(requests, config, *, state_dict, device, clock, sleep,
           **engine_kw):
    engine = Engine(config, state_dict=state_dict, device=device,
                    clock=clock, **engine_kw)
    cuda = engine.device.type == "cuda"
    pending = collections.deque(sorted(
        ((float(d.get("arrival_s", 0.0)), int(d.get("uid", i)), d)
         for i, d in enumerate(requests)), key=lambda r: r[:2]))
    by_uid: dict = {}
    warmup_s = engine.warmup()
    if cuda:
        torch.cuda.synchronize(engine.device)
        torch.cuda.reset_peak_memory_stats(engine.device)
    t0 = clock()
    max_pages = 0
    for _ in range(MAX_STEPS):
        now = clock()
        while pending and t0 + pending[0][0] <= now:
            arrival, uid, d = pending.popleft()
            by_uid[uid] = engine.submit(
                d["prompt"], max_new_tokens=int(d["max_new_tokens"]),
                tenant=d.get("tenant", "default"), arrival_s=t0 + arrival)
        if engine.idle:
            if not pending:
                break
            sleep(max(0.0, t0 + pending[0][0] - clock()))
            continue
        engine.step()
        max_pages = max(max_pages, engine.allocator.pages_in_use)
    else:
        raise RuntimeError(f"serve not drained after {MAX_STEPS} steps")
    window_s = clock() - t0
    try:
        engine.shutdown()
        leak_check_ok = True
    except RuntimeError as e:
        print(f"# serve: leak check failed: {e}", file=sys.stderr)
        leak_check_ok = False
    results = {}
    for uid, req in sorted(by_uid.items()):
        results[str(uid)] = {
            "tokens": list(req.tokens),
            "finished": req.failed is None and req.finished_s is not None,
            "failed": req.failed, "ttft_s": req.ttft_s,
            "itl_s": list(req.itl_s), "preemptions": req.preemptions}
    emitted = sum(len(r.tokens) for r in by_uid.values())
    out = {"results": results, "leak_check_ok": leak_check_ok,
           "window_s": window_s, "warmup_s": warmup_s,
           "tokens_emitted": emitted,
           "tokens_per_s": emitted / window_s if window_s > 0 else None,
           "ttft_s": _quantiles([r.ttft_s for r in by_uid.values()
                                 if r.ttft_s is not None]),
           "itl_s": _quantiles([x for r in by_uid.values()
                                for x in r.itl_s]),
           "max_pages_in_use": max_pages,
           "max_page_occupancy": max_pages / config.num_pages,
           "pool_bytes": engine.pools.nbytes,
           "peak_memory_gb": (torch.cuda.max_memory_allocated(engine.device)
                              / 1e9 if cuda else None),
           "device": str(engine.device),
           "counters": {k: getattr(engine, k) for k in COUNTERS}}
    return out, engine


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--serve", required=True, metavar="REQUESTS.json",
                   help="a non-empty JSON list of {prompt, max_new_tokens, "
                        "tenant?, arrival_s?, uid?}")
    p.add_argument("--serve-config", required=True, metavar="CONFIG.json",
                   help="ServeConfig fields")
    p.add_argument("--serve-out", default=None,
                   help="write the per-request results and the run's "
                        "figures here")
    p.add_argument("--params", default=None,
                   help="flax-layout params .npz ('/'-joined paths); "
                        "default: the registry model seeded by the config")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--serve-trace-dir", default=None, metavar="TRACE_DIR",
                   help="record per-request span trees and TTFT "
                        "attribution (serve/tracing.py) and merge them "
                        "into TRACE_DIR/trace.merged.json after the drain")
    p.add_argument("--num-processes", type=int, default=None,
                   help="replicas; only 1 in this slice")
    p.add_argument("--serve-autoscale", default=None, metavar="MIN:MAX",
                   help="not in this slice")
    args = p.parse_args(argv)
    if args.num_processes is not None and args.num_processes > 1:
        p.error(f"--num-processes {args.num_processes}: {SUPERVISOR_SLICE}")
    if args.serve_autoscale:
        p.error(f"--serve-autoscale: {SUPERVISOR_SLICE}")

    with open(args.serve, encoding="utf-8") as f:
        requests = json.load(f)
    if not isinstance(requests, list) or not requests:
        p.error(f"--serve {args.serve}: expected a non-empty JSON list")
    with open(args.serve_config, encoding="utf-8") as f:
        config = ServeConfig.from_dict(json.load(f))
    state_dict = None
    if args.params is not None:
        from distributeddeeplearning_tpu_torch.utils.weights import (
            params_from_flax)
        with np.load(args.params) as npz:
            state_dict = params_from_flax(dict(npz))

    recorder = flight.configure_from_env(host=0)
    metrics.configure(run_id=recorder.run_id)
    try:
        out, _ = serve(requests, config, state_dict=state_dict,
                       device=args.device, trace_dir=args.serve_trace_dir)
        out["metrics"] = metrics.get().aggregate()
        if recorder.enabled:
            out["flight_file"] = recorder.path
    except ValueError as e:   # a config or request this engine refuses
        p.error(str(e))
    finally:
        flight.reset()
        metrics.reset()
    if args.serve_out:
        with open(args.serve_out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=2, sort_keys=True)
    done = sum(1 for r in out["results"].values() if r["finished"])
    # The JAX launcher's line; one replica re-dispatches and restarts none.
    print(f"# launcher: serve drained — {done}/{len(out['results'])} "
          f"finished, 0 re-dispatched, 0 restart(s), leak check "
          f"{'ok' if out['leak_check_ok'] else 'FAILED'} "
          f"({out['window_s']:.1f}s)", flush=True)
    ok = out["leak_check_ok"] and all(
        r["finished"] for r in out["results"].values())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
