"""The port's one-replica serving entry point (``python -m distributeddeep
learning_tpu_torch.serve``, serve/cli.py) on the CPU.

A requests file and a config file in the JAX launcher's formats, weights
from a flax-layout ``.npz``: every request's greedy tokens must equal JAX
``generate(use_cache=True)`` of that request alone, for both families; the
results file holds each uid's tokens, state, TTFT and inter-token gaps and
the leak check; arrivals are admitted when their time has come; the exit
code is 0 only for a clean drain; with ``DDL_FLIGHT_DIR`` set the run's
lifecycle events reach the flight recorder, and the results file sums up
the engine's gauges. The supervisor's flags (several replicas, autoscale)
and a drafter of a later slice are refused, naming their slice.
"""

import collections
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import generate as jgen
from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu_torch.serve import cli
from distributeddeeplearning_tpu_torch.serve.engine import Engine, ServeConfig
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.torch_port_helpers import flat_params, tiny_lm_params
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from tests.torch_serve_helpers import VOCAB, fake_clock, prompts

REPO = Path(__file__).resolve().parents[1]
CONFIG = dict(vocab_size=VOCAB, max_slots=2, page_size=4, num_pages=32,
              max_pages_per_slot=8, prefill_buckets=[8, 16],
              compile_cache_dir="off")
JAX_BUILD = {"gpt": jgpt.tiny_gpt, "llama": jllama.tiny_llama}
MAX_NEW = (5, 3, 6, 4, 2)


def _requests():
    # Equal prompt lengths: JAX generate runs them as one batch.
    return [{"prompt": p, "max_new_tokens": m, "tenant": t,
             "arrival_s": a}
            for p, m, t, a in zip(prompts(9, [6] * 5), MAX_NEW,
                                  ("rt", "bg", "rt", "default", "bg"),
                                  (0.0, 0.0, 0.001, 0.0, 0.002))]


def _argv(tmp_path, family, requests, **config):
    npz = tmp_path / "params.npz"
    np.savez(npz, **flat_params(tiny_lm_params(family, VOCAB)))
    (tmp_path / "requests.json").write_text(json.dumps(requests))
    (tmp_path / "config.json").write_text(json.dumps(
        {**CONFIG, "model": f"{family}_tiny", **config}))
    return ["--serve", str(tmp_path / "requests.json"), "--serve-config",
            str(tmp_path / "config.json"), "--params", str(npz),
            "--serve-out", str(tmp_path / "out.json")]


@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_cli_tokens_equal_jax_generate(tmp_path, capsys, family):
    requests = _requests()
    rc = cli.main(_argv(tmp_path, family, requests) + ["--device", "cpu"])
    assert rc == 0
    drained = capsys.readouterr().out.strip().splitlines()[-1]
    assert "serve drained — 5/5 finished" in drained
    assert "leak check ok" in drained
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["leak_check_ok"] is True and out["device"] == "cpu"
    assert sorted(out["results"]) == ["0", "1", "2", "3", "4"]
    ref = np.asarray(jgen.generate(
        JAX_BUILD[family](vocab_size=VOCAB),
        {"params": tiny_lm_params(family, VOCAB)},
        jnp.asarray([r["prompt"] for r in requests], jnp.int32),
        max_new_tokens=max(MAX_NEW), use_cache=True))[:, 6:]
    for uid, (req, row) in enumerate(zip(requests, ref)):
        res = out["results"][str(uid)]
        # Greedy: a shorter run is a prefix of a longer one.
        assert res["tokens"] == row[:req["max_new_tokens"]].tolist(), uid
        assert res["finished"] and res["failed"] is None
        assert res["ttft_s"] >= 0
        assert len(res["itl_s"]) == req["max_new_tokens"] - 1
    assert out["tokens_emitted"] == sum(MAX_NEW)
    assert out["counters"]["steps"] >= max(MAX_NEW) - 1
    assert 0 < out["max_page_occupancy"] <= 1
    assert set(out["warmup_s"]) == {"prefill_8", "prefill_16", "decode"}


def test_arrivals_wait_for_their_time():
    """On a fake clock: the engine drains the first requests, then sleeps
    until the last one arrives, and counts its TTFT from its arrival."""
    clock = fake_clock()

    def sleep(seconds):
        clock.t[0] += seconds

    reqs = [{"prompt": [1, 2, 3], "max_new_tokens": 2, "arrival_s": a}
            for a in (0.0, 0.0, 5.0)]
    out, engine = cli.serve(
        reqs, ServeConfig(**{**CONFIG, "prefill_buckets": (8,)}),
        device="cpu", clock=clock, sleep=sleep)
    late = out["results"]["2"]
    assert late["finished"] and out["window_s"] > 5.0
    assert 0 < late["ttft_s"] < 0.1
    assert engine.finished[-1].arrival_s > 5.0


@pytest.mark.parametrize("extra,match", [
    (["--num-processes", "2"], "replica supervisor"),
    (["--serve-autoscale", "1:2"], "replica supervisor"),
    (["--config-spec"], "speculative decoding .* later slice"),
    (["--empty"], "non-empty JSON list")])
def test_cli_refusals(tmp_path, capsys, extra, match):
    requests = [] if extra == ["--empty"] else _requests()
    # --config-spec held a gpt_nano drafter until the engine carried it; a
    # drafter of a later slice's registry entry keeps the case's ID.
    config = ({"spec_draft_model": "gpt_tiny_pp", "spec_k": 2}
              if extra == ["--config-spec"] else {})
    argv = _argv(tmp_path, "gpt", requests, **config) + ["--device", "cpu"]
    if extra[0] not in ("--empty", "--config-spec"):
        argv += extra
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == 2
    assert re.search(match, capsys.readouterr().err)


def test_cli_exits_1_when_the_leak_check_fails(tmp_path, capsys,
                                               monkeypatch):
    def leak(self):
        raise RuntimeError("KV page leak: injected")

    monkeypatch.setattr(Engine, "shutdown", leak)
    rc = cli.main(_argv(tmp_path, "gpt", _requests()[:2])
                  + ["--device", "cpu"])
    assert rc == 1
    assert "leak check FAILED" in capsys.readouterr().out
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["leak_check_ok"] is False
    assert all(r["finished"] for r in out["results"].values())


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_argv(tmp_path, "gpt", _requests()[:1]))


def test_module_entry_point(tmp_path):
    """``python -m distributeddeeplearning_tpu_torch.serve`` in a process
    of its own; its tokens equal the in-process engine's."""
    argv = _argv(tmp_path, "gpt", _requests()[:3]) + ["--device", "cpu"]
    proc = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.serve",
         *argv], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith(
        "# launcher: serve drained — 3/3 finished")
    out = json.loads((tmp_path / "out.json").read_text())
    engine = Engine(ServeConfig.from_dict(
        json.loads((tmp_path / "config.json").read_text())),
        state_dict=params_from_flax(flat_params(tiny_lm_params("gpt",
                                                               VOCAB))),
        device="cpu")
    reqs = [engine.submit(r["prompt"], max_new_tokens=r["max_new_tokens"])
            for r in _requests()[:3]]
    engine.run_until_idle()
    assert [out["results"][str(i)]["tokens"] for i in range(3)] == [
        r.tokens for r in reqs]


def test_cli_records_flight_events_and_gauges(tmp_path, monkeypatch):
    """With ``DDL_FLIGHT_DIR`` set, the entry point appends the engine's
    lifecycle events to ``flight.p0.jsonl`` under ``DDL_RUN_ID``; the
    results file sums up the engine's gauges, one TTFT sample a request;
    both singletons are off again after the run."""
    from distributeddeeplearning_tpu_torch.observability import (
        flight, metrics)

    flight_dir = tmp_path / "flight"
    monkeypatch.setenv("DDL_FLIGHT_DIR", str(flight_dir))
    monkeypatch.setenv("DDL_RUN_ID", "run-cli")
    requests = _requests()[:3]
    assert cli.main(_argv(tmp_path, "gpt", requests)
                    + ["--device", "cpu"]) == 0
    out = json.loads((tmp_path / "out.json").read_text())
    assert out["flight_file"] == str(flight_dir / "flight.p0.jsonl")
    events, errors = flight.read_all(str(flight_dir))
    assert errors == [] and {e["run"] for e in events} == {"run-cli"}
    kinds = collections.Counter(e["ev"] for e in events)
    for ev in ("serve_admit", "serve_prefill", "serve_first_token",
               "serve_retire"):
        assert kinds[ev] == len(requests), ev
    assert kinds["serve_shutdown"] == 1
    gauges = out["metrics"]["metrics"]
    assert out["metrics"]["run"] == "run-cli"
    assert gauges["serve_ttft_s"]["samples"] == len(requests)
    assert sorted(gauges["serve_ttft_s"]["series_tail"][i][1]
                  for i in range(len(requests))) == sorted(
        r["ttft_s"] for r in out["results"].values())
    assert gauges["serve_live_slots"]["max"] <= CONFIG["max_slots"]
    assert not flight.get().enabled and metrics.get().aggregate()[
        "metrics"] == {}
