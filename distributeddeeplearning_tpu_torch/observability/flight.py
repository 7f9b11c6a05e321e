"""Flight recorder: a crash-surviving, append-only structured event log.

The port's own copy of ``distributeddeeplearning_tpu/observability/
flight.py`` (pure stdlib), with the same file layout and environment
variables. The telemetry ring buffer (``telemetry.py``) reaches disk only
when it is exported; the flight recorder is the other half of the trade:
a sparse JSONL log whose every line is flushed and fsync'd when it is
recorded, so the record survives any way the process can die. Each writer
appends to its own file in a shared directory:

    <flight_dir>/flight.p0.jsonl        host 0
    <flight_dir>/flight.launcher.jsonl  a launcher

Every event carries one identity scheme so records from several hosts and
restart attempts merge into one timeline:

    run      run id (DDL_RUN_ID, else minted); constant across attempts
    attempt  restart attempt (DDL_RESTART_ATTEMPT, 0 by default)
    host     process index (DDL_PROCESS_ID) or a label
    seq      per-writer sequence number (tie-break, torn-tail detection)
    t        wall-clock seconds
    mono     CLOCK_MONOTONIC seconds, the clock of telemetry.now_s()

Files are size-bounded: past ``max_bytes`` the segment rotates to
``<name>.1`` (one previous segment kept). The recorder is off unless a
directory is given (``configure``) or ``DDL_FLIGHT_DIR`` is set
(``configure_from_env``). Recording never raises: a full disk must not
stop serving. The serve engine records its lifecycle events here
(``serve_admit``, ``serve_prefill``, ``serve_first_token``,
``serve_retire``, ``serve_preempt``, ``serve_deadline_miss``,
``serve_shed``, ``serve_cow_copy``, ``serve_shutdown``).
"""
from __future__ import annotations

import glob
import json
import os
import threading
import time
from typing import Any, Optional

ENV_FLIGHT_DIR = "DDL_FLIGHT_DIR"
ENV_RUN_ID = "DDL_RUN_ID"
# Shared with health.py / faults.py (redeclared to stay import-light).
_ENV_PROCESS_ID = "DDL_PROCESS_ID"
_ENV_ATTEMPT = "DDL_RESTART_ATTEMPT"

DEFAULT_MAX_BYTES = 4 * 1024 * 1024

def mint_run_id(now: Optional[float] = None) -> str:
    """A sortable, collision-safe run id: wall time + random suffix."""
    now = time.time() if now is None else now
    stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
    return f"run-{stamp}-{os.urandom(3).hex()}"


def flight_path(directory: str, host: Any) -> str:
    """``flight.p{N}.jsonl`` for rank N; ``flight.{label}.jsonl`` else."""
    label = f"p{host}" if isinstance(host, int) else str(host)
    return os.path.join(directory, f"flight.{label}.jsonl")


class FlightRecorder:
    """Append-only fsync'd JSONL writer for one host.

    ``directory=None`` builds a disabled recorder: ``record()`` is a
    cheap no-op, so call sites never branch.
    """

    def __init__(self, directory: Optional[str], *,
                 run_id: Optional[str] = None,
                 host: Any = 0,
                 attempt: int = 0,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 fsync: bool = True):
        self.enabled = directory is not None
        self.directory = directory
        self.run_id = run_id or mint_run_id()
        self.host = host
        self.attempt = int(attempt)
        self.max_bytes = int(max_bytes)
        self._fsync = bool(fsync)
        self._seq = 0
        self._lock = threading.Lock()
        self._fh = None
        if self.enabled:
            try:
                os.makedirs(directory, exist_ok=True)
                self.path = flight_path(directory, host)
            except OSError:
                self.enabled = False
                self.path = None
        else:
            self.path = None

    @classmethod
    def from_env(cls, *, host: Any = None,
                 directory: Optional[str] = None) -> "FlightRecorder":
        """Build from the launcher-exported environment.

        ``directory`` (e.g. from ``--flight-dir``) overrides
        ``$DDL_FLIGHT_DIR``; with neither set the recorder is disabled.
        The run id comes from ``$DDL_RUN_ID`` when a launcher minted one.
        """
        directory = directory or os.environ.get(ENV_FLIGHT_DIR)
        if host is None:
            try:
                host = int(os.environ.get(_ENV_PROCESS_ID, "0"))
            except ValueError:
                host = 0
        try:
            attempt = int(os.environ.get(_ENV_ATTEMPT, "0"))
        except ValueError:
            attempt = 0
        return cls(directory, run_id=os.environ.get(ENV_RUN_ID),
                   host=host, attempt=attempt)

    # -- writing ---------------------------------------------------------

    def record(self, ev: str, **fields: Any) -> None:
        """Append one event and force it to disk. Never raises."""
        if not self.enabled:
            return
        try:
            with self._lock:
                self._seq += 1
                entry = {"ev": ev, "t": time.time(),
                         "mono": time.monotonic(),
                         "run": self.run_id, "attempt": self.attempt,
                         "host": self.host, "seq": self._seq}
                entry.update(fields)
                line = json.dumps(entry, sort_keys=True,
                                  default=_json_fallback) + "\n"
                fh = self._open_locked()
                fh.write(line)
                fh.flush()
                if self._fsync:
                    os.fsync(fh.fileno())
                if fh.tell() >= self.max_bytes:
                    self._rotate_locked()
        except Exception:  # noqa: BLE001 — recording must never kill a run
            pass

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    def _open_locked(self):
        if self._fh is None or self._fh.closed:
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def _rotate_locked(self) -> None:
        """Ring semantics: keep one previous segment, start a fresh one."""
        try:
            self._fh.close()
        except OSError:
            pass
        self._fh = None
        os.replace(self.path, self.path + ".1")


def _json_fallback(obj: Any) -> Any:
    try:
        return float(obj)
    except (TypeError, ValueError):
        return repr(obj)


# -- module singleton (telemetry-style) ----------------------------------

_active = FlightRecorder(None)


def get() -> FlightRecorder:
    return _active


def configure(directory: Optional[str], **kw: Any) -> FlightRecorder:
    global _active
    _active.close()
    _active = FlightRecorder(directory, **kw)
    return _active


def configure_from_env(*, host: Any = None,
                       directory: Optional[str] = None) -> FlightRecorder:
    global _active
    _active.close()
    _active = FlightRecorder.from_env(host=host, directory=directory)
    return _active


def reset() -> None:
    configure(None)


# -- reading -------------------------------------------------------------

def read_file(path: str) -> tuple[list[dict], Optional[str]]:
    """Parse one flight file tolerantly.

    A writer killed mid-line (the whole point of the recorder is that
    writers get killed) leaves at most one torn tail line; it is skipped
    and reported, everything before it is salvaged. Returns
    ``(events, error)`` with ``error=None`` when the file parsed whole.
    """
    events: list[dict] = []
    error = None
    try:
        with open(path, encoding="utf-8", errors="replace") as fh:
            for n, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    obj = json.loads(line)
                except ValueError:
                    error = f"{os.path.basename(path)}:{n}: unparseable line"
                    continue
                if isinstance(obj, dict):
                    obj["_file"] = os.path.basename(path)
                    events.append(obj)
    except OSError as exc:
        return [], f"{path}: {exc}"
    return events, error


def read_all(directory: str) -> tuple[list[dict], list[str]]:
    """All events from every flight file (rotated segments included),
    sorted into one timeline by ``(t, seq)``."""
    events: list[dict] = []
    errors: list[str] = []
    paths = sorted(glob.glob(os.path.join(directory, "flight.*.jsonl.1"))) + \
        sorted(glob.glob(os.path.join(directory, "flight.*.jsonl")))
    for path in paths:
        evs, err = read_file(path)
        events.extend(evs)
        if err:
            errors.append(err)
    events.sort(key=lambda e: (e.get("t", 0.0), e.get("seq", 0)))
    return events, errors

