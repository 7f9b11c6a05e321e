"""Image-folder indexing and the host-to-card batch stream: the parts of
``distributeddeeplearning_tpu/data/imagenet.py`` that need no TensorFlow.

``folder_index`` lists a torchvision-style ``<split>/<wnid>/*.JPEG`` tree
and ``detect_layout`` tells it from TFRecord shards (``train-*``), whose
tf.data pipeline comes with a later slice. ``StreamSource`` adapts a
host-batch iterator (the native loader's, the token shards') to the loop's
``batch(step)`` protocol: a producer thread reads ``depth`` host batches
ahead into pinned memory; each is copied to the card with
``non_blocking=True`` on a side CUDA stream and cast there (images to the
compute dtype, ids and labels to int64), and the step's stream waits on
the copy's event, so the copy of step k + 1 overlaps step k. On the CPU
(the tests) the same class hands out plain tensors.
"""

from __future__ import annotations

import functools
import os
import queue
import sys
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

# ImageNet RGB statistics (the constants torchvision and tf-models use),
# which the native loader normalises with.
MEAN_RGB = (0.485 * 255, 0.456 * 255, 0.406 * 255)
STDDEV_RGB = (0.229 * 255, 0.224 * 255, 0.225 * 255)

TRAIN_SPLIT_SIZE = 1_281_167


@functools.lru_cache(maxsize=8)
def folder_index(data_dir: str,
                 split: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Index a torchvision-style ``<split>/<wnid>/*.JPEG`` tree.

    Class ids are assigned by sorted wnid, as torchvision's ``ImageFolder``
    does. Cached per (dir, split): a split's contents are fixed for the
    life of the process. Returns tuples, since every caller shares the
    cached entry.
    """
    root = os.path.join(data_dir, split)
    if not os.path.isdir(root):
        raise FileNotFoundError(f"no image-folder split at {root!r}")
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    paths, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith((".jpeg", ".jpg")):
                paths.append(os.path.join(cdir, fname))
                labels.append(idx)
    if not paths:
        raise FileNotFoundError(f"image-folder split {root!r} has no JPEGs")
    return tuple(paths), tuple(labels)


def detect_layout(data_dir: str) -> str:
    """'tfrecord' | 'folder' — by what is on disk."""
    import glob as globlib

    if globlib.glob(os.path.join(data_dir, "train-*")):
        return "tfrecord"
    if os.path.isdir(os.path.join(data_dir, "train")):
        return "folder"
    raise FileNotFoundError(
        f"{data_dir!r} contains neither train-* TFRecords nor a train/ "
        "image folder")


def _per_process_batch(config, process_count: int) -> int:
    if config.global_batch_size % process_count:
        raise ValueError(
            f"global_batch_size={config.global_batch_size} not divisible by "
            f"process_count={process_count}")
    return config.global_batch_size // process_count


def stream_guard_kwargs(config) -> dict:
    """``StreamSource`` watchdog kwargs of a config
    (``DataConfig.loader_timeout_s``/``loader_retries``); empty = off. The
    JAX package also plants loader stalls from its fault plans here, which
    come to the port with the robustness layer."""
    kw: dict = {}
    timeout_s = float(config.data.loader_timeout_s or 0.0)
    if timeout_s > 0:
        kw["timeout_s"] = timeout_s
        kw["max_retries"] = int(config.data.loader_retries)
    return kw


class _ProducerError:
    """Carrier moving a producer-thread exception to the consumer."""

    def __init__(self, err: BaseException):
        self.err = err


class StreamSource:
    """A host-batch iterator (dicts of numpy arrays, this rank's rows) as
    the loop's ``batch(step)``: the batches of steps ``first_step``,
    ``first_step + 1``, ... in that order, on ``device``, each tensor cast
    to ``casts[name]`` where given.

    With ``depth`` > 0 or a watchdog, a daemon thread reads host batches
    ahead into a queue of ``max(depth, 1)`` (pinned on a card); ``depth`` 0
    without a watchdog pulls on demand (short evals). An exception of the
    iterator reaches the consumer at the batch it would have made. With
    ``timeout_s`` > 0 a pull that waits longer is retried ``max_retries``
    times, then raises "data loader stalled". ``wait_s`` sums the seconds
    ``batch`` spent waiting for host batches. ``close`` stops the thread and
    calls ``on_close`` (the native loader's destroy).
    """

    _EXHAUSTED = object()

    def __init__(self, it: Iterator[dict], device, *, first_step: int = 0,
                 depth: int = 2, casts: Optional[dict] = None,
                 batches_hint: Optional[int] = None, timeout_s: float = 0.0,
                 max_retries: int = 2, on_close=None):
        self._it = it
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._casts = dict(casts or {})
        self._next_step = first_step
        self.batches_hint = batches_hint
        self._timeout_s = float(timeout_s)
        self._max_retries = max(int(max_retries), 0)
        self._on_close = on_close
        self.wait_s = 0.0
        self._stop = threading.Event()
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._next: Optional[tuple] = None   # (batch, event) copied ahead
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        if depth > 0 or self._timeout_s > 0:
            self._q = queue.Queue(maxsize=max(depth, 1))
            self._thread = threading.Thread(
                target=self._produce, name="ddl-loader", daemon=True)
            self._thread.start()

    # -- producer -----------------------------------------------------------

    def _host(self, item: dict) -> dict:
        out = {}
        for k, v in item.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory() if self._cuda else t
        return out

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for item in self._it:
                if not self._put(self._host(item)):
                    return
            self._put(self._EXHAUSTED)
        except BaseException as e:  # carried to the consumer, raised there
            self._put(_ProducerError(e))

    # -- consumer -----------------------------------------------------------

    def _pull(self, block: bool = True):
        """The next host batch, ``_EXHAUSTED`` or a ``_ProducerError``; None
        when not blocking and none is ready."""
        if self._q is None:
            try:
                return self._host(next(self._it))
            except StopIteration:
                return self._EXHAUSTED
        if block:
            return self._wait()
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None

    def _wait(self):
        if self._timeout_s <= 0:
            return self._q.get()
        attempts = self._max_retries + 1
        for attempt in range(attempts):
            try:
                return self._q.get(timeout=self._timeout_s)
            except queue.Empty:
                print(f"# data watchdog: no host batch within "
                      f"{self._timeout_s:.1f}s "
                      f"(attempt {attempt + 1}/{attempts})",
                      file=sys.stderr, flush=True)
        raise RuntimeError(
            f"data loader stalled: no host batch within {self._timeout_s:.1f}s"
            f" across {attempts} attempts — the input pipeline is hung or "
            "starved; restart the job")

    def _to_device(self, host):
        """``host`` on the device, cast: on a card copied on the side
        stream, as (batch, event); the markers pass through."""
        if host is self._EXHAUSTED or isinstance(host, _ProducerError):
            return host
        if not self._cuda:
            return {k: v.to(self._casts.get(k, v.dtype))
                    for k, v in host.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: v.to(self.device, non_blocking=True).to(
                self._casts.get(k, v.dtype)) for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def batch(self, step: int) -> dict:
        if step != self._next_step:
            raise ValueError(
                f"StreamSource consumed out of order: asked for step {step}, "
                f"expected {self._next_step} (resume must rebuild the source "
                "with first_step=start_step)")
        self._next_step += 1
        ready, self._next = self._next, None
        if ready is None:
            t0 = time.perf_counter()
            ready = self._to_device(self._pull())
            self.wait_s += time.perf_counter() - t0
        if isinstance(ready, _ProducerError):
            raise ready.err
        if ready is self._EXHAUSTED:
            raise StopIteration(f"data stream exhausted at step {step}")
        out, event = ready
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in out.values():
                t.record_stream(current)
        # Start the next batch's copy now when its host batch is ready, so
        # that it overlaps this step; never wait for one here.
        if self._q is not None:
            host = self._pull(block=False)
            if host is not None:
                self._next = self._to_device(host)
        return out

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop the producer thread, then release the iterator's resources
        (``on_close``). A producer still inside its iterator after
        ``timeout_s`` is left to end with the process (a daemon), and the
        iterator is not released under it."""
        self._stop.set()
        self._next = None
        if self._thread is not None:
            deadline = time.monotonic() + timeout_s
            while self._thread.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        self._q.get_nowait()
                except queue.Empty:
                    pass
                self._thread.join(0.05)
            if self._thread.is_alive():
                return
        if self._on_close is not None:
            self._on_close()
            self._on_close = None
