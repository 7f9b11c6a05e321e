"""ctypes bindings to the C++ image-folder loader, ``csrc/ddl_loader.cc``
(ABI 1), and the rank's ``StreamSource`` over it: the counterpart of
``distributeddeeplearning_tpu/data/native.py``.

The C++ thread pool reads the rank's JPEGs, decodes them with libjpeg,
applies the ResNet recipe (random-resized crop and flip for training,
resize and center crop for eval, per-channel normalisation) and assembles
float32 NHWC batches in a ring of batch slots; the stream is a pure
function of (seed, batch index), so training resumes at any batch.

The library is built with ``g++`` at first use into the git-ignored
``.cache/torch_kernels/`` of the checkout, beside the CUDA kernels, keyed
by a hash of the source and the flags. A failed build raises; there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from distributeddeeplearning_tpu_torch.data import imagenet
from distributeddeeplearning_tpu_torch.ops._build import CACHE

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "ddl_loader.cc"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ERR: Optional[str] = None


def library_path() -> Path:
    """Where the build of ``csrc/ddl_loader.cc`` goes."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LIBS).encode())
    return CACHE / f"ddl_loader-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless its library exists: to a per-process
    temporary name, then renamed, so a torn build is never loaded and
    concurrent builds each install a whole library."""
    out = library_path()
    if out.exists():
        return out
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
            capture_output=True, text=True, timeout=300)
        if proc.returncode:
            raise RuntimeError(f"native loader build failed:\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _load() -> ctypes.CDLL:
    global _LIB, _ERR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _ERR is not None:
            raise RuntimeError(_ERR)
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _ERR = f"native loader unavailable: {e}"
            raise RuntimeError(_ERR) from e
        lib.ddl_loader_create.restype = ctypes.c_void_p
        lib.ddl_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),                 # paths
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,  # labels, n
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # batch,size,train
            ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,  # seed,thr,depth
            ctypes.c_int64, ctypes.c_int32,                   # start,repeat
            ctypes.POINTER(ctypes.c_float),                   # mean
            ctypes.POINTER(ctypes.c_float),                   # stdev
        ]
        lib.ddl_loader_next.restype = ctypes.c_int64
        lib.ddl_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32)]
        lib.ddl_loader_destroy.restype = None
        lib.ddl_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.ddl_loader_abi_version.restype = ctypes.c_int32
        lib.ddl_loader_abi_version.argtypes = []
        if lib.ddl_loader_abi_version() != 1:
            _ERR = (f"native loader unavailable: ABI "
                    f"{lib.ddl_loader_abi_version()}, expected 1")
            raise RuntimeError(_ERR)
        _LIB = lib
        return lib


def available() -> bool:
    """True when the loader can be (or has been) built and loaded."""
    try:
        _load()
        return True
    except RuntimeError:
        return False


def unavailable_reason() -> Optional[str]:
    """Why ``available()`` is false, or None."""
    return None if available() else _ERR


class NativeImageLoader:
    """Iterator over (image, label) host batches from the C++ loader:
    ``{"image": (B, S, S, 3) float32, normalised, "label": (B,) int32}``,
    deterministic in (seed, batch index) and resumable at ``start_batch``;
    endless when training, one pass over the files in order for eval.
    """

    def __init__(self, paths, labels, *, batch_size: int, image_size: int,
                 train: bool, seed: int, num_threads: Optional[int] = None,
                 queue_depth: int = 3, start_batch: int = 0):
        lib = _load()
        n = len(paths)
        if n != len(labels):
            raise ValueError(
                f"paths/labels length mismatch: {n} vs {len(labels)}")
        if n < batch_size:
            raise ValueError(
                f"native loader needs at least one full batch: have {n} "
                f"samples but batch_size={batch_size}. With multi-process "
                f"sharding a small split can shrink below the per-process "
                f"batch — lower the batch size.")
        self._lib = lib
        self._batch = batch_size
        self._size = image_size
        self.batches_per_epoch = n // batch_size
        c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        c_labels = (ctypes.c_int32 * n)(*labels)
        c_mean = (ctypes.c_float * 3)(*np.float32(imagenet.MEAN_RGB))
        c_std = (ctypes.c_float * 3)(*np.float32(imagenet.STDDEV_RGB))
        if num_threads is None:
            num_threads = min(max((os.cpu_count() or 4) - 1, 2), 16)
        self._handle = lib.ddl_loader_create(
            c_paths, c_labels, n, batch_size, image_size, int(train),
            seed, num_threads, queue_depth, start_batch, int(train),
            c_mean, c_std)
        if not self._handle:
            raise RuntimeError("ddl_loader_create failed (bad arguments?)")

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        images = np.empty((self._batch, self._size, self._size, 3),
                          np.float32)
        labels = np.empty((self._batch,), np.int32)
        idx = self._lib.ddl_loader_next(
            self._handle,
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if idx < 0:
            raise StopIteration
        return {"image": images, "label": labels}

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.ddl_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def make_native_source(config, device, *, rank: int = 0, world: int = 1,
                       train: bool = True, start_step: int = 0,
                       casts: Optional[dict] = None):
    """The rank's ``StreamSource`` over the loader for an image folder: the
    rank reads ``paths[rank::world]`` in batches of the global batch over
    ``world``, from batch ``start_step`` when training."""
    from distributeddeeplearning_tpu_torch import data as datalib

    d = config.data
    paths, labels = imagenet.folder_index(d.data_dir,
                                          "train" if train else "val")
    paths, labels = paths[rank::world], labels[rank::world]
    per_rank = imagenet._per_process_batch(config, world)
    depth = datalib.effective_prefetch_depth(config)
    loader = NativeImageLoader(
        paths, labels, batch_size=per_rank, image_size=d.image_size,
        train=train, seed=config.seed,
        start_batch=start_step if train else 0,
        queue_depth=max(depth + 1, 2))
    return imagenet.StreamSource(
        loader, device, first_step=start_step, depth=depth, casts=casts,
        batches_hint=None if train else len(paths) // per_rank,
        on_close=loader.close,
        **imagenet.stream_guard_kwargs(config))
