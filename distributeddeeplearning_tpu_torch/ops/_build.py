"""Build the port's CUDA sources with ``nvcc`` at first use and load them
with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface, so it compiles in
seconds without PyTorch's headers. The shared library lands in the git-ignored
``.cache/torch_kernels/`` of the checkout, keyed by a hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds and an unchanged one loads as is.
Nothing is built when a module is imported; a failed build raises. The port
runs from a checkout: the sources are read from, and built into, the tree
that holds this package, and an installed copy carries no ``csrc/*.cu``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
CACHE = Path(__file__).resolve().parents[2] / ".cache" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); the "
                           "port's kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: str) -> Path:
    """Where the build of ``csrc/<source>`` goes."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    key = digest.hexdigest()[:16]
    return CACHE / f"{src.stem}-{key}.so"


def build_log(library: Path) -> Path:
    """nvcc's output for ``library``: ptxas's registers, shared memory and
    spills of each kernel (``-Xptxas -v``)."""
    return library.with_suffix(".log")


def build(sources: Iterable[str]) -> dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each, all
    started together; returns ``{source: library path}``."""
    outs = {s: library_path(s) for s in sources}
    todo = {s: out for s, out in outs.items() if not out.exists()}
    if todo:
        nvcc = _nvcc()
        CACHE.mkdir(parents=True, exist_ok=True)
        procs = {}
        for s, out in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[s] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for s, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{s}:\n{log}")
            else:
                build_log(todo[s]).write_text(log)
                os.replace(tmp, todo[s])  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed."""
    return ctypes.CDLL(str(build([source])[source]))
