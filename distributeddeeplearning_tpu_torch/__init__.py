"""PyTorch/CUDA port of ``distributeddeeplearning_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package keeps its module names so
each counterpart is easy to find. Every Pallas kernel on a ported path is a
hand-written CUDA kernel here (``csrc/``), built with ``nvcc`` at first use
(``ops/_build.py``), with a plain PyTorch version beside it that runs only on
CPU tensors.

Entry points run on ``cuda``; the CPU is used only when the caller asks for
it (``device="cpu"``), as the tests do.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, ``cpu`` only
    when asked for. Raises when no card is present and the CPU was not
    requested, instead of silently running the plain versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r}: the port runs on "
                         f"'cuda', or on 'cpu' when asked for explicitly")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU. Pass "
            "device='cpu' (--device cpu) to run the plain PyTorch versions "
            "on the CPU")
    return dev
