"""The process group a data-parallel run trains in.

``torchrun`` (``python -m torch.distributed.run --nproc-per-node N``)
starts one process a rank and sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``. A run started so
joins the group: NCCL with the card ``cuda:LOCAL_RANK`` when it runs on
the GPU, gloo when ``--device cpu`` is given. There is no fallback: if
NCCL fails to initialise on a card the run fails. A caller that has
already initialised the default group (the tests, with a ``file://``
rendezvous) keeps it. A run started without ``torchrun`` has no group and
trains on one card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist


def launch_world() -> Optional[int]:
    """The world size of this run's process group: the initialised default
    group's, else ``torchrun``'s ``WORLD_SIZE``; None when the run has no
    group (started without ``torchrun``)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    world = os.environ.get("WORLD_SIZE")
    return int(world) if world else None


@dataclasses.dataclass
class DataParallel:
    """This rank's place in the default group: ``rank`` of ``world``, and
    whether this run initialised the group (and so destroys it)."""

    rank: int
    world: int
    owned: bool = False

    def shard(self, batch: dict) -> dict:
        """Rows ``[rank * B / world, (rank + 1) * B / world)`` of each
        tensor of the global ``batch``: JAX's sharding of the global batch
        over the ``data`` axis. Only a synthetic source makes the whole
        global batch (``data.RankRows``); a streamed one reads the rank's
        rows alone."""
        out = {}
        for key, value in batch.items():
            rows = value.shape[0] // self.world
            out[key] = value[self.rank * rows:(self.rank + 1) * rows]
        return out

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        if self.owned and dist.is_initialized():
            dist.destroy_process_group()
            self.owned = False


def join(device: torch.device) -> tuple[Optional[DataParallel],
                                        torch.device]:
    """(this rank's ``DataParallel``, its device), or (None, ``device``)
    for a run with no group. Initialises the default group from
    ``torchrun``'s environment when it is not initialised yet: NCCL on
    ``cuda:LOCAL_RANK`` for a CUDA ``device``, gloo for the CPU."""
    if dist.is_available() and dist.is_initialized():
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return DataParallel(dist.get_rank(), dist.get_world_size()), device
    if not os.environ.get("WORLD_SIZE"):
        return None, device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://")
    else:
        dist.init_process_group("gloo", init_method="env://")
    return DataParallel(dist.get_rank(), dist.get_world_size(),
                        owned=True), device
