"""Checkpoints of the train state (model, optimizer, step and update count,
EMA, loss scale): ``torch.save`` every N steps and at the end of a run,
resume from the newest, or restore it for evaluation only.

The JAX package writes orbax checkpoints; reading those needs JAX and comes
with a later slice. A checkpoint here is one file, ``step_<n>.pt``, written
to a temporary name and renamed, so a crash never leaves a torn newest
file. ``stream_meta.json`` beside them pins the data loader the run
resolved, as the JAX checkpointer's does.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


class Checkpointer:
    def __init__(self, directory: str, every_steps: int):
        self.dir = Path(directory)
        self.every = every_steps

    def steps(self) -> list[int]:
        if not self.dir.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.dir.iterdir()
                      if (m := _NAME.match(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState) -> Path:
        self.dir.mkdir(parents=True, exist_ok=True)
        path = self.dir / f"step_{state.step}.pt"
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)
        return path

    def due(self, step: int, *, force: bool = False) -> bool:
        """Whether a checkpoint is written after ``step``: every
        ``every_steps``-th step, or when forced."""
        return force or (self.every > 0 and step % self.every == 0)

    def _load_latest(self, state: TrainState) -> Optional[dict]:
        step = self.latest_step()
        if step is None:
            return None
        device = next(state.model.parameters()).device
        return torch.load(self.dir / f"step_{step}.pt", map_location=device,
                          weights_only=True)

    def restore(self, state: TrainState) -> bool:
        """Load the newest checkpoint into ``state`` (model, optimizer,
        update count, EMA, loss scale); False when none."""
        saved = self._load_latest(state)
        if saved is None:
            return False
        state.load_state_dict(saved)
        return True

    def verify_or_record_stream_meta(self, meta: dict, dp=None) -> dict:
        """Pin data-stream facts (the resolved loader) to the directory:
        the first run records ``meta``; a later run that resolved another
        value fails loudly instead of resuming on another sample stream.
        Under ``dp`` the ranks must agree, and only rank 0 writes. Returns
        what was recorded before."""
        if dp is not None:
            everyone: list = [None] * dp.world
            torch.distributed.all_gather_object(everyone, meta)
            if any(m != meta for m in everyone):
                raise RuntimeError(
                    f"data-stream metadata differs across ranks: "
                    f"{everyone!r}. Set the pipeline explicitly (e.g. "
                    f"--loader) so every rank resolves alike")
        path = self.dir / "stream_meta.json"
        recorded = json.loads(path.read_text()) if path.exists() else {}
        clashes = {k: (recorded[k], v) for k, v in meta.items()
                   if k in recorded and recorded[k] != v}
        if clashes:
            raise RuntimeError(
                f"checkpoint stream metadata mismatch in {path}: "
                + "; ".join(f"{k}: recorded {old!r}, this run resolved "
                            f"{new!r}" for k, (old, new) in clashes.items())
                + ". Resuming with a different data pipeline would change "
                "the post-resume sample stream. Set the field explicitly "
                "(e.g. --loader) to match the original run, or start a "
                "fresh checkpoint_dir.")
        if dp is not None:
            dp.barrier()   # every rank has read before rank 0 writes
        if (dp is None or dp.rank == 0) and any(
                recorded.get(k) != v for k, v in meta.items()):
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            tmp.write_text(json.dumps(dict(recorded, **meta)))
            os.replace(tmp, path)
        return recorded

    def restore_for_eval(self, state: TrainState) -> bool:
        """Load what evaluation needs from the newest checkpoint: the
        model's parameters and buffers, the step, and the EMA as the
        checkpoint has it (kept or not, whatever this run's flag says); the
        optimizer stays fresh. False when there is none."""
        saved = self._load_latest(state)
        if saved is None:
            return False
        state.step = int(saved["step"])
        state.model.load_state_dict(saved["model"])
        ema = saved.get("ema")
        state.ema = (None if ema is None else
                     {k: v.float() for k, v in ema.items()})
        return True
