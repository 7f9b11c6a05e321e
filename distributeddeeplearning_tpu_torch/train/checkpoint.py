"""Checkpoints of the train state: ``torch.save`` every N steps and at the
end of a run, resume from the newest.

The JAX package writes orbax checkpoints; reading those needs JAX and comes
with a later slice. A checkpoint here is one file, ``step_<n>.pt``, written
to a temporary name and renamed, so a crash never leaves a torn newest
file.
"""

from __future__ import annotations

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

    def maybe_save(self, state: TrainState, *, force: bool = False
                   ) -> Optional[Path]:
        """Save at every ``every_steps``-th step, or when forced."""
        if force or (self.every > 0 and state.step % self.every == 0):
            return self.save(state)
        return None

    def restore(self, state: TrainState) -> bool:
        """Load the newest checkpoint into ``state``; False when none."""
        step = self.latest_step()
        if step is None:
            return False
        device = next(state.model.parameters()).device
        state.load_state_dict(torch.load(self.dir / f"step_{step}.pt",
                                         map_location=device,
                                         weights_only=True))
        return True
