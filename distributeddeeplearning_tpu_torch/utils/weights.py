"""Carry weights between the JAX package's flax ``params`` and the port's
``state_dict``.

The port's modules are named after the flax tree, so the mapping is a
renaming plus one layout change:

- ``layer{i}`` (flax submodule) <-> ``layers.{i}`` (``nn.ModuleList``);
- Dense ``kernel`` (in, out) <-> ``nn.Linear`` ``weight`` (out, in);
- norm ``scale`` <-> ``weight``; ``bias`` and top-level tables (``wte``,
  ``wpe``, ``embed_tokens``) keep their names and layout.

A flax params file is read as numpy arrays (``np.load`` of an ``.npz``
written with ``/``-joined paths); no flax or orbax is needed.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_FLAX_LAYER = re.compile(r"^layer(\d+)$")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def params_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a flax ``params`` collection.

    ``tree``: a nested dict of arrays, or a flat dict of ``/``-joined paths
    as ``np.savez`` stores them; a leading ``params`` level is accepted.
    Returns float32 CPU tensors; ``load_state_dict`` casts and places them.
    """
    flat = _flatten(tree)
    state = {}
    for path, value in flat.items():
        parts = path.split("/")
        if parts[0] == "params" and len(parts) > 1:
            parts = parts[1:]
        *mods, leaf = parts
        names = []
        for m in mods:
            hit = _FLAX_LAYER.match(m)
            names += ["layers", hit.group(1)] if hit else [m]
        arr = np.asarray(value, dtype=np.float32)
        if mods and leaf == "kernel":
            leaf, arr = "weight", arr.T
        elif mods and leaf == "scale":
            leaf = "weight"
        # A copy: arrays read from JAX or np.load may be read-only.
        state[".".join(names + [leaf])] = torch.tensor(arr)
    return state


def flax_leaf(key: str, ndim: int) -> str:
    """The flax leaf name of ``state_dict`` entry ``key`` of rank ``ndim``:
    a submodule's 2-D ``weight`` is a Dense ``kernel``, its 1-D one a norm
    ``scale``; every other leaf keeps its name."""
    *mods, leaf = key.split(".")
    if mods and leaf == "weight":
        return "kernel" if ndim == 2 else "scale"
    return leaf


def params_to_flax(state_dict: Mapping[str, torch.Tensor]
                   ) -> dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flax`: a flat ``/``-joined flax
    params dict of float32 numpy arrays, ready for ``np.savez``."""
    flat = {}
    for key, tensor in state_dict.items():
        mods = key.split(".")[:-1]
        names, i = [], 0
        while i < len(mods):
            if mods[i] == "layers" and i + 1 < len(mods):
                names.append(f"layer{mods[i + 1]}")
                i += 2
            else:
                names.append(mods[i])
                i += 1
        arr = tensor.detach().float().cpu().numpy()
        leaf = flax_leaf(key, arr.ndim)
        if leaf == "kernel":
            arr = arr.T
        flat["/".join(names + [leaf])] = np.ascontiguousarray(arr)
    return flat
