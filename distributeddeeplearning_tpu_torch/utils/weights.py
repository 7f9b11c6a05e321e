"""Carry weights between the JAX package's flax variables (``params`` and
``batch_stats``) and the port's ``state_dict``.

The port's modules are named after the flax tree, so the mapping is a
renaming plus a layout change:

- ``layer{i}`` (flax submodule) <-> ``layers.{i}`` and ``block{i}`` <->
  ``blocks.{i}`` (``nn.ModuleList``s: the LMs' layers, ViT's blocks);
- Dense ``kernel`` (in, out) <-> 2-D ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) <-> 4-D ``weight`` (out, in, kh, kw),
  ``permute(3, 2, 0, 1)`` one way and ``permute(2, 3, 1, 0)`` the other;
- norm ``scale`` <-> 1-D ``weight``; ``bias`` and the top-level leaves
  (the tables ``wte``, ``wpe``, ``embed_tokens``, ``word_embeddings``,
  ``position_embeddings``, ``type_embeddings``, ViT's ``cls_token`` and
  ``pos_embedding``, BERT's ``mlm_bias``) keep their names and layout;
- ``batch_stats`` ``mean``/``var`` <-> the BatchNorm buffers
  ``running_mean``/``running_var``.

A flax file is read as numpy arrays (``np.load`` of an ``.npz`` written
with ``/``-joined paths); no flax or orbax is needed.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

# flax submodule prefix <-> ModuleList name.
_LISTS = {"layer": "layers", "block": "blocks"}
_FLAX_LIST = re.compile(r"^(layer|block)(\d+)$")
_LIST_PREFIX = {v: k for k, v in _LISTS.items()}
# batch_stats leaf <-> BatchNorm buffer.
_STATS = {"mean": "running_mean", "var": "running_var"}
_BUFFERS = {v: k for k, v in _STATS.items()}
# (kh, kw, in, out) -> (out, in, kh, kw), and back.
_CONV_TO_TORCH, _CONV_TO_FLAX = (3, 2, 0, 1), (2, 3, 1, 0)


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
    """The port's ``state_dict`` from flax variables.

    ``tree``: a nested dict of arrays, or a flat dict of ``/``-joined paths
    as ``np.savez`` stores them. Paths under a leading ``batch_stats`` level
    become BatchNorm buffers; a leading ``params`` level is accepted, and
    paths without either are params. Returns float32 CPU tensors;
    ``load_state_dict`` casts and places them.
    """
    flat = _flatten(tree)
    state = {}
    for path, value in flat.items():
        parts = path.split("/")
        stats = parts[0] == "batch_stats" and len(parts) > 1
        if parts[0] in ("params", "batch_stats") and len(parts) > 1:
            parts = parts[1:]
        *mods, leaf = parts
        names = []
        for m in mods:
            hit = _FLAX_LIST.match(m)
            names += [_LISTS[hit.group(1)], hit.group(2)] if hit else [m]
        arr = np.asarray(value, dtype=np.float32)
        if stats:
            leaf = _STATS[leaf]
        elif mods and leaf == "kernel":
            leaf = "weight"
            arr = arr.transpose(_CONV_TO_TORCH) if arr.ndim == 4 else arr.T
        elif mods and leaf == "scale":
            leaf = "weight"
        # A copy: arrays read from JAX or np.load may be read-only.
        state[".".join(names + [leaf])] = torch.tensor(arr)
    return state


def flax_leaf(key: str, ndim: int) -> str:
    """The flax leaf name of ``state_dict`` entry ``key`` of rank ``ndim``:
    a submodule's 2-D (Dense) or 4-D (Conv) ``weight`` is a ``kernel``, its
    1-D one a norm ``scale``; the BatchNorm buffers are the batch_stats
    ``mean``/``var``; every other leaf keeps its name."""
    *mods, leaf = key.split(".")
    if mods and leaf == "weight":
        return "scale" if ndim == 1 else "kernel"
    return _BUFFERS.get(leaf, leaf)


def _flax_paths(state_dict: Mapping[str, torch.Tensor],
                buffers: bool) -> dict[str, np.ndarray]:
    flat = {}
    for key, tensor in state_dict.items():
        if (key.split(".")[-1] in _BUFFERS) != buffers:
            continue
        mods = key.split(".")[:-1]
        names, i = [], 0
        while i < len(mods):
            if mods[i] in _LIST_PREFIX and i + 1 < len(mods):
                names.append(f"{_LIST_PREFIX[mods[i]]}{mods[i + 1]}")
                i += 2
            else:
                names.append(mods[i])
                i += 1
        arr = tensor.detach().float().cpu().numpy()
        leaf = flax_leaf(key, arr.ndim)
        if leaf == "kernel":
            arr = arr.transpose(_CONV_TO_FLAX) if arr.ndim == 4 else arr.T
        flat["/".join(names + [leaf])] = np.ascontiguousarray(arr)
    return flat


def params_to_flax(state_dict: Mapping[str, torch.Tensor]
                   ) -> dict[str, np.ndarray]:
    """The inverse of :func:`params_from_flax` for the parameters: a flat
    ``/``-joined flax params dict of float32 numpy arrays, ready for
    ``np.savez``. BatchNorm buffers are left out (see
    :func:`batch_stats_to_flax`)."""
    return _flax_paths(state_dict, buffers=False)


def batch_stats_to_flax(state_dict: Mapping[str, torch.Tensor]
                        ) -> dict[str, np.ndarray]:
    """The flax ``batch_stats`` collection of ``state_dict``'s BatchNorm
    buffers, flat and ``/``-joined (``<path>/mean``, ``<path>/var``)."""
    return _flax_paths(state_dict, buffers=True)
