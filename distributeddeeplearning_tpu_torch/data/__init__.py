"""Training data of the port, routed as the JAX package's
``distributeddeeplearning_tpu/data/__init__.py`` routes it: synthetic
batches made on the device (``synthetic.py``), an image folder through the
C++ loader (``native.py``), or token shards (``tokens.py``), the last two
streamed from the host to the card (``imagenet.StreamSource``). Every
source hands out this rank's rows of a step's global batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from distributeddeeplearning_tpu_torch.data import synthetic

# Loaders of the JAX package that need packages the card's machine lacks.
LATER_LOADERS = {
    "tf": "the tf.data pipeline (TFRecords, and image folders where the "
          "native loader cannot build) comes with a later slice of the "
          "port",
    "grain": "the grain pipeline comes with a later slice of the port",
}


def resolve_loader(config, input_kind: str) -> str:
    """The pipeline ``config.data.loader`` resolves to: ``synthetic |
    tokens | native | tf | grain`` (or an unknown name, refused by
    ``make_source``). ``auto`` takes the native loader for an image folder
    when it builds, else tf.data; the resolution is pinned to the
    checkpoint, so a resume under another one fails."""
    d = config.data
    if d.synthetic or not d.data_dir:
        return "synthetic"
    if input_kind == "tokens":
        return "tokens"
    loader = d.loader
    if loader == "auto":
        from distributeddeeplearning_tpu_torch.data import imagenet, native
        loader = ("native"
                  if (imagenet.detect_layout(d.data_dir) == "folder"
                      and native.available()) else "tf")
    return loader


def check_loader(config, input_kind: str) -> str:
    """``resolve_loader``, refusing with a ``SystemExit`` a loader the port
    does not carry, naming its slice (and, for an image folder the native
    loader could not take, why), and the native loader where it cannot
    build or load; an unknown loader with a ``ValueError``."""
    loader = resolve_loader(config, input_kind)
    if loader in LATER_LOADERS:
        from distributeddeeplearning_tpu_torch.data import imagenet, native
        why = ""
        d = config.data
        if (loader == "tf" and d.loader == "auto"
                and imagenet.detect_layout(d.data_dir) == "folder"):
            why = f" ({native.unavailable_reason()})"
        raise SystemExit(f"--loader {d.loader} resolved to {loader!r} for "
                         f"{d.data_dir!r}{why}: {LATER_LOADERS[loader]}")
    if loader == "native":
        from distributeddeeplearning_tpu_torch.data import native
        if not native.available():
            raise SystemExit(f"--loader native for {config.data.data_dir!r}"
                             f": {native.unavailable_reason()}")
    if loader not in ("synthetic", "tokens", "native"):
        raise ValueError(
            f"unknown data loader {loader!r}; expected one of "
            f"auto | tf | native | grain")
    return loader


def effective_prefetch_depth(config) -> int:
    """Batches a streamed source reads ahead: ``data.prefetch_depth``,
    doubled under an explicit precision policy (a large-batch recipe), and
    under a batch ramp scaled by final batch / this batch, so the host is
    provisioned for the final batch from the first stage."""
    depth = config.data.prefetch_depth
    if depth <= 0:
        return depth
    scale = 1
    if config.precision is not None:
        scale = 2
    if config.batch_ramp:
        from distributeddeeplearning_tpu_torch.train import optim
        final = optim.ramp_final_batch(config)
        scale = max(scale,
                    -(-int(final) // max(config.global_batch_size, 1)))
    return depth * scale


class RankRows:
    """A source of global batches as the rank's rows of each
    (``DataParallel.shard``)."""

    def __init__(self, source, dp):
        self.source, self.dp = source, dp

    def batch(self, step: int) -> dict:
        return self.dp.shard(self.source.batch(step))


def make_source(config, input_kind: str, device, *, dp=None,
                start_step: int = 0, train: bool = True,
                objective: str = "classify",
                vocab_size: Optional[int] = None):
    """The source of this rank's batches (``dp``: its ``DataParallel``,
    None for one card):

    - synthetic (or no data_dir): batches made on the device from (seed,
      step), the rank's rows of each global batch: images, or token ids
      by ``objective`` (causal ids, or masked-LM batches);
    - tokens + data_dir: the token shards, the rank's rows from
      ``start_step``, masked on the host when ``objective`` is ``mlm``;
    - an image folder: the native loader, the rank's files from
      ``start_step``, images cast to the compute dtype on the device.

    ``train=False`` reads the held-out split (``val/``, or the shards'
    ``validation-*``) once, in order.
    """
    from distributeddeeplearning_tpu_torch.config import resolve_precision

    loader = check_loader(config, input_kind)
    rank, world = (0, 1) if dp is None else (dp.rank, dp.world)
    if loader == "synthetic":
        source = synthetic.make_source(config, input_kind, device,
                                       objective=objective,
                                       vocab_size=vocab_size)
        return source if dp is None else RankRows(source, dp)
    if loader == "tokens":
        from distributeddeeplearning_tpu_torch.data import tokens
        return tokens.make_token_source(
            config, device, rank=rank, world=world, start_step=start_step,
            train=train, objective=objective,
            casts={"input_ids": torch.int64}, vocab_size=vocab_size)
    from distributeddeeplearning_tpu_torch.data import native
    compute = getattr(torch, resolve_precision(config).compute_dtype)
    return native.make_native_source(
        config, device, rank=rank, world=world, train=train,
        start_step=start_step,
        casts={"image": compute, "label": torch.int64})
