"""Token shards: the counterpart of
``distributeddeeplearning_tpu/data/tokens.py``.

Shards are ``.npy`` files of token ids, shape (N, >= seq_len), matched by
``<split>-*.npy`` under ``data_dir``. Each rank reads every ``world``-th
row of every file, shuffled per epoch from the seed when training. Causal
LMs take the ids as they are; BERT's masked-LM batches are masked on the
host (80% [MASK], 10% a random id, 10% kept), from a generator keyed by
(seed, step, rank), so a resumed run replays the same masks.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional

import numpy as np

from distributeddeeplearning_tpu_torch.data.imagenet import (
    StreamSource, stream_guard_kwargs)

MASK_TOKEN_ID = 103  # [MASK] in the BERT-base uncased vocabulary
# BERT-base uncased special ids; ids <= UNUSED_MAX are never masked targets.
PAD_ID, CLS_ID, SEP_ID = 0, 101, 102
UNUSED_MAX = 999


def token_files(data_dir: str, split: str = "train") -> list[str]:
    files = sorted(glob.glob(os.path.join(data_dir, f"{split}-*.npy")))
    if not files:
        raise FileNotFoundError(
            f"no packed-token shards matching {split}-*.npy in {data_dir!r}")
    return files


def _sequence_stream(files: list[str], seq_len: int, *, repeat: bool,
                     shard_index: int, shard_count: int,
                     seed: int) -> Iterator[np.ndarray]:
    """Round-robin-sharded, epoch-shuffled stream of (seq_len,) id rows."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(len(files)) if repeat else np.arange(len(files))
        for fi in order:
            arr = np.load(files[fi], mmap_mode="r")
            if arr.ndim != 2 or arr.shape[1] < seq_len:
                raise ValueError(
                    f"{files[fi]}: expected (N, >= {seq_len}) int array, "
                    f"got {arr.shape}")
            rows = np.arange(arr.shape[0])
            rows = rows[rows % shard_count == shard_index]
            if repeat:
                rows = rng.permutation(rows)
            for r in rows:
                yield np.asarray(arr[r, :seq_len], np.int32)
        if not repeat:
            return


def _special_mask(ids: np.ndarray) -> np.ndarray:
    """Positions that are never masking targets, for both maskers."""
    return (ids == PAD_ID) | (ids == CLS_ID) | (ids == SEP_ID) | (
        ids <= UNUSED_MAX)


def _rand_lo(vocab_size: int) -> int:
    """Lowest id of the 10% random replacements: past the reserved range
    when the vocabulary is big enough (small test vocabularies use all)."""
    return UNUSED_MAX + 1 if vocab_size > UNUSED_MAX + 2 else 1


def mask_batch(ids: np.ndarray, *, mask_prob: float, vocab_size: int,
               rng: np.random.Generator) -> dict:
    """Dynamic BERT masking: labels -1 except at masked positions; inputs
    get 80% [MASK], 10% a random id, 10% unchanged."""
    special = _special_mask(ids)
    pick = (rng.random(ids.shape) < mask_prob) & ~special
    labels = np.where(pick, ids, -1).astype(np.int32)
    roll = rng.random(ids.shape)
    input_ids = ids.copy()
    input_ids[pick & (roll < 0.8)] = MASK_TOKEN_ID
    rand_pos = pick & (roll >= 0.8) & (roll < 0.9)
    input_ids[rand_pos] = rng.integers(
        _rand_lo(vocab_size), vocab_size, rand_pos.sum(), dtype=np.int32)
    return {"input_ids": input_ids, "labels": labels,
            "attention_mask": (ids != PAD_ID).astype(np.int32)}


def gather_mask_batch(ids: np.ndarray, *, max_pred: int, mask_prob: float,
                      vocab_size: int, rng: np.random.Generator) -> dict:
    """Gather-mode dynamic masking: per row, ``min(max_pred, round(maskable
    * mask_prob))`` distinct non-special positions with the 80/10/10
    recipe, as fixed-width sorted ``masked_positions`` and
    ``masked_labels`` (-1 padding)."""
    b, s = ids.shape
    special = _special_mask(ids)
    # Rank every position by a random key (+1 puts the specials last);
    # each row takes its first `take` ranks.
    maskable = (~special).sum(axis=1)
    take = np.minimum(
        np.minimum(max_pred,
                   np.maximum(1, np.round(maskable * mask_prob).astype(int))),
        maskable)
    order = np.argsort(rng.random(ids.shape) + special, axis=1)[:, :max_pred]
    valid = np.arange(max_pred)[None, :] < take[:, None]
    pos_sorted = np.sort(np.where(valid, order, s), axis=1)
    valid = pos_sorted < s
    positions = np.where(valid, pos_sorted, 0).astype(np.int32)
    labels = np.where(valid, np.take_along_axis(ids, positions, axis=1),
                      -1).astype(np.int32)
    input_ids = ids.copy()
    rows = np.broadcast_to(np.arange(b)[:, None], (b, max_pred))
    roll = rng.random((b, max_pred))
    m80 = valid & (roll < 0.8)
    input_ids[rows[m80], positions[m80]] = MASK_TOKEN_ID
    r10 = valid & (roll >= 0.8) & (roll < 0.9)
    input_ids[rows[r10], positions[r10]] = rng.integers(
        _rand_lo(vocab_size), vocab_size, int(r10.sum()), dtype=np.int32)
    return {"input_ids": input_ids,
            "attention_mask": (ids != PAD_ID).astype(np.int32),
            "masked_positions": positions, "masked_labels": labels}


def _batch_stream(config, *, train: bool, start_step: int,
                  objective: str = "mlm", rank: int = 0,
                  world: int = 1) -> Iterator[dict]:
    """The rank's host batches of the global batch over ``world``, from
    step ``start_step`` (the rows of earlier steps are read and dropped)."""
    d = config.data
    per_rank = config.global_batch_size // world
    if config.global_batch_size % world:
        raise ValueError("global_batch_size not divisible by process count")
    files = token_files(d.data_dir, "train" if train else "validation")
    seqs = _sequence_stream(files, d.seq_len, repeat=train,
                            shard_index=rank, shard_count=world,
                            seed=config.seed)
    step = 0
    while True:
        rows = []
        for _ in range(per_rank):
            try:
                rows.append(next(seqs))
            except StopIteration:
                return  # a finite (eval) stream drained mid-batch
        if step >= start_step:
            ids = np.stack(rows)
            if objective == "causal":
                # Causal LMs take the packed ids; the loss shifts them.
                yield {"input_ids": ids,
                       "attention_mask": (ids != PAD_ID).astype(np.int32)}
            else:
                rng = np.random.default_rng(
                    (config.seed * 1_000_003 + step) * 4099 + rank)
                if d.mlm_max_predictions > 0:
                    yield gather_mask_batch(
                        ids, max_pred=d.mlm_max_predictions,
                        mask_prob=d.mlm_mask_prob,
                        vocab_size=d.vocab_size, rng=rng)
                else:
                    yield mask_batch(ids, mask_prob=d.mlm_mask_prob,
                                     vocab_size=d.vocab_size, rng=rng)
        step += 1


def _in_vocab(it: Iterator[dict], vocab_size: int, data_dir: str,
              first_step: int) -> Iterator[dict]:
    """``it``, raising at a batch with an id outside the vocabulary (an
    embedding lookup would fail on it, on a card with a device assert)."""
    for step, batch in enumerate(it, first_step):
        ids = batch["input_ids"]
        if ids.min() < 0 or ids.max() >= vocab_size:
            raise ValueError(
                f"token shards in {data_dir!r}: the batch of step {step} "
                f"holds ids in [{ids.min()}, {ids.max()}], outside the "
                f"model's vocabulary of {vocab_size}")
        yield batch


def make_token_source(config, device, *, rank: int = 0, world: int = 1,
                      start_step: int = 0, train: bool = True,
                      objective: str = "mlm", casts: Optional[dict] = None,
                      vocab_size: Optional[int] = None) -> StreamSource:
    """The rank's ``StreamSource`` over the token shards of
    ``config.data.data_dir``; with ``vocab_size`` every id is checked to
    lie in it."""
    from distributeddeeplearning_tpu_torch import data as datalib

    it = _batch_stream(config, train=train, start_step=start_step,
                       objective=objective, rank=rank, world=world)
    if vocab_size is not None:
        it = _in_vocab(it, vocab_size, config.data.data_dir, start_step)
    return StreamSource(it, device, first_step=start_step,
                        depth=datalib.effective_prefetch_depth(config),
                        casts=casts,
                        **stream_guard_kwargs(config))
