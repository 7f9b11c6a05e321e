"""The port's C++ image-folder loader (``data/native.py`` over the
unchanged ``csrc/ddl_loader.cc``) against the JAX package's bindings to the
same source, on the CPU: the same files, seed, batch and start batch give
the same images and labels bit for bit, for training and eval, whole and
as a rank's share of two; the port builds it into ``.cache/torch_kernels/``
only; the loop's source casts on the device; the CLI trains on an image
folder; and two gloo ranks (``tests/torch_dist_helpers.py``) read
disjoint files, each the JAX loader's share, and train ``--dp 2`` on them.
Loaders run two threads each.
"""

import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import imagenet as jimagenet
from distributeddeeplearning_tpu.data import native as jnative
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.data import imagenet as timagenet
from distributeddeeplearning_tpu_torch.data import native as tnative
from distributeddeeplearning_tpu_torch.ops import _build
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from tests.test_torch_data import write_jpegs
from tests.torch_dist_helpers import CLASSES, World
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

THREADS, SIZE, BATCH, SEED = 2, 24, 4, 7
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_jpegs(tmp_path_factory.mktemp("images"),
                       splits=(("train", 4), ("val", 3)), classes=CLASSES)


@pytest.fixture(scope="module")
def ranks(folder, tmp_path_factory):
    """Two gloo ranks reading the folder from step 1 and training on it
    at --dp 2; started once, while the in-process cases run."""
    tnative.build()
    base = tmp_path_factory.mktemp("data_dp")
    cli = ["--device", "cpu", "--model", "resnet_nano", "--image-size",
           str(SIZE), "--num-classes", str(CLASSES), "--batch-size", "8",
           "--dtype", "float32", "--data-dir", folder, "--dp", "2",
           "--steps", "2", "--log-every", "1", "--eval-batches", "1",
           "--warmup-steps", "0"]
    return World(2, "data_cases", {
        "folder": folder, "image_size": SIZE, "batch": 8, "seed": SEED,
        "start": 1,
        "steps": 2, "cli": cli}, base)


@pytest.fixture(autouse=True)
def two_loader_threads(monkeypatch):
    """The loaders' default thread count (cpu_count - 1) at two."""
    monkeypatch.setattr(os, "cpu_count", lambda: THREADS + 1)


def jax_batches(paths, labels, n, **kw) -> list:
    loader = jnative.NativeImageLoader(
        list(paths), list(labels), image_size=SIZE, seed=SEED,
        num_threads=THREADS, **kw)
    out = [next(loader) for _ in range(n)]
    loader.close()
    return out


def assert_same(out: list, ref: list) -> None:
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(o["label"]), r["label"])
        np.testing.assert_array_equal(np.asarray(o["image"]), r["image"])


@pytest.mark.parametrize("train,start", [(True, 0), (True, 5), (False, 0)])
def test_loader_matches_jax_bitwise(folder, train, start):
    split = "train" if train else "val"
    paths, labels = timagenet.folder_index(folder, split)
    kw = dict(batch_size=BATCH, train=train, start_batch=start)
    n = 4 if train else len(paths) // BATCH
    loader = tnative.NativeImageLoader(paths, labels, image_size=SIZE,
                                       seed=SEED, num_threads=THREADS, **kw)
    out = [next(loader) for _ in range(n)]
    if not train:
        with pytest.raises(StopIteration):
            next(loader)
    loader.close()
    assert out[0]["image"].dtype == np.float32
    assert out[0]["image"].shape == (BATCH, SIZE, SIZE, 3)
    assert_same(out, jax_batches(paths, labels, n, **kw))


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_share_matches_jax(folder, rank):
    """World 2: the rank's source reads paths[rank::2] at half the batch,
    from batch start_step, as JAX's loader over that slice does."""
    cfg = tconfig.TrainConfig(
        model="resnet_nano", global_batch_size=2 * BATCH, seed=SEED,
        dtype="float32", data=tconfig.DataConfig(
            data_dir=folder, synthetic=False, image_size=SIZE))
    src = tnative.make_native_source(cfg, "cpu", rank=rank, world=2,
                                     start_step=2)
    out = [src.batch(step) for step in (2, 3, 4)]
    src.close()
    paths, labels = jimagenet.folder_index(folder, "train")
    assert_same(out, jax_batches(paths[rank::2], labels[rank::2], 3,
                                 batch_size=BATCH, train=True,
                                 start_batch=2))


def test_builds_only_into_the_port_cache():
    lib = tnative.build()
    assert lib == tnative.library_path() and lib.exists()
    assert lib.parent == _build.CACHE == REPO / ".cache" / "torch_kernels"
    assert tnative.available()
    assert not (REPO / "csrc" / lib.name).exists()


def test_loop_source_casts_on_the_device(folder):
    """The loop's source at the default bf16: images cast from the
    loader's f32, labels int64; the val split in order, once."""
    cfg = tconfig.TrainConfig(
        model="resnet_nano", global_batch_size=BATCH, seed=SEED,
        data=tconfig.DataConfig(data_dir=folder, synthetic=False,
                                image_size=SIZE))
    src = tloop.make_source(cfg, None, "cpu", None, 0, False)
    paths, labels = timagenet.folder_index(folder, "val")
    ref = jax_batches(paths, labels, len(paths) // BATCH,
                      batch_size=BATCH, train=False)
    for step, r in enumerate(ref):
        out = src.batch(step)
        assert out["image"].dtype == torch.bfloat16
        assert out["label"].dtype == torch.int64
        assert torch.equal(out["image"],
                           torch.from_numpy(r["image"]).bfloat16())
        assert torch.equal(out["label"], torch.from_numpy(r["label"]).long())
    with pytest.raises(StopIteration):
        src.batch(len(ref))
    src.close()


def test_cli_trains_on_an_image_folder(folder, capsys):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(["--device", "cpu", "--model", "resnet_nano",
                   "--image-size", str(SIZE), "--num-classes", str(CLASSES),
                   "--batch-size", str(BATCH), "--data-dir", folder,
                   "--steps", "2", "--log-every", "1", "--eval-batches",
                   "2", "--warmup-steps", "0"])
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    summary = lines[-1]["summary"]
    assert "loader=native" in capsys.readouterr().err
    assert summary["input_pipeline"]["loader"] == "native"
    assert [x["step"] for x in lines[:-1]] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in lines[:-1])
    assert 0.0 <= summary["eval_top1"] <= 1.0


def test_two_ranks_read_disjoint_files(folder, ranks):
    paths, labels = jimagenet.folder_index(folder, "train")
    results = ranks.results()
    for rank, res in enumerate(results):
        assert_same(res["batches"], jax_batches(
            paths[rank::2], labels[rank::2], 2, batch_size=BATCH,
            train=True, start_batch=1))
    assert results[1]["cli"] == ""
    lines = [json.loads(x) for x in results[0]["cli"].splitlines()]
    summary = lines[-1]["summary"]
    assert summary["data_parallel"]["world"] == 2
    assert summary["input_pipeline"]["loader"] == "native"
    assert summary["final_step"] == 2
    assert all(np.isfinite(x["loss"]) for x in lines[:-1] if "loss" in x)
