"""The port's data path (``distributeddeeplearning_tpu_torch/data``) against
the JAX package's on the CPU: token shards and their masking, the image
folder's index and layout, the epoch length, the loader routing and the
prefetch depth, the learnable synthetic images; the host stream
(``StreamSource``: order, resume, a producer's error, the watchdog); and
the training CLI on token shards, with a resume under another loader
refused. The C++ image loader is held in ``test_torch_native_loader.py``.
"""

import dataclasses
import io
import json
import contextlib
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu import data as jdata
from distributeddeeplearning_tpu.data import imagenet as jimagenet
from distributeddeeplearning_tpu.data import native as jnative
from distributeddeeplearning_tpu.data import synthetic as jsynthetic
from distributeddeeplearning_tpu.data import tokens as jtokens
from distributeddeeplearning_tpu.train import loop as jloop
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch import data as tdata
from distributeddeeplearning_tpu_torch.data import imagenet as timagenet
from distributeddeeplearning_tpu_torch.data import native as tnative
from distributeddeeplearning_tpu_torch.data import synthetic as tsynthetic
from distributeddeeplearning_tpu_torch.data import tokens as ttokens
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

# VOCAB fits gpt_nano's 1024; MLM_VOCAB takes the masks' other branch.
SEQ, VOCAB, MLM_VOCAB = 16, 1000, 2000


def write_jpegs(root, splits=(("train", 3), ("val", 2)), classes=3,
                seed=0) -> str:
    """A ``<split>/<wnid>/*.JPEG`` tree of small random PIL JPEGs (plus a
    stray non-JPEG file the index must skip)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, per_class in splits:
        for c in range(classes):
            d = root / split / f"n{c:08d}"
            d.mkdir(parents=True)
            for i in range(per_class):
                h, w = (int(v) for v in rng.integers(20, 48, 2))
                pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                Image.fromarray(pixels).save(d / f"img{i}.JPEG", quality=90)
            (d / "notes.txt").write_text("not an image")
    return str(root)


def write_shards(root, rows=(12, 9), val_rows=5, seed=1) -> str:
    """``train-*.npy`` shards of ids (one of them uint16 and one column
    wider than SEQ, both of which the stream takes) and a
    ``validation-*.npy`` shard, with special ids sprinkled in."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for k, n in enumerate(rows):
        ids = rng.integers(0, VOCAB, (n, SEQ + k), dtype=np.int64)
        ids[:, 0] = 101
        ids[:, -1] = 0
        np.save(root / f"train-{k:05d}.npy",
                ids.astype(np.uint16 if k else np.int32))
    np.save(root / "validation-00000.npy",
            rng.integers(0, VOCAB, (val_rows, SEQ), dtype=np.int32))
    return str(root)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_jpegs(tmp_path_factory.mktemp("folder"))


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    return write_shards(tmp_path_factory.mktemp("shards") / "tok")


def configs(batch=4, seed=5, **data):
    """The same run as a JAX and a port ``TrainConfig``."""
    return tuple(lib.TrainConfig(
        model="resnet_nano" if lib is tconfig else "resnet18",
        global_batch_size=batch, seed=seed,
        data=lib.DataConfig(**data)) for lib in (jconfig, tconfig))


# ---------------------------------------------------------------------------
# Token shards
# ---------------------------------------------------------------------------

def _ids(seed=2, shape=(6, 40), vocab=MLM_VOCAB):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, shape).astype(np.int32)
    ids[:, 0], ids[:, -1], ids[0, 5:9] = 101, 102, 0
    return ids


@pytest.mark.parametrize("vocab", [MLM_VOCAB, 64])
def test_mask_batch_matches_jax(vocab):
    ids = _ids(vocab=vocab)
    out = ttokens.mask_batch(ids, mask_prob=0.3, vocab_size=vocab,
                             rng=np.random.default_rng(9))
    ref = jtokens.mask_batch(ids, mask_prob=0.3, vocab_size=vocab,
                             rng=np.random.default_rng(9))
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.mark.parametrize("max_pred", [1, 5, 40])
def test_gather_mask_batch_matches_jax(max_pred):
    ids = _ids()
    kw = dict(max_pred=max_pred, mask_prob=0.15, vocab_size=MLM_VOCAB)
    out = ttokens.gather_mask_batch(ids, rng=np.random.default_rng(4), **kw)
    ref = jtokens.gather_mask_batch(ids, rng=np.random.default_rng(4), **kw)
    assert out.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])


@pytest.mark.parametrize("objective,max_pred", [("causal", 0), ("mlm", 0),
                                                ("mlm", 3)])
@pytest.mark.parametrize("train,start", [(True, 0), (True, 3), (False, 0)])
def test_batch_stream_matches_jax(shards, objective, max_pred, train, start):
    jcfg, tcfg = configs(
        batch=4, data_dir=shards, seq_len=SEQ, vocab_size=VOCAB,
        mlm_max_predictions=max_pred)
    ref = list(zip(range(6), jtokens._batch_stream(
        jcfg, train=train, start_step=start, objective=objective)))
    out = list(zip(range(6), ttokens._batch_stream(
        tcfg, train=train, start_step=start, objective=objective)))
    assert len(out) == len(ref) > 0
    for (_, o), (_, r) in zip(out, ref):
        assert o.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(o[k], r[k])
            assert o[k].dtype == r[k].dtype


def test_token_ranks_read_disjoint_rows(shards):
    """World 2: each rank reads every other row of each shard, half the
    batch, and together they read what one rank reads alone."""
    _, tcfg = configs(batch=4, data_dir=shards, seq_len=SEQ)
    files = ttokens.token_files(shards, "validation")
    rows = [np.concatenate([b["input_ids"] for b in ttokens._batch_stream(
        tcfg.replace(global_batch_size=2), train=False, start_step=0,
        objective="causal", rank=r, world=2)]) for r in range(2)]
    whole = np.load(files[0])
    np.testing.assert_array_equal(rows[0], whole[0::2])
    np.testing.assert_array_equal(rows[1], whole[1::2])


def test_token_files_need_shards(tmp_path):
    with pytest.raises(FileNotFoundError, match="train-"):
        ttokens.token_files(str(tmp_path))


# ---------------------------------------------------------------------------
# Image folders, epochs, routing
# ---------------------------------------------------------------------------

def test_folder_index_matches_jax(folder):
    for split in ("train", "val"):
        out = timagenet.folder_index(folder, split)
        assert out == jimagenet.folder_index(folder, split)
        assert isinstance(out[0], tuple) and isinstance(out[1], tuple)
        assert len(out[0]) == (9 if split == "train" else 6)
    with pytest.raises(FileNotFoundError):
        timagenet.folder_index(folder, "test")


def test_detect_layout_matches_jax(folder, shards, tmp_path):
    tfrecord = tmp_path / "records"
    tfrecord.mkdir()
    (tfrecord / "train-00000-of-00001").write_bytes(b"")
    for path in (folder, str(tfrecord), shards):
        assert timagenet.detect_layout(path) == jimagenet.detect_layout(path)
    for lib in (timagenet, jimagenet):
        with pytest.raises(FileNotFoundError, match="neither"):
            lib.detect_layout(str(tmp_path / "empty"))


@pytest.mark.parametrize("case", ["folder", "shards", "none", "explicit"])
def test_steps_per_epoch_matches_jax(folder, shards, case):
    data = {"folder": dict(data_dir=folder, synthetic=False),
            "shards": dict(data_dir=shards, synthetic=False),
            "none": {}, "explicit": dict(data_dir=folder)}[case]
    for batch in (2, 4, 64):
        jcfg, tcfg = configs(batch=batch, **data)
        if case == "explicit":
            jcfg, tcfg = (c.replace(steps_per_epoch=7) for c in (jcfg, tcfg))
        assert tloop.steps_per_epoch(tcfg) == jloop.steps_per_epoch(jcfg)


@pytest.mark.parametrize("loader", ["auto", "native", "tf", "grain"])
@pytest.mark.parametrize("native_builds", [True, False])
def test_resolve_loader_matches_jax(monkeypatch, folder, shards, tmp_path,
                                    loader, native_builds):
    """Every (synthetic, data_dir, input kind) with this loader and with
    the native loader building or not resolves as the JAX package's."""
    monkeypatch.setattr(jnative, "available", lambda: native_builds)
    monkeypatch.setattr(tnative, "available", lambda: native_builds)
    tfrecord = tmp_path / "records"
    tfrecord.mkdir()
    (tfrecord / "train-00000-of-00001").write_bytes(b"")
    for synthetic in (True, False):
        for data_dir in (None, folder, str(tfrecord), shards):
            for kind in ("image", "tokens"):
                jcfg, tcfg = configs(data_dir=data_dir, synthetic=synthetic,
                                     loader=loader)
                assert (tdata.resolve_loader(tcfg, kind)
                        == jdata.resolve_loader(jcfg, kind)), (
                    synthetic, data_dir, kind)


@pytest.mark.parametrize("loader,native_builds", [
    ("tf", True), ("grain", True), ("auto", False)])
def test_check_loader_refuses_later_loaders(monkeypatch, folder, loader,
                                            native_builds):
    monkeypatch.setattr(tnative, "available", lambda: native_builds)
    monkeypatch.setattr(tnative, "unavailable_reason",
                        lambda: "no jpeglib.h")
    _, tcfg = configs(data_dir=folder, synthetic=False, loader=loader)
    with pytest.raises(SystemExit, match="later slice") as err:
        tdata.check_loader(tcfg, "image")
    if loader == "auto":
        assert "no jpeglib.h" in str(err.value)


def test_check_loader_refuses_a_native_loader_that_cannot_build(
        monkeypatch, folder):
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "unavailable_reason",
                        lambda: "native loader unavailable: no jpeglib.h")
    _, tcfg = configs(data_dir=folder, synthetic=False, loader="native")
    with pytest.raises(SystemExit, match="--loader native .*no jpeglib.h"):
        tdata.check_loader(tcfg, "image")


def test_check_loader_refuses_an_unknown_loader(folder):
    _, tcfg = configs(data_dir=folder, synthetic=False, loader="dali")
    with pytest.raises(ValueError, match="unknown data loader 'dali'"):
        tdata.check_loader(tcfg, "image")


@pytest.mark.parametrize("kw", [
    {}, {"prefetch_depth": 0}, {"prefetch_depth": 3},
    {"precision": "mixed"}, {"batch_ramp": "1:2,4"},
    {"batch_ramp": "1:2,4", "precision": "mixed", "prefetch_depth": 1}])
def test_effective_prefetch_depth_matches_jax(kw):
    kw = dict(kw)
    data = {"prefetch_depth": kw.pop("prefetch_depth")} if (
        "prefetch_depth" in kw) else {}
    jcfg, tcfg = configs(batch=1, **data)
    if kw.pop("precision", None):
        jcfg = jcfg.replace(precision=jconfig.PrecisionPolicy.mixed())
        tcfg = tcfg.replace(precision=tconfig.PrecisionPolicy.mixed())
    jcfg, tcfg = (c.replace(**kw) for c in (jcfg, tcfg))
    assert (tdata.effective_prefetch_depth(tcfg)
            == jdata.effective_prefetch_depth(jcfg))


def test_learnable_images_match_jax():
    """JAX's learnable batch is 0.7 x its noise + its class patterns in
    bf16; ``learnable_images`` on that noise and those patterns gives it
    bit for bit. (The port draws its noise and patterns from torch's
    generator, not JAX's.)"""
    seed, step, b, size, classes = 3, 5, 64, 16, 10
    ref = jsynthetic.SyntheticImages(b, size, classes, seed=seed,
                                     learnable=True).batch(step)
    key = jax.random.key(seed)
    k1, _ = jax.random.split(jax.random.fold_in(key, step))
    noise = jax.random.normal(k1, (b, size, size, 3), jnp.bfloat16)
    pattern_key = jax.random.fold_in(key, 0x5157)
    patterns = jnp.stack([
        jax.random.normal(jax.random.fold_in(pattern_key, int(label)),
                          (size, size, 3), jnp.bfloat16)
        for label in np.asarray(ref["label"])])

    def torch_bf16(x):
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).bfloat16()

    out = tsynthetic.learnable_images(torch_bf16(noise), torch_bf16(patterns))
    assert torch.equal(out, torch_bf16(ref["image"]))


def test_learnable_batches_carry_fixed_class_patterns():
    plain = tsynthetic.SyntheticImages(32, 8, 4, seed=7)
    learn = tsynthetic.SyntheticImages(32, 8, 4, seed=7, learnable=True)
    for step in (0, 9, tloop._EvaluatorBase.SYNTHETIC_EVAL_OFFSET):
        noise, out = plain.batch(step), learn.batch(step)
        assert torch.equal(noise["label"], out["label"])
        patterns = torch.stack([learn.pattern(int(c))
                                for c in out["label"]])
        assert torch.equal(out["image"], tsynthetic.learnable_images(
            noise["image"], patterns))
    assert not torch.equal(learn.pattern(0), learn.pattern(1))
    _, cfg = configs(synthetic_learnable=True, image_size=8)
    assert tsynthetic.make_source(cfg, "image").learnable


# ---------------------------------------------------------------------------
# The host stream
# ---------------------------------------------------------------------------

def numbered(n=None, fail_at=None, stall_at=None, stall_s=0.0):
    """Host batches {"x": [k, k]} for k = 0, 1, ... (n of them), raising
    at ``fail_at`` and sleeping ``stall_s`` before ``stall_at``."""
    k = 0
    while n is None or k < n:
        if k == fail_at:
            raise OSError(f"unreadable shard at batch {k}")
        if k == stall_at:
            time.sleep(stall_s)
        yield {"x": np.array([k, k], np.int32)}
        k += 1


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_stream_gives_steps_in_order_and_resumes(depth):
    src = timagenet.StreamSource(numbered(), "cpu", depth=depth,
                                 casts={"x": torch.int64})
    full = [src.batch(k)["x"] for k in range(6)]
    src.close()
    assert [int(b[0]) for b in full] == list(range(6))
    assert full[0].dtype == torch.int64
    # Resume at step 3: an iterator that starts at batch 3, as the loaders
    # give one, and the source indexed from 3.
    resumed = timagenet.StreamSource(
        (b for k, b in enumerate(numbered()) if k >= 3), "cpu",
        first_step=3, depth=depth)
    for k in (3, 4, 5):
        assert torch.equal(resumed.batch(k)["x"].long(), full[k])
    with pytest.raises(ValueError, match="out of order"):
        resumed.batch(7)
    resumed.close()


def test_stream_ends_after_a_finite_iterator():
    src = timagenet.StreamSource(numbered(2), "cpu", depth=2)
    src.batch(0), src.batch(1)
    with pytest.raises(StopIteration, match="exhausted at step 2"):
        src.batch(2)
    src.close()


def test_stream_carries_a_producer_error():
    src = timagenet.StreamSource(numbered(fail_at=2), "cpu", depth=2)
    src.batch(0), src.batch(1)
    with pytest.raises(OSError, match="unreadable shard at batch 2"):
        src.batch(2)
    src.close()


def test_stream_watchdog_retries_then_raises(capsys):
    src = timagenet.StreamSource(numbered(stall_at=1, stall_s=1.5), "cpu",
                                 depth=1, timeout_s=0.2, max_retries=2)
    assert int(src.batch(0)["x"][0]) == 0
    with pytest.raises(RuntimeError, match="data loader stalled"):
        src.batch(1)
    assert capsys.readouterr().err.count("# data watchdog") == 3
    src.close()


def test_stream_watchdog_lets_a_slow_batch_through():
    src = timagenet.StreamSource(numbered(stall_at=1, stall_s=0.3), "cpu",
                                 depth=1, timeout_s=0.2, max_retries=3)
    assert [int(src.batch(k)["x"][0]) for k in range(3)] == [0, 1, 2]
    assert src.wait_s > 0.05
    src.close()


def test_stream_close_releases_the_loader():
    closed = []
    src = timagenet.StreamSource(numbered(), "cpu", depth=2,
                                 on_close=lambda: closed.append(True))
    src.batch(0)
    src.close()
    assert closed == [True] and not src._thread.is_alive()


def test_guard_kwargs_follow_the_config():
    _, cfg = configs()
    assert timagenet.stream_guard_kwargs(cfg) == {}
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, loader_timeout_s=3.0, loader_retries=4))
    assert timagenet.stream_guard_kwargs(cfg) == {"timeout_s": 3.0,
                                                  "max_retries": 4}


# ---------------------------------------------------------------------------
# The CLI on token shards
# ---------------------------------------------------------------------------

def _cli(argv) -> tuple[list, dict]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tcli.main(argv)
    lines = [json.loads(x) for x in buf.getvalue().splitlines()]
    return lines[:-1], lines[-1]["summary"]


GPT = ["--device", "cpu", "--model", "gpt_nano", "--seq-len", str(SEQ),
       "--batch-size", "4", "--log-every", "1", "--warmup-steps", "0"]


def test_cli_trains_on_token_shards(shards, tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    metrics, summary = _cli([*GPT, "--data-dir", shards, "--steps", "2",
                             "--eval-batches", "2", "--checkpoint-dir",
                             ckpt])
    assert "loader=tokens" in capsys.readouterr().err
    assert summary["input_pipeline"]["loader"] == "tokens"
    assert len(metrics) == 2 and all(np.isfinite(m["loss"])
                                     for m in metrics)
    assert np.isfinite(summary["eval_loss"])
    # The same shards by hand: the first step's batch is the stream's.
    _, cfg = configs(batch=4, data_dir=shards, seq_len=SEQ)
    first = next(ttokens._batch_stream(cfg.replace(seed=0), train=True,
                                       start_step=0, objective="causal"))
    src = tloop.make_source(tcli.build_config(tcli.parse_args(
        [*GPT, "--data-dir", shards, "--steps", "2"])), _LM(), "cpu")
    got = src.batch(0)
    src.close()
    assert torch.equal(got["input_ids"], torch.from_numpy(
        first["input_ids"]).long())
    # Resuming the checkpoints under another loader is refused.
    with pytest.raises(RuntimeError, match="recorded 'tokens', this run "
                                           "resolved 'synthetic'"):
        _cli([*GPT, "--synthetic", "--steps", "3", "--checkpoint-dir",
              ckpt])
    # The same loader resumes.
    _, summary = _cli([*GPT, "--data-dir", shards, "--steps", "3",
                       "--checkpoint-dir", ckpt])
    assert summary["start_step"] == 2 and summary["final_step"] == 3


class _LM:
    """What ``loop.make_source`` reads of a causal LM."""

    class cfg:
        vocab_size = 50257


@pytest.mark.parametrize("model,argv,match", [
    ("gpt_nano", ["--data-dir", "FILE"], "no such directory"),
    ("resnet_nano", ["--data-dir", "FOLDER", "--loader", "grain"],
     "later slice"),
    ("resnet_nano", ["--data-dir", "FOLDER", "--loader", "tf"],
     "later slice"),
    ("resnet_nano", ["--data-dir", "SHARDS"], "later slice"),
    ("gpt_nano", ["--data-dir", "SHARDS", "--loader-timeout", "-1"],
     "must be >= 0"),
    ("gpt_nano", ["--data-dir", "SHARDS", "--loader-retries", "-1"],
     "must be >= 0")])
def test_cli_refuses_data_it_cannot_read(folder, shards, tmp_path, model,
                                         argv, match):
    (tmp_path / "file").write_text("")
    where = {"FILE": str(tmp_path / "file"), "FOLDER": folder,
             "SHARDS": shards}
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--device", "cpu", "--model", model, "--steps", "1",
                   "--seq-len", str(SEQ), *(where.get(a, a) for a in argv)])


def test_cli_data_dir_turns_synthetic_off(shards):
    cfg = tcli.build_config(tcli.parse_args(
        ["--model", "gpt_nano", "--synthetic", "--data-dir", shards,
         "--loader-timeout", "2.5", "--loader-retries", "1"]))
    assert cfg.data == tconfig.DataConfig(
        data_dir=shards, synthetic=False, loader_timeout_s=2.5,
        loader_retries=1)
    assert tcli.build_config(tcli.parse_args(
        ["--model", "gpt_nano", "--synthetic"])).data.synthetic


def test_token_source_refuses_ids_outside_the_vocabulary(shards):
    _, cfg = configs(batch=4, data_dir=shards, seq_len=SEQ, synthetic=False)
    src = ttokens.make_token_source(cfg, "cpu", objective="causal",
                                    vocab_size=VOCAB)
    src.batch(0)
    src.close()
    src = ttokens.make_token_source(cfg, "cpu", objective="causal",
                                    vocab_size=500)
    with pytest.raises(ValueError, match="outside the model's vocabulary "
                                         "of 500"):
        src.batch(0)
    src.close()
