"""The port's BERT masked-LM (distributeddeeplearning_tpu_torch/models/
bert.py, train/losses.py's MLM loss, data/synthetic.py's SyntheticTokens,
the loop and CLI on ``bert_tiny``) against the JAX package on the CPU.

- bert_tiny's logits, dense head and gather head, through the port's
  dense impl and the flash kernels' plain versions, against the JAX
  model through its Pallas flash kernel in interpret mode (as the JAX
  tests run it on the CPU), under a key-padding mask: f32, within 1e-5;
- loss and every gradient against ``jax.value_and_grad`` of the JAX
  step's ``_token_loss_fn`` (gather head, padded keys), each gradient
  within 1e-4 of its tensor's largest |ref|;
- attention dropout 0.1 with each layer's seed fed to both sides (dense
  and flash against JAX dense, dense head): the hash mask is the same, so
  loss and gradients agree too; the residual and embedding sites are off
  on both sides, since torch's RNG cannot replay flax's;
- ``remat`` recomputes the same dropout; MoE, pipeline and ring raise;
- the registry's full-size counts on the meta device, ``mlm_loss_sums``
  against JAX, SyntheticTokens' structure against JAX's, the weights'
  round trip through the flax tree, and the CLI training bert_tiny two
  steps on synthetic data and on token shards, with and without the gather
  head, and refusing the MoE, pipelined, ring and tensor-parallel
  (``--tp``) variants; ``--dp`` and ``--accum`` are
  ``tests/test_torch_token_dp.py``'s.
"""

import functools
import json

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.data import synthetic as jsynthetic
from distributeddeeplearning_tpu.models import bert as jbert
from distributeddeeplearning_tpu.ops import hash_dropout as jhash
from distributeddeeplearning_tpu.train import losses as jlosses
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.data import synthetic as tsynthetic
from distributeddeeplearning_tpu_torch.data import tokens as ttokens
from distributeddeeplearning_tpu_torch.models import bert as tbert
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.ops import attention as tattn
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import steps as tsteps
from distributeddeeplearning_tpu_torch.train.losses import (mlm_loss,
                                                            mlm_loss_sums)
from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)
from tests.torch_port_helpers import (F32, close_rel,  # noqa: F401
                                      flat_params, flax_params,
                                      one_torch_thread)

VOCAB = 97
B, S, P = 2, 24, 4
# Gradients relative to each tensor's largest |ref| (``close_rel``).
GRAD = dict(rtol=1e-4, atol=1e-4)


def _batch():
    """ids, a key-padding mask (row 1 padded after 17 tokens), dense
    labels (-1 off target and on padding) and the gather head's positions
    and labels (one slot of row 1 unused: -1)."""
    rng = np.random.default_rng(5)
    ids = rng.integers(1, VOCAB, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 17:] = 0
    pos = np.array([[1, 5, 9, 20], [0, 3, 11, 0]], np.int32)
    masked_labels = np.take_along_axis(ids, pos, axis=1)
    masked_labels[1, 3] = -1
    labels = np.full((B, S), -1, np.int32)
    for b in range(B):
        for p, lab in zip(pos[b], masked_labels[b]):
            if lab >= 0:
                labels[b, p] = lab
    return ids, mask, labels, pos, masked_labels


@functools.lru_cache(maxsize=None)
def _params() -> dict:
    model = jbert.tiny_bert_mlm(vocab_size=VOCAB)
    init = jax.jit(lambda key: model.init({"params": key, "dropout": key},
                                          jnp.ones((1, S), jnp.int32),
                                          train=False))
    return flax_params(init(jax.random.key(0)))


def _port(impl, rate=0.0, **kw):
    model = tbert.tiny_bert_mlm(vocab_size=VOCAB, attention_impl=impl,
                                dropout_rate=rate, **kw)
    model.load_state_dict(params_from_flax(_params()))
    return model


@functools.lru_cache(maxsize=None)
def _jax_logits(gather: bool) -> np.ndarray:
    model = jbert.tiny_bert_mlm(vocab_size=VOCAB, attention_impl="flash")
    ids, mask, _, pos, _ = _batch()
    kw = {"masked_positions": jnp.asarray(pos)} if gather else {}
    return np.asarray(model.apply({"params": _params()}, jnp.asarray(ids),
                                  attention_mask=jnp.asarray(mask),
                                  train=False, **kw))


@pytest.mark.parametrize("gather", [False, True], ids=["dense_head",
                                                       "gather_head"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax_flash(impl, gather):
    ids, mask, _, pos, _ = _batch()
    kw = {"masked_positions": torch.from_numpy(pos)} if gather else {}
    with torch.no_grad():
        out = _port(impl).eval()(torch.from_numpy(ids).long(),
                                 attention_mask=torch.from_numpy(mask), **kw)
    ref = _jax_logits(gather)
    assert out.shape == ref.shape == ((B, P, VOCAB) if gather
                                      else (B, S, VOCAB))
    np.testing.assert_allclose(out.numpy(), ref, **F32)


def _jax_loss_and_grads(impl, rate, gather):
    model = jbert.tiny_bert_mlm(vocab_size=VOCAB, attention_impl=impl,
                                dropout_rate=rate)
    ids, mask, labels, pos, masked_labels = _batch()
    batch = {"input_ids": ids, "attention_mask": mask}
    if gather:
        batch.update(masked_positions=pos, masked_labels=masked_labels)
    else:
        batch["labels"] = labels
    loss_fn = jsteps._token_loss_fn(model, None)
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        _params(), None, jax.tree.map(jnp.asarray, batch), jax.random.key(1))
    return float(loss), flat_params(jax.tree.map(np.asarray, grads))


def _port_loss_and_grads(impl, rate, gather, **kw):
    model = _port(impl, rate, **kw).train()
    ids, mask, labels, pos, masked_labels = (torch.from_numpy(x)
                                             for x in _batch())
    if gather:
        logits = model(ids.long(), attention_mask=mask, masked_positions=pos,
                       rng=torch.Generator().manual_seed(0))
        loss = mlm_loss(logits, masked_labels)
    else:
        logits = model(ids.long(), attention_mask=mask,
                       rng=torch.Generator().manual_seed(0))
        loss = mlm_loss(logits, labels)
    loss.backward()
    grads = params_to_flax({n: p.grad for n, p in model.named_parameters()})
    return loss.item(), grads


_jax_flash_loss_and_grads = functools.lru_cache(maxsize=None)(
    lambda: _jax_loss_and_grads("flash", 0.0, True))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_loss_and_grads_match_jax(impl):
    ref_loss, ref_grads = _jax_flash_loss_and_grads()
    loss, grads = _port_loss_and_grads(impl, 0.0, True)
    np.testing.assert_allclose(loss, ref_loss, **F32)
    close_rel(grads, ref_grads, GRAD)


class _NoDropout:
    """flax ``nn.Dropout`` turned off: the residual and embedding sites."""

    def __init__(self, rate):
        del rate

    def __call__(self, x, deterministic=True):
        return x


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_attention_dropout_matches_jax(impl, monkeypatch):
    """Attention dropout 0.1: each layer's seed is fed to both sides, and
    the hash mask makes the loss and every gradient agree."""
    seeds = [-1234567, 987654321]
    jseeds, tseeds = iter(seeds), iter(seeds)
    monkeypatch.setattr(flax.linen, "Dropout", _NoDropout)
    monkeypatch.setattr(jhash, "seed_from_key",
                        lambda key: jnp.int32(next(jseeds)))
    monkeypatch.setattr(tbert, "dropout", lambda x, rate, rng: x)
    monkeypatch.setattr(tattn, "draw_seed", lambda rng: next(tseeds))
    ref_loss, ref_grads = _jax_loss_and_grads("dense", 0.1, False)
    loss, grads = _port_loss_and_grads(impl, 0.1, False)
    np.testing.assert_allclose(loss, ref_loss, **F32)
    close_rel(grads, ref_grads, GRAD)
    # The mask changes the result: without dropout the loss differs.
    plain_loss, _ = _port_loss_and_grads(impl, 0.0, False)
    assert abs(plain_loss - ref_loss) > 1e-4


def test_remat_recomputes_the_same_dropout():
    """Every dropout site at 0.1: a layer under ``torch.utils.checkpoint``
    draws its masks from a generator of its own seed, so the recomputed
    forward drops what the first did."""
    runs = [_port_loss_and_grads("flash", 0.1, True, remat=remat)
            for remat in (False, True)]
    assert runs[0][0] == runs[1][0]
    close_rel(runs[1][1], runs[0][1], dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("override,match", [
    ({"num_experts": 4}, "mixture-of-experts"),
    ({"pipeline_stages": 2}, "pipeline"),
    ({"attention_impl": "ring"}, "sequence-parallel"),
    ({"attention_impl": "zigzag"}, "sequence-parallel"),
])
def test_later_variants_raise(override, match):
    with pytest.raises(ValueError, match=match):
        tbert.tiny_bert_mlm(**override)


@pytest.mark.parametrize("name,count", [("bert_base", 109_514_298),
                                        ("bert_large", 335_174_458)])
def test_param_counts(name, count):
    spec = model_spec(name)
    assert spec.param_count == count and spec.objective == "mlm"
    with torch.device("meta"):
        model = spec.build(dtype=torch.float32)
    assert sum(p.numel() for p in model.parameters()) == count


def test_weights_round_trip_flax_tree():
    params = flat_params(_params())
    state = params_from_flax(_params())
    model = tbert.tiny_bert_mlm(vocab_size=VOCAB)
    model.load_state_dict(state)          # strict: every name maps
    back = params_to_flax(model.state_dict())
    assert back.keys() == params.keys()
    for key, value in params.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def test_mlm_loss_sums_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((B, S, VOCAB)).astype(np.float32) * 3
    _, _, labels, _, _ = _batch()
    ref = jlosses.mlm_loss_sums(jnp.asarray(logits), jnp.asarray(labels))
    out = mlm_loss_sums(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(out[0]), float(ref[0]), **F32)
    assert float(out[1]) == float(ref[1]) == 7.0
    # No target at all: the count is clamped at 1, as JAX guards it.
    none = np.full((B, S), -1, np.int32)
    assert float(mlm_loss(torch.from_numpy(logits),
                          torch.from_numpy(none))) == 0.0
    assert float(jlosses.mlm_loss(jnp.asarray(logits),
                                  jnp.asarray(none))) == 0.0


@pytest.mark.parametrize("max_pred", [0, 19])
def test_synthetic_tokens_structure_matches_jax(max_pred):
    """Keys, shapes and dtypes as JAX's batches (not their bits: the port
    draws from torch generators), [MASK] exactly at the targets, ids above
    the reserved range, the dense targets at about the masking rate."""
    b, s, vocab = 64, 128, 30522
    ref = jsynthetic.SyntheticTokens(b, s, vocab, 0.15, seed=0,
                                     max_predictions=max_pred).batch(3)
    out = tsynthetic.SyntheticTokens(b, s, vocab, 0.15, seed=0,
                                     max_predictions=max_pred).batch(3)
    assert out.keys() == ref.keys()
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape, key
    ids = out["input_ids"]
    assert (out["attention_mask"] == 1).all()
    if max_pred:
        pos, lab = out["masked_positions"].long(), out["masked_labels"]
        assert (pos[:, 1:] > pos[:, :-1]).all()       # distinct, sorted
        assert (ids.gather(1, pos) == tsynthetic.MASK_TOKEN_ID).all()
        assert ((lab >= 1000) & (lab < vocab)).all()
        assert int((ids == tsynthetic.MASK_TOKEN_ID).sum()) == b * max_pred
    else:
        target = out["labels"] >= 0
        assert ((ids == tsynthetic.MASK_TOKEN_ID) == target).all()
        assert ((out["labels"][target] >= 1000)).all()
        assert abs(float(target.float().mean()) - 0.15) < 0.01
        jrate = float((np.asarray(ref["labels"]) >= 0).mean())
        assert abs(float(target.float().mean()) - jrate) < 0.02
        assert (ids[~target] >= 1000).all()
    # A batch depends on its step only.
    again = tsynthetic.SyntheticTokens(b, s, vocab, 0.15, seed=0,
                                       max_predictions=max_pred).batch(3)
    assert all(torch.equal(out[k], again[k]) for k in out)


def test_eval_step_sums_mlm_loss():
    """The token eval step scores BERT by its masked-LM sums, eval mode
    (no dropout), gather head included."""
    cfg = tconfig.preset("bert_base_mlm").replace(
        model="bert_tiny", global_batch_size=2, total_steps=1,
        parallel=tconfig.ParallelConfig(),
        data=tconfig.DataConfig(dataset="mlm", seq_len=16, vocab_size=256,
                                mlm_max_predictions=3))
    state, _ = tloop.build_state(cfg, torch.device("cpu"))
    batch = tloop.make_source(cfg, state.model, "cpu").batch(0)
    out = tsteps.make_token_eval_step(cfg, "mlm")(state, batch)
    state.model.eval()
    with torch.no_grad():
        logits = state.model(batch["input_ids"],
                             attention_mask=batch["attention_mask"],
                             masked_positions=batch["masked_positions"])
    total, count = mlm_loss_sums(logits, batch["masked_labels"])
    assert float(out["count"]) == float(count) == 6.0
    assert float(out["loss_sum"]) == float(total)


def _cli(argv, capsys):
    tcli.main(["--config", "bert_base_mlm", "--dp", "1", "--model",
               "bert_tiny", "--device", "cpu", "--batch-size", "4",
               "--seq-len", "16", "--steps", "2", "--log-every", "1",
               "--attn", "flash", *argv])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    return lines[:-1], lines[-1]["summary"]


def _shards(tmp_path):
    """Token shards of BERT ids (above the reserved range) with PAD tails
    of varied length, as real MLM data arrives."""
    rng = np.random.default_rng(7)
    ids = rng.integers(1000, 30522, (12, 16)).astype(np.int32)
    for row, n in enumerate(rng.integers(6, 17, 12)):
        ids[row, n:] = ttokens.PAD_ID
    np.save(tmp_path / "train-00000.npy", ids)
    return str(tmp_path)


@pytest.mark.parametrize("data", ["synthetic", "shards"])
@pytest.mark.parametrize("gather", [None, "-1"])
def test_cli_trains_bert_tiny(data, gather, tmp_path, capsys):
    argv = ["--synthetic"] if data == "synthetic" else [
        "--data-dir", _shards(tmp_path)]
    if gather:
        argv += ["--mlm-max-predictions", gather]
    metrics, summary = _cli(argv, capsys)
    assert [x["step"] for x in metrics] == [1, 2]
    assert all(np.isfinite(x["loss"]) for x in metrics)
    # Random init: the first loss sits near ln(vocab).
    assert abs(metrics[0]["loss"] - np.log(30522)) < 0.5
    assert summary["input_pipeline"]["loader"] == (
        "synthetic" if data == "synthetic" else "tokens")
    assert summary["tokens_per_sec"] > 0


def test_token_shards_reach_bert_with_their_padding(tmp_path):
    """The MLM batches of the shards carry the PAD mask and, with the
    gather head, round(0.15 * 16) = 2 positions a row."""
    args = tcli.parse_args(["--config", "bert_base_mlm", "--dp", "1",
                            "--model", "bert_tiny", "--batch-size", "4",
                            "--seq-len", "16", "--data-dir",
                            _shards(tmp_path), "--mlm-max-predictions",
                            "-1", "--steps", "1"])
    cfg = tcli.build_config(args)
    assert cfg.data.mlm_max_predictions == 2
    state, _ = tloop.build_state(cfg, torch.device("cpu"))
    source = tloop.make_source(cfg, state.model, "cpu")
    try:
        batch = source.batch(0)
    finally:
        source.close()
    ids = batch["input_ids"]
    assert torch.equal(batch["attention_mask"].bool(),
                       ids != ttokens.PAD_ID)
    assert not batch["attention_mask"].all()
    assert tuple(batch["masked_positions"].shape) == (4, 2)


@pytest.mark.parametrize("argv,match", [
    (["--model", "bert_base_moe"], "mixture-of-experts"),
    (["--model", "bert_tiny_pp"], "pipeline"),
    (["--config", "bert_base_mlm", "--dp", "1", "--tp", "2"], "BERT.*GSPMD"),
    (["--config", "bert_base_mlm", "--tp", "8"], "BERT.*GSPMD"),
    (["--config", "bert_base_mlm_longctx", "--dp", "1", "--sp", "1"],
     "BERT.*sequence-parallel"),
])
def test_cli_refuses_later_bert_variants(argv, match):
    with pytest.raises(SystemExit, match=match):
        tcli.main(["--device", "cpu", "--steps", "1", *argv])
