"""Token models on the data axis (``--dp``, ``--accum`` for BERT, GPT and
Llama: train/steps.py, train/loop.py) and ViT's data-parallel and
accumulated steps, against the JAX package on the CPU.

The JAX package trains token models on ``make_gspmd_train_step``; on a
mesh with only the data axis that is one logical step over the global
batch, whose loss is the mean over the global batch's scored tokens. The
port runs its DP step with the counts summed over the ranks. One spawn of
two gloo ranks (``tests/torch_dist_helpers.py``) runs every world-2 case
while JAX compiles its references here. Weights are drawn with numpy from a
seed into the flax tree and carried to the port by ``utils/weights.py``;
f32, dropout 0 on both sides, sgd at a constant rate:

- ``bert_tiny`` at ``--dp 2``, at ``--accum 2`` on one process and at
  ``--dp 2 --accum 2`` (the gather head), ``gpt_nano`` and ``llama_nano``
  at ``--dp 2``, every batch with PAD tails (and BERT targets) whose
  counts differ between the ranks, against ``make_gspmd_train_step`` on a
  ``ParallelConfig(data=2)`` mesh: two steps, each step's loss within
  rtol 1e-5 and every parameter after each step within F32 of its
  tensor's largest |ref| (``close_rel``), as ``tests/test_torch_dp.py``
  holds ResNet; both ranks the same parameters, bit for bit.
- ``--dp 2 --accum 2`` groups microbatch i as rows i of each rank's shard
  (``split_microbatches`` on each rank). The JAX step on this CPU mesh
  takes the contiguous rows of the global batch instead (the case
  ``test_jax_cpu_mesh_groups_the_global_batch`` shows it), so the port is
  held against the same JAX step fed the global batch with its rows
  reordered so that its contiguous microbatches are the shard-local ones:
  JAX's ``accumulated_grads`` over the explicit shard-local microbatches.
- The normalisers are told apart: averaging the ranks' own means (each
  rank's one-card step on its shard, averaged: the same for one sgd step)
  misses the JAX step by more than the tolerance.
- The MLM and causal eval sums over the ranks against JAX's sums over the
  global batch (rtol 1e-5; the counts exact).
- ``vit_tiny`` at ``--dp 2`` and at ``--accum 2`` against
  ``make_dp_train_step``, held as above.
- Dropout: two microbatches of one ``bert_tiny`` step at rate 0.1, and
  two gloo ranks, fed identical rows, draw different masks; a world-1,
  accum-1 step with dropout is bit for bit the one drawn from the
  generator of (seed, step) alone.
- The CLI: ``llama_nano --dp 2`` under two gloo ranks prints on rank 0
  only, with the one-card run's losses and eval loss (rtol 1e-5), and
  ``--config bert_base_mlm --dp 1 --accum 8`` cut to ``bert_tiny`` runs.
"""

import concurrent.futures
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.linen import meta as flax_meta
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from distributeddeeplearning_tpu import config as jconfig
from distributeddeeplearning_tpu.models import bert as jbert
from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu.models import vit as jvit
from distributeddeeplearning_tpu.parallel import mesh as jmesh
from distributeddeeplearning_tpu.train import losses as jlosses
from distributeddeeplearning_tpu.train import optim as jopt
from distributeddeeplearning_tpu.train import steps as jsteps
from distributeddeeplearning_tpu.train.state import TrainState as JState
from distributeddeeplearning_tpu_torch.data.synthetic import step_seed
from distributeddeeplearning_tpu_torch.train import cli as tcli
from distributeddeeplearning_tpu_torch.train import loop as tloop
from distributeddeeplearning_tpu_torch.train import steps as tsteps
from distributeddeeplearning_tpu_torch.train.losses import mlm_loss
from distributeddeeplearning_tpu_torch.utils.weights import (
    params_from_flax, params_to_flax)
from tests.torch_dist_helpers import (CLASSES, World, build_model,
                                      dropout_masks, model_steps,
                                      nano_config, tensors)
from tests.torch_port_helpers import (F32, close_rel,  # noqa: F401
                                      flat_params, one_torch_thread)

WORLD, BATCH, SEQ, VOCAB, IMAGE = 2, 8, 16, 128, 32
ACCUM = 2
GATHER = 6     # the gather head's slots a row
LOSS_RTOL = 1e-5
NANO = dict(hidden_size=32, num_layers=1, num_heads=2)
LLAMA_NANO = dict(NANO, num_kv_heads=1, intermediate_size=64)
# (JAX model, the port's registry name and build kwargs, objective).
MODELS = {
    "bert_tiny": (jbert.tiny_bert_mlm(vocab_size=VOCAB, dropout_rate=0.0),
                  {"vocab_size": VOCAB, "dropout_rate": 0.0}, "mlm"),
    "gpt_nano": (jgpt.tiny_gpt(vocab_size=VOCAB, dropout_rate=0.0, **NANO),
                 {"vocab_size": VOCAB, "dropout_rate": 0.0}, "causal"),
    "llama_nano": (jllama.tiny_llama(vocab_size=VOCAB, **LLAMA_NANO),
                   {"vocab_size": VOCAB}, "causal"),
    "vit_tiny": (jvit.tiny_vit(num_classes=CLASSES),
                 {"num_classes": CLASSES, "image_size": IMAGE}, "classify"),
}
CLI = ["--device", "cpu", "--model", "llama_nano", "--batch-size",
       str(BATCH), "--seq-len", str(SEQ), "--synthetic", "--dtype",
       "float32", "--steps", "2", "--log-every", "1", "--eval-batches", "1",
       "--warmup-steps", "0", "--seed", "3"]


def seeded_params(name: str, seed: int) -> dict:
    """Every leaf of ``name``'s flax params drawn with numpy at ``seed``:
    N(0, 0.05^2), norm scales about 1."""
    model = MODELS[name][0]
    example = (jnp.zeros((1, IMAGE, IMAGE, 3)) if name == "vit_tiny"
               else jnp.ones((1, SEQ), jnp.int32))
    shapes = flax_meta.unbox(jax.eval_shape(
        lambda: model.init({"params": jax.random.key(0),
                            "dropout": jax.random.key(0)}, example,
                           train=False))["params"])
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32) * 0.05
        return x + 1.0 if path[-1].key == "scale" else x

    return jax.tree_util.tree_map_with_path(draw, shapes)


PARAMS = {name: seeded_params(name, seed)
          for seed, name in enumerate(MODELS)}
WEIGHTS = {name: {k: v.numpy() for k, v in params_from_flax(p).items()}
           for name, p in PARAMS.items()}


def token_batches(name: str, seed: int, n: int = 2, gather: bool = False
                  ) -> list:
    """``n`` global batches of ``name``'s inputs. Rank 0's rows (the first
    half) are long and, for BERT, dense in targets; rank 1's end in long
    PAD tails and hold few targets, so the ranks' counts differ."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if name == "vit_tiny":
            out.append({"image": rng.standard_normal(
                (BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
                "label": rng.integers(0, CLASSES, BATCH)})
            continue
        half = BATCH // 2
        lengths = np.concatenate([rng.integers(12, SEQ + 1, half),
                                  rng.integers(4, 9, half)])
        mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.int64)
        ids = rng.integers(1, VOCAB, (BATCH, SEQ)) * mask
        batch = {"input_ids": ids, "attention_mask": mask}
        if MODELS[name][2] == "mlm":
            rate = np.repeat([0.5, 0.15], half)[:, None]
            hit = (rng.random((BATCH, SEQ)) < rate) & (mask > 0)
            hit[:, 0] = True      # every row scores at least one target
            if gather:
                pos = np.stack([_positions(h, GATHER) for h in hit])
                labels = np.take_along_axis(ids, np.maximum(pos, 0), axis=1)
                batch.update(masked_positions=np.maximum(pos, 0),
                             masked_labels=np.where(pos >= 0, labels, -1))
            else:
                batch["labels"] = np.where(hit, ids, -1)
        out.append(batch)
    return out


def _positions(hit: np.ndarray, width: int) -> np.ndarray:
    """The first ``width`` target positions of a row, -1 past its last."""
    pos = np.flatnonzero(hit)[:width]
    return np.concatenate([pos, -np.ones(width - len(pos), np.int64)])



def jax_steps(name: str, accum: int, runs: list) -> list:
    """JAX's step for ``name`` at ``accum`` on a ``WORLD``-device data mesh,
    compiled once, over each list of batches in ``runs`` from
    ``PARAMS[name]``: for each run (each step's loss, the flat params after
    each step). Token models take ``make_gspmd_train_step``, ViT
    ``make_dp_train_step``."""
    model, _, objective = MODELS[name]
    cfg = jconfig.TrainConfig(
        model=name.replace("nano", "tiny"), global_batch_size=BATCH,
        dtype="float32", grad_accum_steps=accum,
        parallel=jconfig.ParallelConfig(data=WORLD),
        optimizer=jconfig.OptimizerConfig(
            learning_rate=0.1, reference_batch=BATCH, schedule="constant",
            warmup_epochs=0.0))
    mesh = jmesh.make_mesh(cfg.parallel)
    tx, _ = jopt.make_optimizer(cfg.optimizer, BATCH, 2)
    params = PARAMS[name]
    start = JState.create(params=params, opt_state=tx.init(params))
    if objective == "classify":
        step = jsteps.make_dp_train_step(model, tx, mesh, cfg, "image")
    else:
        shardings = jax.tree.map(lambda _: NamedSharding(mesh, P()), start)
        step = jsteps.make_gspmd_train_step(model, tx, mesh, cfg, shardings,
                                            "tokens", objective)
    out = []
    for batches in runs:
        state = jax.tree.map(jnp.array, start)   # the step donates it
        losses, after = [], []
        for batch in batches:
            state, metrics = step(state, batch, jax.random.key(0))
            losses.append(float(metrics["loss"]))
            after.append(flat_params(jax.device_get(state.params)))
        out.append((losses, after))
    return out


def shard_local(batch: dict) -> dict:
    """The global batch with its rows reordered so that its ``ACCUM``
    contiguous microbatches are the shard-local ones: microbatch i holds
    rows i of every rank's shard."""
    shard = BATCH // WORLD
    rows = shard // ACCUM
    order = [r * shard + i * rows + j for i in range(ACCUM)
             for r in range(WORLD) for j in range(rows)]
    return {k: v[order] for k, v in batch.items()}


def identical_halves(batch: dict) -> dict:
    """``batch`` with its second half a copy of its first."""
    half = BATCH // 2
    return {k: np.concatenate([v[:half], v[:half]]) for k, v in batch.items()}


BATCHES = {"bert_tiny": token_batches("bert_tiny", 11),
           "bert_gather": token_batches("bert_tiny", 12, gather=True),
           "gpt_nano": token_batches("gpt_nano", 13),
           "llama_nano": token_batches("llama_nano", 14),
           "vit_tiny": token_batches("vit_tiny", 15)}
# World-2 cases: (model, --accum, batches).
CASES = {"bert_dp": ("bert_tiny", 1, BATCHES["bert_tiny"]),
         "bert_dp_accum": ("bert_tiny", ACCUM, BATCHES["bert_gather"]),
         "gpt_nano_dp": ("gpt_nano", 1, BATCHES["gpt_nano"]),
         "llama_nano_dp": ("llama_nano", 1, BATCHES["llama_nano"]),
         "vit_dp": ("vit_tiny", 1, BATCHES["vit_tiny"])}
EVAL = {"mlm": "bert_tiny", "causal": "gpt_nano"}
DROPOUT_KW = {"vocab_size": VOCAB, "dropout_rate": 0.1}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks running every world-2 case; a test that reads the
    results waits for them."""
    payload = {
        "cases": {case: ({"model": model, "grad_accum_steps": accum},
                         MODELS[model][1], WEIGHTS[model], batches)
                  for case, (model, accum, batches) in CASES.items()},
        "eval": {obj: ({"model": model}, MODELS[model][1], WEIGHTS[model],
                       BATCHES[model][0]) for obj, model in EVAL.items()},
        "dropout": ({"model": "bert_tiny"}, DROPOUT_KW, WEIGHTS["bert_tiny"],
                    identical_halves(BATCHES["bert_tiny"][0])),
        "cli": [*CLI, "--dp", str(WORLD)]}
    return World(WORLD, "token_dp_cases", payload,
                 tmp_path_factory.mktemp("token_dp"))


def jax_refs(name: str, accum: int) -> dict:
    """JAX's runs of ``name`` at ``accum``, by what they are held against:
    the world-2 case of that model and accum (its batches, or at
    ``--accum`` above 1 their shard-local reordering), and at ``--accum``
    above 1 the batches in their own order (``natural``)."""
    runs = {case: ([shard_local(b) for b in batches] if accum > 1
                   else batches)
            for case, (model, a, batches) in CASES.items()
            if (model, a) == (name, accum)}
    if accum > 1:
        runs["natural"] = (BATCHES["bert_gather"] if name == "bert_tiny"
                           else BATCHES[name])
    return dict(zip(runs, jax_steps(name, accum, list(runs.values()))))


def jax_eval_sums(objective: str) -> tuple[float, float]:
    """JAX's (loss sum, count) of ``EVAL[objective]`` over its first
    global batch."""
    name = EVAL[objective]
    model = MODELS[name][0]
    batch = BATCHES[name][0]

    @jax.jit
    def sums(params, batch):
        logits = model.apply({"params": params}, batch["input_ids"],
                             attention_mask=batch["attention_mask"],
                             train=False)
        if objective == "mlm":
            return jlosses.mlm_loss_sums(logits, batch["labels"])
        return jlosses.causal_lm_loss_sums(logits, batch["input_ids"],
                                           batch["attention_mask"])

    return tuple(float(x) for x in sums(PARAMS[name], batch))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's references, compiled three at a time in threads (XLA releases
    the interpreter while it compiles) while the ranks run: ``jax_ref(fn,
    *args)`` waits for ``fn(*args)``."""
    jobs = [(jax_refs, key) for key in {(m, a) for m, a, _ in CASES.values()}
            | {("bert_tiny", ACCUM), ("vit_tiny", ACCUM)}]
    jobs += [(jax_eval_sums, (objective,)) for objective in EVAL]
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {(fn, args): pool.submit(fn, *args) for fn, args in jobs}
        yield lambda fn, *args: futures[fn, args].result()


def port_params(params: dict) -> dict:
    return params_to_flax({k: torch.from_numpy(v) for k, v in params.items()})


def assert_matches(out: dict, ref: tuple) -> None:
    """A port run's losses within ``LOSS_RTOL`` and its parameters after
    every step within F32 of a JAX run's."""
    losses, after = ref
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]], losses,
                               rtol=LOSS_RTOL)
    assert len(out["params"]) == len(after)
    for params, ref_params in zip(out["params"], after):
        close_rel(port_params(params), ref_params, F32)


@pytest.mark.parametrize("case", list(CASES))
def test_dp_matches_jax(ranks, jax_ref, case):
    """World 2 against JAX's step on the global batch; both ranks hold
    the same parameters, bit for bit."""
    model, accum, _ = CASES[case]
    out = ranks.results()
    assert_matches(out[0][case], jax_ref(jax_refs, model, accum)[case])
    for a, b in zip(out[0][case]["params"], out[1][case]["params"]):
        for key in a:
            assert np.array_equal(a[key], b[key]), (case, key)


@pytest.mark.parametrize("name", ["bert_tiny", "vit_tiny"])
def test_one_process_accum_matches_jax(jax_ref, name):
    """``--accum 2`` on one process: microbatches of consecutive rows of
    the whole batch, as JAX's step groups the global batch."""
    batches = (BATCHES["bert_gather"] if name == "bert_tiny"
               else BATCHES[name])
    out = model_steps(nano_config(model=name, grad_accum_steps=ACCUM),
                      MODELS[name][1], WEIGHTS[name], batches)
    assert_matches(out, jax_ref(jax_refs, name, ACCUM)["natural"])


def test_jax_cpu_mesh_groups_the_global_batch(ranks, jax_ref):
    """JAX's step at ``--accum 2`` on the 2-device CPU mesh, fed the batch
    in its own order, matches the one-process accumulation (above) and
    misses the world-2 port, whose microbatches are shard-local: the
    grouping matters for a loss normalised per microbatch, so the world-2
    case is held against the reordered batch."""
    natural = jax_ref(jax_refs, "bert_tiny", ACCUM)["natural"]
    world2 = ranks.results()[0]["bert_dp_accum"]["params"][0]
    with pytest.raises(AssertionError):
        close_rel(port_params(world2), natural[1][0], F32)


@pytest.mark.parametrize("case", ["bert_dp", "gpt_nano_dp", "llama_nano_dp"])
def test_mean_of_rank_means_misses_jax(ranks, jax_ref, case):
    """The normaliser is the global count: one sgd step from each rank's
    own mean (the one-card step on each shard, its parameters averaged,
    which is what averaging the ranks' gradients gives for one step)
    misses JAX's parameters by more than the tolerance the port meets."""
    model, _, batches = CASES[case]
    shard = BATCH // WORLD
    runs = [model_steps(nano_config(model=model), MODELS[model][1],
                        WEIGHTS[model],
                        [{k: v[r * shard:(r + 1) * shard]
                          for k, v in batches[0].items()}])
            for r in range(WORLD)]
    means = {k: np.mean([run["params"][0][k] for run in runs], axis=0)
             for k in runs[0]["params"][0]}
    ref = jax_ref(jax_refs, model, 1)[case][1][0]
    close_rel(port_params(ranks.results()[0][case]["params"][0]), ref, F32)
    with pytest.raises(AssertionError):
        close_rel(port_params(means), ref, F32)


@pytest.mark.parametrize("objective", list(EVAL))
def test_eval_sums_over_ranks(ranks, jax_ref, objective):
    """Each rank's eval step returns the sums over both ranks' rows: JAX's
    over the global batch (rtol 1e-5, the count exact)."""
    total, count = jax_ref(jax_eval_sums, objective)
    for rank in ranks.results():
        got_total, got_count = rank["eval"][objective]
        assert got_count == count
        np.testing.assert_allclose(got_total, total, rtol=LOSS_RTOL)


def _masks_by_microbatch(masks: list, groups: int) -> list:
    sites = len(masks) // groups
    assert sites * groups == len(masks) and sites > 0
    return [masks[g * sites:(g + 1) * sites] for g in range(groups)]


def test_microbatches_draw_different_dropout_masks():
    """Two microbatches of identical rows at rate 0.1 drop different
    positions at every site; a second run of the step drops the same."""
    cfg = nano_config(model="bert_tiny", grad_accum_steps=ACCUM)
    batch = identical_halves(BATCHES["bert_tiny"][0])
    runs = [dropout_masks(cfg, DROPOUT_KW, WEIGHTS["bert_tiny"], batch)
            for _ in range(2)]
    assert all(np.array_equal(a, b) for a, b in zip(*runs))
    first, second = _masks_by_microbatch(runs[0], ACCUM)
    for a, b in zip(first, second):
        assert a.shape == b.shape and not np.array_equal(a, b)


def test_ranks_draw_different_dropout_masks(ranks):
    """Both ranks' shards hold the same rows: their masks differ at every
    site."""
    out = ranks.results()
    for a, b in zip(out[0]["dropout"], out[1]["dropout"]):
        assert a.shape == b.shape and not np.array_equal(a, b)


def test_world1_step_is_unchanged_bitwise():
    """Rank 0's microbatch 0 draws from the generator of (seed, step)
    alone, so a world-1, accum-1 step with dropout 0.1 gives the loss and
    gradients of a step that draws every site from it and takes the
    masked-LM mean, bit for bit."""
    assert tsteps.dropout_rng(5, 3).initial_seed() == int(
        np.random.SeedSequence([5, 3, 1]).generate_state(
            1, dtype=np.uint64)[0] >> np.uint64(1))
    cfg = nano_config(model="bert_tiny", seed=7)
    batch = tensors(BATCHES["bert_tiny"][0])
    model = build_model(cfg, DROPOUT_KW, WEIGHTS["bert_tiny"])
    logits = model(batch["input_ids"], attention_mask=batch["attention_mask"],
                   rng=torch.Generator().manual_seed(step_seed(7, 0, 1)))
    loss = mlm_loss(logits, batch["labels"])
    loss.backward()
    out = model_steps(cfg, DROPOUT_KW, WEIGHTS["bert_tiny"],
                      [BATCHES["bert_tiny"][0]])
    assert out["metrics"][0]["loss"] == loss.item()
    for name, p in model.named_parameters():
        assert np.array_equal(out["grads"][name], p.grad.numpy()), name


def test_layout_accepts_token_models():
    tloop.check_layout(nano_config(WORLD, model="gpt_nano",
                                   grad_accum_steps=ACCUM), WORLD)
    tloop.check_layout(nano_config(model="bert_tiny", grad_accum_steps=4),
                       None)


def test_cli_token_data_parallel_run(ranks, capsys):
    """``llama_nano --dp 2`` (dropout 0): only rank 0 prints, and its
    losses and eval loss are the one-card run's on the whole batch."""
    runs = [r["cli"] for r in ranks.results()]
    assert runs[1] == ""
    tcli.main(CLI)
    one = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    lines = [json.loads(x) for x in runs[0].splitlines()]
    np.testing.assert_allclose([x["loss"] for x in lines if "loss" in x],
                               [x["loss"] for x in one if "loss" in x],
                               rtol=LOSS_RTOL)
    summary = lines[-1]["summary"]
    assert summary["data_parallel"]["world"] == WORLD
    np.testing.assert_allclose(summary["eval_loss"],
                               one[-1]["summary"]["eval_loss"],
                               rtol=LOSS_RTOL)


def test_cli_bert_preset_accumulates_on_cpu(capsys):
    """The preset's shape as ``--dp 1 --accum 8``, cut to bert_tiny."""
    tcli.main(["--config", "bert_base_mlm", "--dp", "1", "--accum", "8",
               "--model", "bert_tiny", "--batch-size", "16", "--seq-len",
               "16", "--attn", "flash", "--synthetic", "--steps", "2",
               "--log-every", "1", "--device", "cpu", "--warmup-steps",
               "0"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    losses = [x["loss"] for x in lines if "loss" in x]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert lines[-1]["summary"]["final_step"] == 2
