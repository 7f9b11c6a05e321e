"""The port's bucketed gradient all-reduce (distributeddeeplearning_tpu_torch/
parallel/collectives.py) against the JAX package's
(``tests/test_collectives.py`` mirrored, on gloo).

- The bucket plan is a function of (name, shape, dtype): stable under
  reordering, size-capped, an oversized tensor alone, one bucket per tensor
  at 0 bytes, every tensor once; and it groups a tree as JAX's
  ``plan_buckets`` groups the same tree.
- Two spawned gloo ranks (one spawn for the module) each hold one slice of
  every tensor: the fused f32 reduce equals the per-leaf one and the f64
  sum within ``rtol=1e-6``; the bf16 payload is restored to f32 within
  ``rtol=2e-2, atol=5e-2`` (docs/fused_allreduce.md); the ring form equals
  psum; ``all_reduce_gradients`` reads its options and refuses a payload
  dtype with JAX's message; SyncBN's cross-replica mean and its gradient.
- A plan built for other tensors raises, and the CLI's ``--allreduce-*``
  flags round-trip.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.parallel import collectives as jcoll
from distributeddeeplearning_tpu_torch import config as tconfig
from distributeddeeplearning_tpu_torch.parallel import collectives
from distributeddeeplearning_tpu_torch.train import cli as tcli
from tests.torch_dist_helpers import World
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

WORLD = 2


def leaf_specs() -> dict:
    """The JAX test's gradient-tree zoo (many small leaves, one large) and
    a leaf of odd size, which the ring pads at two ranks."""
    return {"conv1.kernel": (3, 3, 3, 8), "conv1.bias": (8,),
            "conv2.bias": (5,), "bn1.scale": (8,), "bn1.offset": (8,),
            "dense.kernel": (256, 128), "dense.bias": (128,),
            "head.kernel": (128, 1000)}


def meta_tree(specs=None, dtype=torch.float32) -> dict:
    return {n: torch.empty(s, dtype=dtype, device="meta")
            for n, s in (specs or leaf_specs()).items()}


def values(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((WORLD,) + s).astype(np.float32)
            for n, s in leaf_specs().items()}


@pytest.fixture(scope="module")
def reduced(tmp_path_factory):
    vals = values(0)
    world = World(WORLD, "collective_cases", vals,
                  tmp_path_factory.mktemp("collectives"))
    return vals, world


def _results(reduced):
    vals, world = reduced
    ref = {n: v.astype(np.float64).sum(axis=0) for n, v in vals.items()}
    return vals, ref, world.results()


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


def test_plan_is_stable_under_reordering():
    tree = meta_tree()
    reordered = dict(reversed(list(tree.items())))
    cap = 64 * 1024
    a = collectives.plan_buckets(tree, cap)
    b = collectives.plan_buckets(reordered, cap)
    assert len(a.buckets) == len(b.buckets) > 1
    for name in a.names:
        assert a.bucket_of(name) == b.bucket_of(name), name
    assert tuple(tuple(a.names[i] for i in m) for m in a.buckets) == \
        tuple(tuple(b.names[i] for i in m) for m in b.buckets)


def test_plan_respects_size_cap_and_isolates_oversized_leaves():
    cap = 64 * 1024
    plan = collectives.plan_buckets(meta_tree(), cap)
    for members in plan.buckets:
        nbytes = sum(collectives._numel(plan.shapes[i])
                     * plan.dtypes[i].itemsize for i in members)
        assert nbytes <= cap or len(members) == 1
    head = plan.bucket_of("head.kernel")   # 500 KB > 64 KB
    assert len(plan.buckets[head]) == 1


def test_plan_zero_bytes_is_per_leaf_and_covers_every_leaf_once():
    plan = collectives.plan_buckets(meta_tree(), 0)
    assert len(plan.buckets) == plan.num_leaves
    assert all(len(m) == 1 for m in plan.buckets)
    plan = collectives.plan_buckets(meta_tree(), 32 * 1024)
    assert sorted(i for m in plan.buckets for i in m) == \
        list(range(plan.num_leaves))


@pytest.mark.parametrize("cap", [0, 4 * 1024, 64 * 1024, 4 * 1024 * 1024])
def test_plan_groups_as_jax_does(cap):
    """The same leaves in JAX's nested tree and the port's flat names:
    the same buckets, in the same order, with the same members."""
    nested: dict = {}
    for name, shape in leaf_specs().items():
        mod, leaf = name.split(".")
        nested.setdefault(mod, {})[leaf] = jax.ShapeDtypeStruct(shape,
                                                                np.float32)
    ref = jcoll.plan_buckets(nested, cap)
    out = collectives.plan_buckets(meta_tree(), cap)

    def key(path: str) -> str:   # "['conv1']['bias']" -> "conv1.bias"
        return ".".join(p.strip("'") for p in path.strip("[]").split("]["))

    assert [[key(ref.paths[i]) for i in m] for m in ref.buckets] == \
        [[out.names[i] for i in m] for m in out.buckets]


def test_plan_mismatch_raises():
    plan = collectives.plan_buckets(meta_tree(), 0)
    smaller = {"conv1.kernel": torch.zeros(3, 3, 3, 8)}
    with pytest.raises(ValueError, match="leaves"):
        collectives.all_reduce(smaller, plan=plan)


# ---------------------------------------------------------------------------
# Sums on two gloo ranks
# ---------------------------------------------------------------------------


def test_fused_matches_perleaf_fp32(reduced):
    _, ref, ranks = _results(reduced)
    for out in ranks:
        for n in ref:
            np.testing.assert_allclose(out["fused"][n], ref[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
            np.testing.assert_allclose(out["perleaf"][n], ref[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
            np.testing.assert_allclose(out["fused"][n], out["perleaf"][n],
                                       rtol=1e-6, atol=0, err_msg=n)
            np.testing.assert_allclose(out["default"][n], ref[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)
    # Every rank holds the same sum, bit for bit.
    for n in ref:
        assert np.array_equal(ranks[0]["fused"][n], ranks[1]["fused"][n])


def test_bf16_payload_within_documented_tolerance(reduced):
    _, ref, ranks = _results(reduced)
    for n in ref:
        out = ranks[0]["bf16"][n]
        assert out.dtype == np.float32   # the f32 master restored
        np.testing.assert_allclose(out, ref[n], rtol=2e-2, atol=5e-2,
                                   err_msg=n)


@pytest.mark.parametrize("case", ["ring", "ring_perleaf"])
def test_ring_algorithm_matches_psum(reduced, case):
    """Reduce-scatter + all-gather, payloads padded to a multiple of the
    world (the 5-element leaf, alone at 0 bytes or in a bucket)."""
    _, ref, ranks = _results(reduced)
    for out in ranks:
        for n in ref:
            np.testing.assert_allclose(out[case][n], ref[n], rtol=1e-6,
                                       atol=1e-6, err_msg=n)


def test_all_reduce_gradients_reads_options(reduced):
    _, ref, ranks = _results(reduced)
    for n in ref:
        np.testing.assert_allclose(ranks[0]["options"][n], ref[n],
                                   rtol=1e-6, atol=1e-6, err_msg=n)
    assert "allreduce dtype 'float16' not supported" in ranks[0]["bad_dtype"]


def test_cross_replica_mean_and_its_gradient(reduced):
    vals, _, ranks = _results(reduced)
    x = vals["bn1.scale"]
    for rank, out in enumerate(ranks):
        np.testing.assert_allclose(out["pmean"], x.mean(axis=0), rtol=1e-6)
        # Rank r's loss weighs the mean by r + 1. Each rank's gradient is
        # that of the sum of both ranks' losses through its own share of
        # the mean, (1 + 2) / 2, whichever rank it is; the train step's
        # division by the world then averages.
        np.testing.assert_allclose(out["pmean_grad"], np.full(8, 1.5),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# Options and the CLI
# ---------------------------------------------------------------------------


def test_train_cli_roundtrip_allreduce_flags():
    cfg = tcli.build_config(tcli.parse_args(
        ["--model", "resnet_nano", "--allreduce-bucket-mb", "8",
         "--allreduce-dtype", "bfloat16", "--allreduce-algo", "ring"]))
    assert cfg.allreduce.bucket_mb == 8.0
    assert cfg.allreduce.dtype == "bfloat16"
    assert cfg.allreduce.algorithm == "ring"
    assert "fused" in cfg.allreduce.describe()
    base = tcli.build_config(tcli.parse_args(["--model", "resnet_nano"]))
    assert base.allreduce == tconfig.AllReduceConfig()
    assert base.allreduce.bucket_mb == collectives.DEFAULT_BUCKET_MB
    perleaf = tcli.build_config(tcli.parse_args(
        ["--model", "resnet_nano", "--allreduce-bucket-mb", "0"]))
    assert perleaf.allreduce.bucket_mb == 0.0
    assert "per-leaf" in perleaf.allreduce.describe()
    with pytest.raises(SystemExit, match="must be >= 0"):
        tcli.build_config(tcli.parse_args(["--allreduce-bucket-mb", "-1"]))
    with pytest.raises(SystemExit):
        tcli.parse_args(["--allreduce-algo", "tree"])


def test_allreduce_config_is_replace_safe():
    cfg = tconfig.AllReduceConfig()
    new = dataclasses.replace(cfg, bucket_mb=0.0)
    assert new.bucket_mb == 0.0
    assert cfg.bucket_mb == collectives.DEFAULT_BUCKET_MB
