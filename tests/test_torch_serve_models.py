"""The paged branches of the port's GPT and Llama models (``paged=`` and
``pools=``, distributeddeeplearning_tpu_torch/models/gpt.py and llama.py)
against JAX ``model.apply(..., paged_state=...)``.

The same weights, the same seeded pools and slot table (a dead slot,
positions across page boundaries) go to both; the logits of the live slots
must lie within 1e-4 of the largest |logit|, for the one-token step and the
block path, and the pools after the forward's writes within 1e-5. Llama's
RoPE at per-row positions must equal the scalar-offset rotation where the
two meet, and the models refuse a paged call that is not one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu.serve import kv_cache as jkv
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.serve import kv_cache as tkv
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.torch_port_helpers import one_torch_thread  # noqa: F401
from tests.torch_port_helpers import tiny_lm_params
from tests.torch_serve_helpers import VOCAB

JAX_BUILD = {"gpt": jgpt.tiny_gpt, "llama": jllama.tiny_llama}
LOGIT_TOL = 1e-4


def _paged_inputs(family, block: bool):
    """Weights, pools full of seeded values, and a slot table: slot 2 is
    dead, the rest sit at different positions across page boundaries."""
    rng = np.random.default_rng(11 if block else 12)
    jmodel = JAX_BUILD[family](vocab_size=VOCAB)
    params = tiny_lm_params(family, VOCAB)
    pools = traverse_util.flatten_dict(
        jkv.init_pools(jmodel, {"params": params}, num_pages=16,
                       page_size=4))
    pools = {path: rng.standard_normal(leaf.shape).astype(np.float32)
             for path, leaf in pools.items()}
    table = np.array([[3, 7, 1, 12], [5, 0, 9, 2], [0, 0, 0, 0],
                      [15, 4, 8, 6]], np.int64)
    lengths = np.array([2, 9, 0, 12], np.int64)
    live = np.array([True, True, False, True])
    t = 3 if block else 1
    ids = rng.integers(1, VOCAB, (4, t))
    state = [table, lengths, live]
    if block:
        state.append(np.array([3, 1, 0, 2], np.int64))
    return jmodel, params, pools, ids, state


@pytest.mark.parametrize("block", [False, True], ids=["step", "block"])
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_paged_logits_match_jax(family, block):
    jmodel, params, pools, ids, state = _paged_inputs(family, block)
    jcls = jkv.PagedBlockState if block else jkv.PagedState
    apply = jax.jit(lambda variables, ids, paged: jmodel.apply(
        variables, ids, train=False, decode=True, paged_state=paged,
        mutable=["cache"]))
    ref, mut = apply(
        {"params": params, "cache": traverse_util.unflatten_dict(
            {p: jnp.asarray(v) for p, v in pools.items()})},
        jnp.asarray(ids, jnp.int32),
        jcls(*[jnp.asarray(a) for a in state]))
    model = get_model(f"{family}_tiny", dtype=torch.float32, device="cpu",
                      vocab_size=VOCAB)
    model.load_state_dict(params_from_flax(params))
    layers = model.cfg.num_layers
    tpools = tkv.PagedPools(
        keys=[torch.tensor(pools[(f"layer{i}", "attention", "pages_k")])
              for i in range(layers)],
        values=[torch.tensor(pools[(f"layer{i}", "attention", "pages_v")])
                for i in range(layers)])
    tcls = tkv.PagedBlockState if block else tkv.PagedState
    with torch.inference_mode():
        out = model(torch.as_tensor(ids), paged=tcls(
            *[torch.as_tensor(a) for a in state]), pools=tpools)
    ref = np.asarray(ref)
    live = state[2]
    scale = np.abs(ref[live]).max()
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy()[live] / scale, ref[live] / scale,
                               rtol=0, atol=LOGIT_TOL)
    # The pools after the forward's writes.
    new = traverse_util.flatten_dict(mut["cache"])
    for i in range(layers):
        for name, t in (("pages_k", tpools.keys[i]),
                        ("pages_v", tpools.values[i])):
            np.testing.assert_allclose(
                t.numpy(), np.asarray(new[(f"layer{i}", "attention", name)]),
                rtol=1e-5, atol=1e-5)


def test_rope_positions_equal_the_scalar_offset():
    from distributeddeeplearning_tpu_torch.models.llama import apply_rope
    x = torch.randn(3, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([[7], [7], [7]]) + torch.arange(5)
    assert torch.equal(apply_rope(x, theta=1e4, offset=7),
                       apply_rope(x, theta=1e4, positions=pos))


@pytest.mark.parametrize("case", ["block_of_two", "train_mode", "no_pools",
                                  "with_cache"])
def test_paged_forward_refusals(case):
    model = get_model("gpt_tiny", dtype=torch.float32, device="cpu",
                      vocab_size=VOCAB)
    pools = tkv.init_pools(model, num_pages=4, page_size=4)
    state = tkv.PagedState(torch.zeros((1, 2), dtype=torch.long),
                           torch.zeros(1, dtype=torch.long),
                           torch.ones(1, dtype=torch.bool))
    ids = torch.ones((1, 2 if case == "block_of_two" else 1),
                     dtype=torch.long)
    kw = {"paged": state, "pools": None if case == "no_pools" else pools}
    if case == "with_cache":
        kw["cache"] = model.init_cache(1)
    if case == "train_mode":
        model.train()
    match = {"block_of_two": "exactly one token", "train_mode": "decode-mode",
             "no_pools": "page pools", "with_cache": "replaces"}[case]
    with pytest.raises(ValueError, match=match):
        model(ids, **kw)
