"""The port's generation (distributeddeeplearning_tpu_torch/models/
generate.py and the ``python -m distributeddeeplearning_tpu_torch.generate``
CLI) against the JAX package, plus the port's own guards.

Greedy tokens are held identical to JAX ``generate`` for both families, for
the full-refeed path (dense and flash) and the KV-cache path. Sampling draws
from a ``torch.Generator``, which cannot give ``jax.random``'s bits, so it is
held to determinism inside the port and to the top-k rule.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributeddeeplearning_tpu.models import generate as jgen
from distributeddeeplearning_tpu.models import gpt as jgpt
from distributeddeeplearning_tpu.models import llama as jllama
from distributeddeeplearning_tpu_torch import resolve_device
from distributeddeeplearning_tpu_torch.generate import main as cli_main
from distributeddeeplearning_tpu_torch.models import generate as tgen
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.utils.weights import params_from_flax
from tests.torch_port_helpers import flat_params, flax_params  # noqa: F401
from tests.torch_port_helpers import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
VOCAB = 97
JAX_BUILD = {"gpt": jgpt.tiny_gpt, "llama": jllama.tiny_llama}
PORT_NAME = {"gpt": "gpt_tiny", "llama": "llama_tiny"}


@pytest.fixture(scope="module")
def weights():
    out = {}
    for family, build in JAX_BUILD.items():
        variables = build(vocab_size=VOCAB).init(
            {"params": jax.random.key(0)}, jnp.ones((2, 4), jnp.int32),
            train=False)
        out[family] = flax_params(variables)
    return out


def _prompt():
    return np.random.default_rng(0).integers(1, VOCAB, (2, 4)).astype(
        np.int32)


def _port(family, weights, impl="dense"):
    model = get_model(PORT_NAME[family], dtype=torch.float32, device="cpu",
                      vocab_size=VOCAB, attention_impl=impl)
    model.load_state_dict(params_from_flax(weights[family]))
    return model


@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("impl,use_cache", [("dense", False),
                                            ("flash", False),
                                            ("dense", True)])
def test_greedy_tokens_match_jax(weights, family, impl, use_cache):
    jmodel = JAX_BUILD[family](vocab_size=VOCAB, attention_impl=impl)
    ref = jgen.generate(jmodel, {"params": weights[family]}, _prompt(),
                        max_new_tokens=5, use_cache=use_cache)
    out = tgen.generate(_port(family, weights, impl), _prompt(),
                        max_new_tokens=5, use_cache=use_cache)
    assert out.shape == (2, 9) and out.dtype == torch.long
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampling_is_deterministic_per_generator(weights):
    model = _port("gpt", weights)

    def run(seed, use_cache=False):
        return tgen.generate(
            model, _prompt(), max_new_tokens=6, temperature=0.8, top_k=10,
            generator=torch.Generator().manual_seed(seed),
            use_cache=use_cache)

    a, b, c = run(7), run(7), run(8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    assert ((a[:, 4:] >= 0) & (a[:, 4:] < VOCAB)).all()
    # One draw per emitted token on both paths: the KV-cache path samples
    # the same tokens from the same generator state.
    torch.testing.assert_close(run(7, use_cache=True), a, rtol=0, atol=0)


def test_top_k_keeps_ties_with_the_kth_logit():
    """The rule is ``logits < kth -> -inf``: every logit tied with the k-th
    largest stays a candidate."""
    sample = tgen._make_sampler(temperature=1.0, top_k=1)
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0]]).repeat(400, 1)
    drawn = set(sample(logits, torch.Generator().manual_seed(0)).tolist())
    assert drawn == {1, 2}
    greedy = tgen._make_sampler(temperature=0.0, top_k=0)
    assert greedy(logits[:1], None).tolist() == [1]  # first max, as jnp


def test_require_decode_guards():
    model = get_model("gpt_tiny", dtype=torch.float32, device="cpu",
                      vocab_size=VOCAB)
    assert tgen.decode_capacity(model) == 128
    tgen._require_decode(model, 128)
    with pytest.raises(ValueError, match="capacity 129"):
        tgen._require_decode(model, 129)
    with pytest.raises(ValueError, match="decode"):
        tgen._require_decode(torch.nn.Linear(2, 2), 4)


def _write_npz(path, weights):
    np.savez(path, **flat_params(weights))


@pytest.mark.parametrize("family,extra", [("gpt", []),
                                          ("llama", ["--use-cache"])])
def test_cli_round_trip_matches_jax(tmp_path, weights, family, extra):
    npz = tmp_path / "params.npz"
    _write_npz(npz, weights[family])
    proc = subprocess.run(
        [sys.executable, "-m", "distributeddeeplearning_tpu_torch.generate",
         "--device", "cpu", "--model", PORT_NAME[family], "--params",
         str(npz), "--prompt-ids", "5,6,7", "--prompt-ids", "8,9,10",
         "--max-new-tokens", "4", "--attn", "flash", *extra],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-800:]
    rows = [json.loads(line)["tokens"]
            for line in proc.stdout.strip().splitlines()]
    ref = jgen.generate(JAX_BUILD[family](vocab_size=VOCAB),
                        {"params": weights[family]},
                        np.asarray([[5, 6, 7], [8, 9, 10]], np.int32),
                        max_new_tokens=4)
    assert rows == np.asarray(ref).tolist()


def test_cli_refuses_to_sample_without_weights():
    with pytest.raises(SystemExit, match="refusing"):
        cli_main(["--device", "cpu", "--model", "gpt_tiny", "--prompt-ids",
                  "1,2"])


def test_entry_points_raise_without_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("gpt_tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["--model", "gpt_tiny", "--prompt-ids", "1,2"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_nothing_of_jax():
    """No file of the port, and not chip_smoke.py, imports jax, flax or the
    JAX package (directly or through a submodule)."""
    files = sorted((REPO / "distributeddeeplearning_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    banned = ("jax", "flax", "distributeddeeplearning_tpu")
    bad = [f"{path.relative_to(REPO)}: {mod}"
           for path in files for mod in _imported_modules(path)
           if mod.split(".")[0] in banned]
    assert bad == []
