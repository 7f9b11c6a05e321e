"""How far one float32 ResNet-50 training step is from the same step in
float64, in the JAX package and in the PyTorch port, on the CPU:

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_grad_gap.py

The measurement behind the gate of ``chip_smoke.py``'s fused-vs-unfused
steps, which holds each f32 step's gradients to the f64 step's because two
f32 orders of summation do not agree within 1e-3 a tensor. The question it
answers: is that gap the network's (JAX's f32 step is as far from its f64
step), or the port's? The test asserts the first.

Both sides start from the same weights: the port's seeded ResNet-50 (the
seed of that phase), carried to flax by ``utils/weights.py``; and take the
same batch of 32 synthetic 224x224 images. Each framework runs the unfused
model in train mode with the label-smoothed loss, once in float32 and once
in float64, and prints one JSON line: the loss of each, the gradient error
of the f32 step against the f64 step (the worst tensor relative to
max(its largest |ref|, 1e-4 of the largest of all), and the 2-norm over
all tensors relative to the f64 gradients' 2-norm), and how many ReLU and
max-pool decisions differ between the two forwards. The port's line also
holds its f32 ``fused_block`` step (the matmul kernels' plain versions on
the CPU) against the same f64 step.

Marked slow: ResNet-50 at full size in both frameworks, in float64 too.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

BATCH, IMAGE, CLASSES, SMOOTHING = 32, 224, 1000, 0.1
WEIGHT_SEED, DATA_SEED = 10, 9   # chip_smoke.py: SEED + 10, SEED + 9


def seeded_inputs():
    """(flax params, flax batch_stats, port state_dict, images, labels)."""
    import torch

    from distributeddeeplearning_tpu_torch.data.synthetic import (
        SyntheticImages)
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.utils.weights import (
        batch_stats_to_flax, params_to_flax)

    torch.manual_seed(WEIGHT_SEED)
    state = get_model("resnet50", dtype=torch.float32,
                      device="cpu").state_dict()
    batch = SyntheticImages(BATCH, IMAGE, CLASSES, DATA_SEED).batch(0)
    return (nest(params_to_flax(state)), nest(batch_stats_to_flax(state)),
            state, batch["image"].float().numpy(), batch["label"].numpy())


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = value
    return tree


def grad_errors(grads: dict, ref: dict) -> dict:
    """The worst tensor's error relative to max(its largest |ref|, 1e-4 of
    the largest of all), and the 2-norm error over all tensors relative to
    the reference's 2-norm, as ``chip_smoke.py`` takes them."""
    top = max(float(np.abs(g).max()) for g in ref.values())
    norm = float(np.sqrt(sum((g * g).sum() for g in ref.values())))
    worst = max((float(np.abs(grads[n] - g).max())
                 / max(float(np.abs(g).max()), 1e-4 * top), n)
                for n, g in ref.items())
    total = float(np.sqrt(sum(((grads[n] - g) ** 2).sum()
                              for n, g in ref.items())))
    return {"worst": worst[0], "worst_tensor": worst[1],
            "norm": total / norm}


def pool_argmax(a: np.ndarray) -> np.ndarray:
    """Which of the 9 window positions each 3x3 / stride 2 / pad 1 max-pool
    output of the NHWC ``a`` takes (the first on ties)."""
    n, h, w, c = a.shape
    p = np.pad(a, ((0, 0), (1, 1), (1, 1), (0, 0)),
               constant_values=-np.inf)
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    wins = np.stack([p[:, i:i + 2 * ho:2, j:j + 2 * wo:2]
                     for i in range(3) for j in range(3)])
    return wins.argmax(axis=0)


def decisions(acts: dict, stem: np.ndarray) -> dict:
    """{name: boolean ReLU decisions} plus the max-pool's choices."""
    out = {k: v > 0 for k, v in acts.items()}
    out["max_pool"] = pool_argmax(np.maximum(stem, 0.0))
    return out


def flips(a: dict, b: dict) -> dict:
    relu = sum(int((a[k] != b[k]).sum()) for k in a if k != "max_pool")
    total = sum(int(a[k].size) for k in a if k != "max_pool")
    return {"relu_flips": relu, "relu_decisions": total,
            "max_pool_flips": int((a["max_pool"] != b["max_pool"]).sum()),
            "max_pool_decisions": int(a["max_pool"].size)}


def run_jax(params, stats, images, labels) -> dict:
    import jax
    import jax.numpy as jnp

    from distributeddeeplearning_tpu.models import resnet as jresnet
    from distributeddeeplearning_tpu.train import losses as jlosses

    results = {}
    for name, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
        with jax.enable_x64(True):
            results[name] = _jax_step(jresnet, jlosses, dt, params, stats,
                                      images, labels)
    return results


def _jax_step(jresnet, jlosses, dt, params, stats, images, labels):
    """(loss, flat gradients, decisions) of one JAX step in ``dt``."""
    import jax
    import jax.numpy as jnp

    model = jresnet.resnet50(dtype=dt)
    p = jax.tree.map(lambda a: jnp.asarray(a, dt), params)
    s = jax.tree.map(lambda a: jnp.asarray(a, dt), stats)

    @jax.jit
    def step(p, s, x, y):
        def loss_fn(p):
            (logits, state) = model.apply(
                {"params": p, "batch_stats": s}, x, train=True,
                mutable=["batch_stats", "intermediates"],
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, (jresnet.BottleneckBlock,))
                or type(mdl).__name__ == "BatchNorm")
            return (jlosses.smoothed_softmax_ce(logits, y, SMOOTHING),
                    state["intermediates"])
        (loss, inter), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        return loss, grads, inter

    loss, grads, inter = step(p, s, jnp.asarray(images, dt),
                              jnp.asarray(labels))
    flat_inter = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat_inter[prefix + k] = np.asarray(v[0], np.float64)

    walk(jax.device_get(inter))
    # ReLU decisions: bn1, bn2 and bn_stem outputs (pre-ReLU) and each
    # block's output (post-ReLU; > 0 is the same decision).
    acts = {k: v for k, v in flat_inter.items()
            if k.split("/")[-2] in ("bn_stem", "bn1", "bn2")
            or (k.count("/") == 1 and k.startswith("stage"))}
    stem = flat_inter["bn_stem/__call__"]
    flat_grads = {}

    def walk_grads(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk_grads(v, f"{prefix}{k}/")
            else:
                flat_grads[prefix + k] = np.asarray(v, np.float64)

    walk_grads(jax.device_get(grads))
    return float(loss), flat_grads, decisions(acts, stem)


def run_torch(state, images, labels) -> dict:
    import torch
    import torch.nn.functional as F

    from distributeddeeplearning_tpu_torch.models import get_model, resnet
    from distributeddeeplearning_tpu_torch.train.losses import (
        smoothed_softmax_ce)

    results = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64),
                     ("fused_block", torch.float32)):
        model = get_model("resnet50", dtype=dt, device="cpu",
                          fused_block=name == "fused_block").train()
        model.load_state_dict(state)
        acts = {}

        def hook(mod, args, out, key=None):
            acts[key] = out.detach().permute(0, 2, 3, 1).double().numpy()

        for mname, mod in model.named_modules():
            if isinstance(mod, resnet.BatchNormAct) and mod.relu:
                mod.register_forward_hook(
                    lambda m, a, o, key=mname: hook(m, a, o, key))
        x = torch.from_numpy(images)
        loss = smoothed_softmax_ce(model(x), torch.from_numpy(labels),
                                   SMOOTHING)
        loss.backward()
        grads = {n: p.grad.double().numpy()
                 for n, p in model.named_parameters()}
        if name == "fused_block":
            results[name] = (loss.item(), grads, None)
            continue
        stem = acts["bn_stem"]   # post-ReLU: its max-pool is the same
        _, idx = F.max_pool2d(torch.from_numpy(stem).permute(0, 3, 1, 2),
                              3, 2, 1, return_indices=True)
        dec = {k: v > 0 for k, v in acts.items()}
        dec["max_pool"] = idx.numpy()
        results[name] = (loss.item(), grads, dec)
        del model
    return results


def _line(framework: str, res: dict) -> dict:
    (l32, g32, d32), (l64, g64, d64) = res["f32"], res["f64"]
    extra = {}
    if "fused_block" in res:
        extra = {"fused_block_vs_f64": grad_errors(res["fused_block"][1],
                                                   g64)}
    line = {"framework": framework, "batch": BATCH, "loss_f32": l32,
            "loss_f64": l64, "f32_vs_f64": grad_errors(g32, g64),
            **flips(d32, d64), **extra}
    print(json.dumps(line))
    return line


@pytest.mark.slow
def test_jax_f32_step_is_as_far_from_f64_as_the_ports():
    params, stats, state, images, labels = seeded_inputs()
    port = _line("torch", run_torch(state, images, labels))
    ref = _line("jax", run_jax(params, stats, images, labels))
    for key in ("worst", "norm"):
        assert ref["f32_vs_f64"][key] >= port["f32_vs_f64"][key], key
