"""Training CLI of the PyTorch port: causal-LM, BERT masked-LM, ResNet,
DenseNet and ViT training on one card, or data-parallel over the ranks of
a ``torchrun`` launch, with gradient accumulation either way.

    python -m distributeddeeplearning_tpu_torch.train --model gpt2_small \
        --batch-size 16 --seq-len 1024 --attn flash --synthetic --steps 100
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --batch-size 512 --synthetic --fused-bn --steps 100
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --batch-size 512 --synthetic --fused-block --steps 100
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --batch-size 512 --synthetic --fused-block --fused-conv3 --steps 100
    python -m distributeddeeplearning_tpu_torch.train --config \
        densenet121_dp --dp 1 --synthetic --precision mixed --ema-decay \
        0.999 --eval-batches 2 --steps 100
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --fused-block --fused-conv3 --precision mixed --optimizer lars \
        --batch-ramp 256:300,512 --batch-size 512 --checkpoint-dir ckpt \
        --checkpoint-every 300 --synthetic --steps 1000
    python -m torch.distributed.run --standalone --nproc-per-node 8 -m \
        distributeddeeplearning_tpu_torch.train --config resnet50_dp \
        --fused-block --fused-conv3 --sync-bn --synthetic --steps 100
    python -m distributeddeeplearning_tpu_torch.train --config \
        resnet50_lars_32k --dp 1 --accum 64 --fused-block --fused-conv3 \
        --synthetic --steps 10
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --batch-size 512 --fused-block --fused-conv3 --data-dir IMAGES \
        --eval-batches 10 --steps 1000
    python -m distributeddeeplearning_tpu_torch.train --model gpt2_small \
        --batch-size 16 --seq-len 1024 --attn flash --data-dir SHARDS \
        --steps 1000
    python -m distributeddeeplearning_tpu_torch.train --config \
        bert_base_mlm --dp 1 --attn flash --synthetic --steps 100
    python -m distributeddeeplearning_tpu_torch.train --config \
        bert_base_mlm --dp 1 --attn flash --data-dir SHARDS \
        --mlm-max-predictions -1 --steps 1000
    python -m distributeddeeplearning_tpu_torch.train --model vit_b16 \
        --batch-size 256 --synthetic --attn flash --steps 100
    python -m torch.distributed.run --standalone --nproc-per-node 8 -m \
        distributeddeeplearning_tpu_torch.train --config bert_base_mlm \
        --attn flash --synthetic --steps 100
    python -m distributeddeeplearning_tpu_torch.train --config \
        bert_base_mlm --dp 1 --accum 8 --attn flash --synthetic --steps 100

The counterpart of the root ``train.py`` for these models, with its flags
where they apply: a preset by name (``--config``, ``--list-configs``)
whose fields the flags override, precision policies with dynamic loss
scaling, sgd/lars/adamw/lamb, an EMA of the weights, a staged batch ramp,
held-out eval (``--eval-batches``, ``--eval-only``), the bad-step guard,
data parallelism (``--dp N`` under ``torchrun --nproc-per-node N``: NCCL
on the card, gloo with ``--device cpu``; the bucketed gradient all-reduce,
``--allreduce-*``; ``--sync-bn`` for image models; a token model's loss is
the mean over the global batch's scored tokens, as the JAX package's GSPMD
step takes it), gradient accumulation (``--accum``) and
a profile of a few steps (``--profile-steps``). Data is synthetic token ids
(masked-LM batches for BERT) or images made on the device
(``--synthetic``, the default), or read from ``--data-dir``: an image
folder (``train/<wnid>/*.JPEG``, ``val/`` for eval) through the C++
loader, or token shards (``train-*.npy``, ``validation-*.npy``; masked on
the host for BERT, whose gather head ``--mlm-max-predictions`` sets), each
rank reading its own rows; weights start random from ``--seed``. Rank 0
prints one JSON metric line per log step and a final ``{"summary": ...}``
line. Runs on the GPU unless ``--device cpu`` is given. Without
``--steps`` an image run lasts ``--epochs`` epochs of ImageNet, or of the
image folder. Flags, models and presets of later slices (a mesh axis other
than data above 1, ring attention, MoE and pipelined models, ZeRO,
TFRecords, grain) raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

from distributeddeeplearning_tpu_torch import config as cfglib
from distributeddeeplearning_tpu_torch.models import model_spec
from distributeddeeplearning_tpu_torch.parallel.process_group import (
    launch_world)
from distributeddeeplearning_tpu_torch.train import loop
from distributeddeeplearning_tpu_torch.train.checkpoint import Checkpointer
from distributeddeeplearning_tpu_torch.train.optim import check_ema_decay

# Flags of train.py that this slice does not carry, and the slice that
# brings each: (flag, value that is a no-op, later slice).
_LATER = (
    ("optimizer_sharding", None, "ZeRO optimizer sharding"),
)
# Mesh flags: each overrides an axis of the config's ParallelConfig; the
# loop takes --dp at the world size and refuses the others above 1
# (train/loop.py check_layout).
_MESH = (("dp", "data"), ("tp", "model"), ("sp", "seq"), ("pp", "pipeline"))


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default=None,
                   help="acceptance-config preset name (see --list-configs)")
    p.add_argument("--list-configs", action="store_true")
    p.add_argument("--model", default=None,
                   help="registry name (gpt2_small, resnet50, densenet121, "
                        "...); default gpt2_small, or the preset's")
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (examples per step)")
    p.add_argument("--steps", type=int, default=None,
                   help="total train steps (overrides --epochs)")
    p.add_argument("--epochs", type=float, default=None)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None,
                   help="side of the synthetic images, or the decode and "
                        "crop target of an image folder's (default 224)")
    p.add_argument("--mlm-max-predictions", type=int, default=None,
                   help="BERT's gather head: project only this many masked "
                        "positions to the vocabulary; -1 = auto "
                        "(round(0.15 * seq_len)); 0 or unset = dense logits "
                        "over the whole sequence")
    p.add_argument("--num-classes", type=int, default=None,
                   help="classes of an image model (default 1000)")
    p.add_argument("--fused-bn", action="store_true",
                   help="BatchNorm(+residual)+ReLU through the CUDA kernels "
                        "(ops/fused_batchnorm.py); ResNets")
    p.add_argument("--fused-block", action="store_true",
                   help="bottleneck 1x1 convolutions with their BatchNorm "
                        "work through the CUDA matmul kernels "
                        "(ops/fused_linear_bn.py); ResNet-50/101/152")
    p.add_argument("--fused-conv3", action="store_true",
                   help="with --fused-block: each stride-1 3x3 with bn1's "
                        "apply and bn2's statistics through the CUDA conv "
                        "kernels (ops/fused_conv_bn.py)")
    p.add_argument("--attn", default=None, choices=["dense", "flash"],
                   help="attention impl: dense, or the flash kernels")
    p.add_argument("--optimizer", default=None,
                   choices=["sgd", "lars", "adamw", "lamb"])
    p.add_argument("--lr", type=float, default=None,
                   help="base learning rate at the reference batch (256)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="EMA of the weights at this decay (0 = off); every "
                        "eval scores the EMA weights")
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="compute dtype; parameters stay float32")
    p.add_argument("--precision", default=None, choices=["fp32", "mixed"],
                   help="precision policy: 'mixed' = bf16 compute, f32 "
                        "masters, dynamic loss scaling from 2^15; 'fp32' = "
                        "everything float32; sets --dtype")
    p.add_argument("--batch-ramp", default=None, metavar="SPEC",
                   help="staged global-batch ramp, e.g. '256:300,512': 300 "
                        "steps at 256, then --batch-size; boundaries on the "
                        "checkpoint cadence when checkpointing")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--warmup-steps", type=int, default=2,
                   help="steps excluded from throughput timing")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic token ids or images made on the device "
                        "(the default; --data-dir overrides it)")
    p.add_argument("--data-dir", default=None,
                   help="read the data from here: an image folder "
                        "(train/<wnid>/*.JPEG, val/ for eval) or token "
                        "shards (train-*.npy, validation-*.npy)")
    p.add_argument("--loader", default=None,
                   choices=["auto", "native", "tf", "grain"],
                   help="pipeline of an image --data-dir: auto (the native "
                        "C++ loader for a folder), native; tf and grain "
                        "come with later slices")
    p.add_argument("--loader-timeout", type=float, default=None,
                   help="data watchdog: seconds to wait per host batch "
                        "before retrying (0 = watchdog off, the default)")
    p.add_argument("--loader-retries", type=int, default=None,
                   help="data watchdog: retries per batch before declaring "
                        "the loader stalled (default 2)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--no-resume", action="store_true",
                   help="ignore existing checkpoints")
    p.add_argument("--eval-batches", type=int, default=0,
                   help="periodic + final held-out eval over N batches "
                        "(top-1 for image models, loss and perplexity for "
                        "token models)")
    p.add_argument("--eval-every-epochs", type=float, default=None,
                   help="periodic-eval cadence in epochs (default 1.0)")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the newest checkpoint and evaluate without "
                        "training (needs --checkpoint-dir and "
                        "--eval-batches)")
    p.add_argument("--bad-step-guard", action="store_true",
                   help="skip an update whose loss or gradient is not "
                        "finite")
    p.add_argument("--bad-step-limit", type=int, default=None,
                   help="abort after K consecutive skipped updates "
                        "(default 10)")
    p.add_argument("--accum", type=int, default=None,
                   help="gradient-accumulation microbatches per update: "
                        "each rank's shard splits into this many "
                        "consecutive row blocks, their gradients summed and "
                        "divided once; a token model's microbatch loss is "
                        "the mean over its scored tokens on every rank")
    for flag, _ in _MESH:
        p.add_argument(f"--{flag}", type=int, default=None,
                       help=argparse.SUPPRESS if flag != "dp" else
                       "data-parallel size of any model: the world of a "
                       "torchrun launch (torchrun --nproc-per-node N); 1 "
                       "without torchrun")
    p.add_argument("--sync-bn", action="store_true",
                   help="cross-replica BatchNorm statistics (a mean over "
                        "the ranks, torch SyncBatchNorm semantics; image "
                        "models under torchrun, not with --fused-bn)")
    p.add_argument("--allreduce-bucket-mb", type=float, default=None,
                   help="gradient tensor-fusion bucket size in MB "
                        "(parallel/collectives.py); one collective per "
                        "bucket instead of per parameter. 0 = per-leaf "
                        "reduction (the unfused A/B baseline); default 4")
    p.add_argument("--allreduce-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="gradient all-reduce payload dtype: bfloat16 halves "
                        "the wire bytes and restores fp32 masters after the "
                        "reduce")
    p.add_argument("--allreduce-algo", default=None,
                   choices=["psum", "ring"],
                   help="per-bucket collective: one all-reduce (psum), or "
                        "the reduce-scatter + all-gather ring form")
    p.add_argument("--profile-steps", default=None, metavar="A,B",
                   help="profile steps [A,B) with torch.profiler (end it "
                        "within --warmup-steps so throughput excludes it)")
    p.add_argument("--profile-dir", default="profile",
                   help="where --profile-steps writes profile_rank<r>.json "
                        "(default ./profile)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    for flag, default, _ in _LATER:
        name = "--" + flag.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(name, action="store_true",
                           help=argparse.SUPPRESS)
        else:
            p.add_argument(name, default=default, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _positive(args, *flags) -> None:
    for flag in flags:
        value = getattr(args, flag)
        if value is not None and value <= 0:
            raise SystemExit(f"--{flag.replace('_', '-')} must be positive "
                             f"(got {value})")


def parse_profile_steps(spec: Optional[str]) -> Optional[tuple[int, int]]:
    """``--profile-steps A,B`` as (A, B) with 0 <= A < B."""
    if spec is None:
        return None
    try:
        start, stop = (int(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit(f"--profile-steps {spec!r}: expected A,B "
                         f"(steps [A,B))") from None
    if not 0 <= start < stop:
        raise SystemExit(f"--profile-steps {spec!r}: need 0 <= A < B")
    return start, stop


def build_config(args: argparse.Namespace) -> cfglib.TrainConfig:
    for flag, default, later in _LATER:
        value = getattr(args, flag)
        if value != default:
            raise SystemExit(f"--{flag.replace('_', '-')} {value}: not "
                             f"carried by the port yet; it comes with "
                             f"{later}")
    _positive(args, "steps", "image_size", "num_classes", "accum",
              "checkpoint_every", "bad_step_limit", "eval_every_epochs",
              "epochs")
    try:
        cfg = (cfglib.preset(args.config) if args.config
               else cfglib.TrainConfig())
    except KeyError as e:
        raise SystemExit(f"--config: {e.args[0]}") from None
    model = args.model or cfg.model
    try:
        spec = model_spec(model)
    except KeyError as e:
        raise SystemExit(f"--model: {e.args[0]}") from None
    for flag in ("fused_bn", "fused_block"):
        if getattr(args, flag) and spec.input_kind != "image":
            raise SystemExit(f"--{flag.replace('_', '-')}: {model} has "
                             f"no BatchNorm; the fused kernels serve the "
                             f"image models (ResNet)")
    if args.fused_conv3 and not args.fused_block:
        raise SystemExit("--fused-conv3 requires --fused-block (it extends "
                         "the fused bottleneck's statistics plumbing)")
    updates = {k: v for k, v in (
        ("model", args.model), ("global_batch_size", args.batch_size),
        ("total_steps", args.steps), ("num_epochs", args.epochs),
        ("dtype", args.dtype), ("batch_ramp", args.batch_ramp),
        ("seed", args.seed), ("log_every", args.log_every),
        ("checkpoint_dir", args.checkpoint_dir),
        ("checkpoint_every_steps", args.checkpoint_every),
        ("attention_impl", args.attn),
        ("eval_every_epochs", args.eval_every_epochs),
        ("bad_step_limit", args.bad_step_limit),
        ("grad_accum_steps", args.accum)) if v is not None}
    for flag in ("fused_bn", "fused_block", "fused_conv3", "bad_step_guard",
                 "sync_bn"):
        if getattr(args, flag):
            updates[flag] = True
    if args.precision:
        pol = (cfglib.PrecisionPolicy.mixed() if args.precision == "mixed"
               else cfglib.PrecisionPolicy.fp32())
        updates.update(precision=pol, dtype=pol.compute_dtype)
    if args.no_resume:
        updates["resume"] = False
    mesh = {axis: getattr(args, flag) for flag, axis in _MESH
            if getattr(args, flag) is not None}
    if mesh:
        updates["parallel"] = dataclasses.replace(cfg.parallel, **mesh)
    data = {k: v for k, v in (("seq_len", args.seq_len),
                              ("image_size", args.image_size),
                              ("num_classes", args.num_classes)) if v}
    if args.mlm_max_predictions is not None:
        data["mlm_max_predictions"] = cfglib.resolve_mlm_max_predictions(
            args.mlm_max_predictions, data.get("seq_len", cfg.data.seq_len),
            spec.objective)
    # train.py's precedence: --synthetic, then --data-dir, which turns
    # synthetic data off.
    if args.synthetic:
        data["synthetic"] = True
    if args.data_dir:
        if not os.path.isdir(args.data_dir):
            raise SystemExit(f"--data-dir {args.data_dir}: no such "
                             f"directory")
        data.update(data_dir=args.data_dir, synthetic=False)
    if args.loader:
        data["loader"] = args.loader
    if args.loader_timeout is not None:
        if args.loader_timeout < 0:
            raise SystemExit(f"--loader-timeout must be >= 0 "
                             f"(got {args.loader_timeout})")
        data["loader_timeout_s"] = args.loader_timeout
    if args.loader_retries is not None:
        if args.loader_retries < 0:
            raise SystemExit(f"--loader-retries must be >= 0 "
                             f"(got {args.loader_retries})")
        data["loader_retries"] = args.loader_retries
    if data:
        updates["data"] = dataclasses.replace(cfg.data, **data)
    if args.allreduce_bucket_mb is not None and args.allreduce_bucket_mb < 0:
        raise SystemExit(f"--allreduce-bucket-mb must be >= 0 "
                         f"(got {args.allreduce_bucket_mb}); 0 selects "
                         f"per-leaf reduction")
    allreduce = {k: v for k, v in (("bucket_mb", args.allreduce_bucket_mb),
                                   ("dtype", args.allreduce_dtype),
                                   ("algorithm", args.allreduce_algo))
                 if v is not None}
    if allreduce:
        updates["allreduce"] = dataclasses.replace(cfg.allreduce,
                                                   **allreduce)
    opt = {k: v for k, v in (("name", args.optimizer),
                             ("learning_rate", args.lr),
                             ("ema_decay", args.ema_decay)) if v is not None}
    if opt:
        updates["optimizer"] = dataclasses.replace(cfg.optimizer, **opt)
    cfg = cfg.replace(**updates)
    try:
        loop.check_layout(cfg, launch_world())
        cfglib.resolve_precision(cfg)
        check_ema_decay(cfg.optimizer)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return cfg


def _horizon(args, cfg: cfglib.TrainConfig) -> cfglib.TrainConfig:
    """The run's total steps: --steps, none for --eval-only, else
    --epochs (default 90) of the dataset's epoch for an image model."""
    if args.eval_only:
        if not (args.checkpoint_dir and args.eval_batches > 0):
            raise SystemExit(
                "--eval-only needs --checkpoint-dir (the model to restore) "
                "and a positive --eval-batches (how much of the held-out "
                "split to score)")
        if args.no_resume:
            raise SystemExit(
                "--eval-only with --no-resume would score freshly "
                "initialized weights; drop --no-resume")
        if args.steps is not None or args.epochs:
            raise SystemExit(
                "--eval-only trains nothing; drop --steps/--epochs "
                "(or drop --eval-only to train then eval)")
        if Checkpointer(cfg.checkpoint_dir, 0).latest_step() is None:
            raise SystemExit(
                f"--eval-only: no checkpoint found in "
                f"{cfg.checkpoint_dir!r}; refusing to score randomly "
                f"initialized weights")
        return cfg.replace(total_steps=0)
    if cfg.total_steps is not None:
        return cfg
    if model_spec(cfg.model).input_kind == "tokens":
        raise SystemExit("token models have no epoch semantics; pass "
                         "--steps")
    return cfg.replace(
        total_steps=int(cfg.num_epochs * loop.steps_per_epoch(cfg)))


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list_configs:
        print("\n".join(cfglib.PRESETS))
        return 0
    if args.eval_batches < 0:
        raise SystemExit(f"--eval-batches must be >= 0 "
                         f"(got {args.eval_batches})")
    config = _horizon(args, build_config(args))
    loop.run(config, device=args.device, warmup_steps=args.warmup_steps,
             emit=lambda line: print(line, flush=True),
             eval_batches=args.eval_batches, restore_for_eval=args.eval_only,
             profile_steps=parse_profile_steps(args.profile_steps),
             profile_dir=args.profile_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
