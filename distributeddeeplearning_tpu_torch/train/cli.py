"""Training CLI of the PyTorch port: causal-LM and ResNet training on one
card.

    python -m distributeddeeplearning_tpu_torch.train --model gpt2_small \
        --batch-size 16 --seq-len 1024 --attn flash --synthetic --steps 100
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --batch-size 512 --synthetic --fused-bn --steps 100
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --batch-size 512 --synthetic --fused-block --steps 100
    python -m distributeddeeplearning_tpu_torch.train --model resnet50 \
        --batch-size 512 --synthetic --fused-block --fused-conv3 --steps 100

The counterpart of the root ``train.py`` for these models, with its flags
where they apply. Data is synthetic token ids or images made on the device;
weights start random from ``--seed``. Prints one JSON metric line per log
step and a final ``{"summary": ...}`` line. Runs on the GPU unless
``--device cpu`` is given. Flags of later slices (data parallelism and
SyncBN, accumulation, mixed precision with loss scaling, model
parallelism, ZeRO) raise instead of being ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.models import model_spec

# Flags of train.py that this slice does not carry, and the slice that
# brings each: (flag, value that is a no-op, later slice).
_LATER = (
    ("dp", 1, "data parallelism over NCCL with the bucket plan"),
    ("accum", 1, "gradient accumulation, with data parallelism"),
    ("tp", 1, "tensor parallelism"),
    ("sp", 1, "sequence parallelism (ring/zigzag attention)"),
    ("pp", 1, "pipeline parallelism"),
    ("precision", None, "mixed precision with dynamic loss scaling"),
    ("optimizer_sharding", None, "ZeRO optimizer sharding"),
    ("sync_bn", False, "data parallelism (cross-replica BatchNorm "
     "statistics)"),
    ("data_dir", None, "real token data"),
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="gpt2_small",
                   help="registry name (gpt2_small, llama_tiny, ...)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="global batch (examples per step)")
    p.add_argument("--steps", type=int, required=True)
    p.add_argument("--seq-len", type=int, default=None)
    p.add_argument("--image-size", type=int, default=None,
                   help="side of the synthetic images (default 224)")
    p.add_argument("--num-classes", type=int, default=None,
                   help="classes of an image model (default 1000)")
    p.add_argument("--fused-bn", action="store_true",
                   help="BatchNorm(+residual)+ReLU through the CUDA kernels "
                        "(ops/fused_batchnorm.py); image models")
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
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"],
                   help="compute dtype; parameters stay float32")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--warmup-steps", type=int, default=2,
                   help="steps excluded from throughput timing")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic token ids or images (the only data the "
                        "port has)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=None)
    p.add_argument("--no-resume", action="store_true",
                   help="ignore existing checkpoints")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    for flag, default, _ in _LATER:
        name = "--" + flag.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(name, action="store_true",
                           help=argparse.SUPPRESS)
        else:
            p.add_argument(name, type=int if default == 1 else str,
                           default=default, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def build_config(args: argparse.Namespace) -> TrainConfig:
    for flag, default, later in _LATER:
        value = getattr(args, flag)
        if value != default:
            raise SystemExit(f"--{flag.replace('_', '-')} {value}: not "
                             f"carried by the port yet; it comes with "
                             f"{later}")
    if args.steps <= 0:
        raise SystemExit(f"--steps must be positive (got {args.steps})")
    for flag in ("image_size", "num_classes"):
        value = getattr(args, flag)
        if value is not None and value <= 0:
            raise SystemExit(f"--{flag.replace('_', '-')} must be positive "
                             f"(got {value})")
    for flag in ("fused_bn", "fused_block"):
        if getattr(args, flag) and \
                model_spec(args.model).input_kind != "image":
            raise SystemExit(f"--{flag.replace('_', '-')}: {args.model} has "
                             f"no BatchNorm; the fused kernels serve the "
                             f"image models (ResNet)")
    if args.fused_conv3 and not args.fused_block:
        raise SystemExit("--fused-conv3 requires --fused-block (it extends "
                         "the fused bottleneck's statistics plumbing)")
    cfg = TrainConfig(model=args.model, total_steps=args.steps,
                      fused_bn=args.fused_bn, fused_block=args.fused_block,
                      fused_conv3=args.fused_conv3)
    updates = {k: v for k, v in (
        ("global_batch_size", args.batch_size), ("dtype", args.dtype),
        ("seed", args.seed), ("log_every", args.log_every),
        ("checkpoint_dir", args.checkpoint_dir),
        ("checkpoint_every_steps", args.checkpoint_every),
        ("attention_impl", args.attn)) if v is not None}
    if args.no_resume:
        updates["resume"] = False
    data = {k: v for k, v in (("seq_len", args.seq_len),
                              ("image_size", args.image_size),
                              ("num_classes", args.num_classes)) if v}
    if data:
        updates["data"] = dataclasses.replace(cfg.data, **data)
    opt = {k: v for k, v in (("name", args.optimizer),
                             ("learning_rate", args.lr)) if v is not None}
    if opt:
        updates["optimizer"] = dataclasses.replace(cfg.optimizer, **opt)
    return cfg.replace(**updates)


def main(argv=None) -> int:
    args = parse_args(argv)
    config = build_config(args)
    from distributeddeeplearning_tpu_torch.train import loop

    loop.run(config, device=args.device, warmup_steps=args.warmup_steps,
             emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
