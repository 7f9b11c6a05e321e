"""Run configuration of the port: the subset of the JAX package's
``TrainConfig``/``DataConfig``/``OptimizerConfig``/``ParallelConfig``/
``PrecisionPolicy``/``AllReduceConfig`` (``distributeddeeplearning_tpu/
config.py``) that training of the causal LMs, BERT, the ResNets, the
DenseNets and ViT on one card, and of the image models data-parallel,
reads, with the same field names and defaults, the acceptance presets
(``preset``) and ``resolve_mlm_max_predictions``.

One default differs: ``TrainConfig.model`` is ``gpt2_small`` (the JAX
default is a ResNet); every preset names its model. The token data is
synthetic ids over the model's own vocabulary (GPT-2's 50257, Llama's
32000; BERT's is ``DataConfig.vocab_size``, as the JAX loop builds it) or
token shards, the image data synthetic NHWC images of ``image_size`` with
``num_classes`` labels or an image folder (``DataConfig.data_dir``).
``dataset`` names the corpus whose size fixes an epoch, as in the JAX
package: ``imagenet`` (1,281,167 training images, or the images of an
image-folder ``data_dir``), so such a run, token models included, has an
epoch length and the warmup is ``warmup_epochs`` of them (capped at the
run's length less one step), as the JAX schedule gives it; ``mlm`` (BERT's
presets) has none, and the warmup is 5% of the steps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout, under the JAX names. The port runs ``data`` at
    the world size of its process group (image models) and every other
    axis at 1, and refuses the rest (``train/loop.py`` ``check_layout``);
    the presets carry their layouts across so a flag can bring them to the
    run's world, as ``train.py`` lets flags override a preset."""

    data: int = 1       # dp: batch sharding, gradient all-reduce
    fsdp: int = 1       # parameter sharding along the data axis family
    model: int = 1      # tp: weight-column/row sharding
    seq: int = 1        # sp/cp: sequence-dim sharding (ring attention)
    expert: int = 1     # ep: MoE expert sharding
    pipeline: int = 1   # pp: pipeline stages


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """End-to-end mixed-precision policy: compute, master and reduction
    dtypes and dynamic loss scaling.

    - ``compute_dtype``: forward/backward activations;
    - ``param_dtype``: the master weights and optimizer state; must stay
      ``float32`` (a bf16 master drops every update below ~2^-8 of the
      weight);
    - ``reduce_dtype``: the gradient all-reduce payload of the
      data-parallel step (an explicit policy overrides
      ``AllReduceConfig.dtype`` with it, as the JAX step does);
    - ``loss_scale``: the initial dynamic loss scale, 0 = off. The loss is
      multiplied by the scale before backward and the gradients divided
      after; a non-finite scaled gradient skips the update and halves the
      scale, ``loss_scale_growth_interval`` consecutive good steps double
      it, within [``loss_scale_min``, ``loss_scale_max``]. A backoff
      reports as ``loss_scale_skip``, never as a bad step.
    """

    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    reduce_dtype: str = "bfloat16"
    loss_scale: float = 0.0
    loss_scale_growth_interval: int = 200
    loss_scale_min: float = 1.0
    loss_scale_max: float = 65536.0

    @classmethod
    def mixed(cls) -> "PrecisionPolicy":
        """The large-batch mixed arm: bf16 compute and wire, f32 masters,
        dynamic loss scaling armed at 2^15."""
        return cls(compute_dtype="bfloat16", reduce_dtype="bfloat16",
                   loss_scale=32768.0)

    @classmethod
    def fp32(cls) -> "PrecisionPolicy":
        """The reference arm: everything float32, no scaling."""
        return cls(compute_dtype="float32", reduce_dtype="float32",
                   loss_scale=0.0)

    def describe(self) -> str:
        """Compact tag, e.g. ``bf16/f32/bf16+dls32768``."""
        short = {"float32": "f32", "bfloat16": "bf16"}
        tag = (f"{short.get(self.compute_dtype, self.compute_dtype)}/"
               f"{short.get(self.param_dtype, self.param_dtype)}/"
               f"{short.get(self.reduce_dtype, self.reduce_dtype)}")
        if self.loss_scale > 0:
            tag += f"+dls{self.loss_scale:g}"
        return tag


def resolve_precision(config: "TrainConfig") -> PrecisionPolicy:
    """The run's effective policy. ``config.precision=None`` derives the
    legacy one: compute at ``config.dtype``, f32 masters and payload, no
    scaling. An explicit policy is validated here."""
    policy = config.precision
    if policy is None:
        return PrecisionPolicy(compute_dtype=config.dtype,
                               param_dtype="float32", reduce_dtype="float32",
                               loss_scale=0.0)
    for field, value in (("compute_dtype", policy.compute_dtype),
                         ("reduce_dtype", policy.reduce_dtype)):
        if value not in ("float32", "bfloat16"):
            raise ValueError(
                f"PrecisionPolicy.{field}={value!r}: use 'float32' or "
                f"'bfloat16'")
    if policy.param_dtype != "float32":
        raise ValueError(
            f"PrecisionPolicy.param_dtype={policy.param_dtype!r}: master "
            f"weights must stay float32 — a bf16 master silently drops "
            f"every update below ~2^-8 of the weight magnitude "
            f"(docs/mixed_precision.md)")
    if policy.loss_scale < 0:
        raise ValueError(f"loss_scale must be >= 0 "
                         f"(got {policy.loss_scale})")
    if policy.loss_scale > 0:
        if policy.loss_scale_growth_interval < 1:
            raise ValueError("loss_scale_growth_interval must be >= 1")
        if not (0 < policy.loss_scale_min <= policy.loss_scale
                <= policy.loss_scale_max):
            raise ValueError(
                f"need 0 < loss_scale_min <= loss_scale <= loss_scale_max "
                f"(got {policy.loss_scale_min} / {policy.loss_scale} / "
                f"{policy.loss_scale_max})")
    return policy


@dataclasses.dataclass(frozen=True)
class AllReduceConfig:
    """Gradient all-reduce policy of the data-parallel step
    (``parallel/collectives.py``): gradients packed into size-targeted
    buckets, one collective per bucket instead of one per parameter."""

    bucket_mb: float = 4.0        # fusion-buffer target size; 0 = per-leaf
                                  # reduction (the unfused A/B baseline)
    dtype: str = "float32"        # reduction payload: float32 (grads' own
                                  # dtype) | bfloat16 (half the wire bytes;
                                  # fp32 masters restored after the reduce)
    algorithm: str = "psum"       # psum (one all-reduce) | ring
                                  # (reduce-scatter + all-gather)

    def describe(self) -> str:
        mode = (f"fused bucket_mb={self.bucket_mb:g}" if self.bucket_mb > 0
                else "per-leaf")
        return f"{mode} dtype={self.dtype} algo={self.algorithm}"


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer + schedule (SGD-momentum default; LARS for large-batch
    ResNet, LAMB for large-batch transformers)."""

    name: str = "sgd"             # sgd | lars | adamw | lamb
    learning_rate: float = 0.1    # for the reference batch size (256)
    reference_batch: int = 256    # linear-scaling rule base
    momentum: float = 0.9
    weight_decay: float = 1e-4
    warmup_epochs: float = 5.0
    schedule: str = "warmup_cosine"  # constant | linear | warmup_cosine |
                                     # warmup_poly
    label_smoothing: float = 0.1  # image classification loss
    grad_clip_norm: Optional[float] = None
    # Exponential moving average of the parameters (0 = off); when on,
    # every held-out eval scores the EMA weights.
    ema_decay: float = 0.0
    trust_coefficient: float = 0.001  # LARS
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline settings (``data/__init__.py`` routes them)."""

    dataset: str = "imagenet"     # fixes the epoch length: imagenet, or
                                  # mlm (no epoch)
    data_dir: Optional[str] = None  # an image folder (<split>/<wnid>/
                                  # *.JPEG) or token shards (<split>-*.npy)
    synthetic: bool = True        # made on the device; a data_dir is read
                                  # only when this is off
    synthetic_learnable: bool = False  # embed a class signal in synthetic
                                  # images (top-1 becomes meaningful)
    loader: str = "auto"          # auto | native (the C++ image-folder
                                  # loader) | tf | grain (later slices)
    image_size: int = 224
    num_classes: int = 1000
    shuffle_buffer: int = 16384   # tf.data's (a later slice); kept for the
                                  # presets
    prefetch_depth: int = 2       # batches the host stream reads ahead;
                                  # the native loader's ring holds one more
    # Per-batch watchdog of a streamed source: a pull that exceeds the
    # timeout is retried up to loader_retries times, then the run fails
    # with "loader stalled". 0 = off.
    loader_timeout_s: float = 0.0
    loader_retries: int = 2
    seq_len: int = 128
    # BERT's masked-LM batches from token shards (data/tokens.py): ids of
    # this vocabulary, masked at this rate; mlm_max_predictions > 0 gives
    # fixed-width (masked_positions, masked_labels). The causal LMs read
    # their own vocabulary from the model.
    vocab_size: int = 30522
    mlm_mask_prob: float = 0.15
    mlm_max_predictions: int = 0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """One training run: on one card, or data-parallel over the ranks of a
    ``torch.distributed`` process group."""

    model: str = "gpt2_small"
    global_batch_size: int = 32
    num_epochs: float = 90.0
    steps_per_epoch: Optional[int] = None  # derived from the dataset if None
    total_steps: Optional[int] = None      # overrides epochs when set
    dtype: str = "bfloat16"       # compute dtype; parameters stay float32.
                                  # Subsumed by ``precision`` when set
    precision: Optional[PrecisionPolicy] = None  # None derives the legacy
                                  # policy from ``dtype`` (resolve_precision)
    batch_ramp: Optional[str] = None  # staged global-batch ramp, e.g.
                                  # "256:600,512": stages of batch[:steps],
                                  # the last (no :steps) to the horizon and
                                  # equal to global_batch_size; the lr
                                  # follows the linear-scaling rule a stage
    grad_accum_steps: int = 1     # microbatches per optimizer step (of
                                  # each rank's shard)
    sync_bn: bool = False         # cross-replica BatchNorm statistics
    seed: int = 0
    log_every: int = 100
    eval_every_epochs: float = 1.0
    checkpoint_dir: Optional[str] = None
    checkpoint_every_steps: int = 5000
    resume: bool = True
    bad_step_guard: bool = False  # skip an update whose loss or gradient
                                  # is not finite
    bad_step_limit: int = 10      # abort after this many consecutive skips
    attention_impl: Optional[str] = None  # None = the model's default
    fused_bn: bool = False        # BatchNorm through the CUDA kernels (CNNs)
    fused_block: bool = False     # bottleneck 1x1 convs through the matmul+
                                  # BatchNorm kernels (ResNet-50/101/152)
    fused_conv3: bool = False     # with fused_block: stride-1 3x3s through
                                  # the conv+BatchNorm kernels
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    allreduce: AllReduceConfig = dataclasses.field(
        default_factory=AllReduceConfig)

    @property
    def per_device_batch(self) -> int:
        """The global batch over the data-parallel shards, which must
        divide it, as must ``grad_accum_steps`` the shard's batch (JAX's
        messages, with the flag that sets each)."""
        shards = self.parallel.data * self.parallel.fsdp
        if self.global_batch_size % max(shards, 1):
            raise ValueError(
                f"global_batch_size={self.global_batch_size} not divisible by "
                f"data-parallel shards={shards} (--dp {self.parallel.data})")
        per_device = self.global_batch_size // max(shards, 1)
        if self.grad_accum_steps > 1 and per_device % self.grad_accum_steps:
            raise ValueError(
                f"per-device batch {per_device} not divisible by "
                f"grad_accum_steps={self.grad_accum_steps} "
                f"(--accum {self.grad_accum_steps})")
        return per_device

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def resolve_mlm_max_predictions(value: int, seq_len: int,
                                objective: str = "mlm") -> int:
    """The gather head's width, as the JAX package's function of the same
    name resolves it: -1 is the canonical ``round(0.15 * seq_len)`` for the
    mlm objective and 0 (the dense head) for any other; an explicit value
    is clamped to ``seq_len`` (at most that many positions can be masked),
    and 0 for a model that is not masked-LM."""
    if value >= 0:
        return min(value, seq_len) if objective == "mlm" else 0
    return int(round(0.15 * seq_len)) if objective == "mlm" else 0


def preset(name: str) -> TrainConfig:
    """One of the acceptance configurations by name, as the JAX package's
    ``config.preset`` builds it (fields the port does not carry left
    out)."""
    if name == "resnet50_synthetic":
        return TrainConfig(model="resnet50", global_batch_size=32,
                           data=DataConfig(synthetic=True))
    if name == "resnet50_dp":
        return TrainConfig(model="resnet50", global_batch_size=256,
                           parallel=ParallelConfig(data=8),
                           data=DataConfig(synthetic=False))
    if name == "resnet152_dp":
        return TrainConfig(model="resnet152", global_batch_size=256,
                           parallel=ParallelConfig(data=8))
    if name == "densenet121_dp":
        return TrainConfig(model="densenet121", global_batch_size=256,
                           parallel=ParallelConfig(data=8))
    if name == "bert_base_mlm":
        return TrainConfig(
            model="bert_base", global_batch_size=256,
            parallel=ParallelConfig(data=8),
            data=DataConfig(dataset="mlm", seq_len=128),
            optimizer=OptimizerConfig(
                name="adamw", learning_rate=1e-4, weight_decay=0.01,
                schedule="linear", warmup_epochs=0.0, label_smoothing=0.0))
    if name == "bert_base_mlm_longctx":
        return TrainConfig(
            model="bert_base", global_batch_size=32,
            parallel=ParallelConfig(data=2, seq=4),
            attention_impl="ring",
            data=DataConfig(dataset="mlm", seq_len=2048),
            optimizer=OptimizerConfig(
                name="adamw", learning_rate=1e-4, weight_decay=0.01,
                schedule="linear", warmup_epochs=0.0, label_smoothing=0.0))
    if name == "resnet50_lars_32k":
        # Batch 32k as 8-way data parallelism x 16 microbatches an update;
        # peak lr 29.0 at batch 32k, so the linear-scaling rule is the
        # identity here.
        return TrainConfig(
            model="resnet50", global_batch_size=32768, dtype="bfloat16",
            grad_accum_steps=16,
            parallel=ParallelConfig(data=8),
            optimizer=OptimizerConfig(
                name="lars", learning_rate=29.0, reference_batch=32768,
                momentum=0.9, weight_decay=1e-4, warmup_epochs=5.0,
                schedule="warmup_poly", label_smoothing=0.1))
    raise KeyError(f"unknown preset {name!r}; have {', '.join(PRESETS)}")


PRESETS = (
    "resnet50_synthetic", "resnet50_dp", "resnet152_dp", "densenet121_dp",
    "bert_base_mlm", "bert_base_mlm_longctx", "resnet50_lars_32k",
)
