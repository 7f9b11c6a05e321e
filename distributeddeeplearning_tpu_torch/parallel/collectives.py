"""Bucketed (fused) gradient all-reduce and SyncBN's cross-replica mean:
counterpart of ``distributeddeeplearning_tpu/parallel/collectives.py`` on
``torch.distributed`` (NCCL on the card, gloo on the CPU).

Reducing a CNN's gradients one parameter at a time issues one collective
per tensor (ResNet-50 has 161, many under 10 KB), so launch latency
dominates the wire time; Horovod's tensor fusion packs them into a few
size-targeted buckets instead. Here:

- :func:`plan_buckets` assigns the parameters to buckets by sorted
  parameter name, greedily up to ``bucket_bytes``, so the plan depends only
  on (name, shape, dtype), never on the order the caller lists them in.
- :func:`all_reduce` runs ONE collective per bucket: each bucket's tensors
  are flattened into one contiguous buffer in the payload dtype, summed
  across the group (``psum``: one ``all_reduce``; ``ring``: a
  reduce-scatter then an all-gather, the payload padded to a multiple of
  the world size), and written back to each tensor in its own dtype. Each
  bucket's collective runs under ``torch.profiler.record_function(
  "allreduce/bucketNN")``, so a profile names and times it.
- :func:`cross_replica_mean` is SyncBN's ``pmean``: a sum all-reduce over
  the group divided by its size, forward and backward.
- :func:`psum_` sums one small tensor over the group in place (a token
  step's counts of scored positions, the token eval's sums), under
  ``record_function("allreduce/psum")``.

The reduction runs after the backward pass, not overlapped with it (the
JAX step leaves that overlap to XLA's scheduler).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_BUCKET_MB = 4.0
_MB = 1024 * 1024
ALGORITHMS = ("psum", "ring")


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A deterministic tensor -> fusion-bucket assignment for one set of
    named tensors. ``buckets`` holds groups of indices into ``names`` (the
    order the plan was built from); membership and order follow only from
    (name, shape, dtype)."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    buckets: tuple[tuple[int, ...], ...]
    bucket_bytes: int

    @property
    def num_leaves(self) -> int:
        return len(self.names)

    def bucket_of(self, name: str) -> int:
        """Bucket index holding the tensor ``name``."""
        i = self.names.index(name)
        for b, members in enumerate(self.buckets):
            if i in members:
                return b
        raise KeyError(name)  # pragma: no cover - every leaf is assigned

    def describe(self) -> str:
        sizes = [sum(_numel(self.shapes[i]) for i in members)
                 for members in self.buckets]
        return (f"{len(self.buckets)} bucket(s) over {self.num_leaves} "
                f"leaves, elems/bucket={sizes}")


def plan_buckets(tensors: Mapping[str, Any],
                 bucket_bytes: Optional[int] = None) -> BucketPlan:
    """Assign ``tensors`` (name -> anything with ``shape`` and ``dtype``:
    tensors, meta tensors) to size-targeted fusion buckets.

    Names are visited in sorted order and packed greedily: a bucket closes
    when the next tensor would push it past ``bucket_bytes`` (a single
    oversized tensor still gets a bucket of its own). ``bucket_bytes`` <= 0
    gives one bucket per tensor, the unfused reference plan."""
    if bucket_bytes is None:
        bucket_bytes = int(DEFAULT_BUCKET_MB * _MB)
    names = tuple(tensors)
    shapes = tuple(tuple(int(d) for d in tensors[n].shape) for n in names)
    dtypes = tuple(tensors[n].dtype for n in names)
    order = sorted(range(len(names)), key=lambda i: names[i])
    buckets: list[tuple[int, ...]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i in order:
        nbytes = _numel(shapes[i]) * dtypes[i].itemsize
        if cur and (bucket_bytes <= 0 or cur_bytes + nbytes > bucket_bytes):
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(tuple(cur))
    return BucketPlan(names=names, shapes=shapes, dtypes=dtypes,
                      buckets=tuple(buckets), bucket_bytes=int(bucket_bytes))


# torch renamed the single-tensor collectives; either name takes
# (output, input, ..., group=...).
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or getattr(
    dist, "reduce_scatter_tensor", None)
_all_gather = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor", None)


def _reduce_flat(vec: torch.Tensor, group, algorithm: str,
                 world: int) -> torch.Tensor:
    """The cross-rank sum of the contiguous 1-D ``vec`` by one fused
    collective: ``psum`` sums it in place; ``ring`` reduce-scatters it
    (padded to a multiple of ``world`` so every rank owns an equal chunk)
    and all-gathers the chunks into a new tensor."""
    if algorithm == "psum" or world <= 1:
        dist.all_reduce(vec, group=group)
        return vec
    pad = (-vec.numel()) % world
    if pad:
        vec = torch.cat([vec, vec.new_zeros(pad)])
    chunk = vec.new_empty(vec.numel() // world)
    _reduce_scatter(chunk, vec, group=group)
    full = torch.empty_like(vec)
    _all_gather(full, chunk, group=group)
    return full[:full.numel() - pad] if pad else full


def all_reduce(tensors: Mapping[str, torch.Tensor], *, group=None,
               bucket_bytes: Optional[int] = None,
               payload_dtype: Optional[torch.dtype] = None,
               algorithm: str = "psum",
               plan: Optional[BucketPlan] = None
               ) -> Mapping[str, torch.Tensor]:
    """Sum every tensor of ``tensors`` across ``group`` (default: the whole
    world), in place, with one collective per fusion bucket; returns
    ``tensors``.

    Each bucket concatenates its tensors' flattened values in the payload
    dtype (``payload_dtype``, else the bucket's widest dtype, so a
    mixed-dtype bucket never downcasts), reduces once and copies each
    piece back in the tensor's own dtype. A one-tensor bucket with no
    payload policy reduces the (contiguous) tensor itself. Bucketing
    changes how many collectives launch, never which values are summed.
    ``bucket_bytes=0`` (or a plan built so) reduces per tensor."""
    if plan is None:
        plan = plan_buckets(tensors, bucket_bytes)
    if set(tensors) != set(plan.names):
        raise ValueError(
            f"plan was built for {plan.num_leaves} leaves, tree has "
            f"{len(tensors)}")
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown all-reduce algorithm {algorithm!r}; "
                         f"expected 'psum' or 'ring'")
    world = dist.get_world_size(group)
    leaves = [tensors[n] for n in plan.names]
    for b, members in enumerate(plan.buckets):
        with torch.profiler.record_function(f"allreduce/bucket{b:02d}"):
            first = leaves[members[0]]
            if (len(members) == 1 and payload_dtype is None
                    and algorithm == "psum" and first.is_contiguous()):
                dist.all_reduce(first, group=group)
                continue
            common = payload_dtype or _widest(plan.dtypes[i]
                                              for i in members)
            buf = torch.cat([leaves[i].reshape(-1).to(common)
                             for i in members])
            red = _reduce_flat(buf, group, algorithm, world)
            offset = 0
            with torch.no_grad():
                for i in members:
                    n = _numel(plan.shapes[i])
                    leaves[i].copy_(red[offset:offset + n].view(
                        plan.shapes[i]))
                    offset += n
    return tensors


def _widest(dtypes) -> torch.dtype:
    out = None
    for d in dtypes:
        out = d if out is None else torch.promote_types(out, d)
    return out


def all_reduce_gradients(grads: Mapping[str, torch.Tensor], *, group=None,
                         options=None, plan: Optional[BucketPlan] = None
                         ) -> Mapping[str, torch.Tensor]:
    """The train step's entry point: SUM ``grads`` in place across
    ``group`` by the run's ``AllReduceConfig`` (``options``; None =
    defaults). The caller divides by the world size to turn the sum into
    the gradient average."""
    bucket_mb = getattr(options, "bucket_mb", DEFAULT_BUCKET_MB)
    dtype_name = getattr(options, "dtype", "float32") or "float32"
    algorithm = getattr(options, "algorithm", "psum") or "psum"
    if dtype_name not in ("float32", "bfloat16"):
        raise ValueError(
            f"allreduce dtype {dtype_name!r} not supported; use 'float32' "
            f"(reduce in the gradients' own dtype) or 'bfloat16' "
            f"(compressed payload, fp32 master restored after the reduce)")
    payload = torch.bfloat16 if dtype_name == "bfloat16" else None
    return all_reduce(grads, group=group,
                      bucket_bytes=int(float(bucket_mb) * _MB),
                      payload_dtype=payload, algorithm=algorithm, plan=plan)


def psum_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """``tensor`` replaced in place by its sum over the ranks of ``group``
    (default: the whole world) by one all-reduce, and returned. Nothing is
    read on the host: on the card the sum is queued on the stream like any
    kernel."""
    with torch.profiler.record_function("allreduce/psum"):
        dist.all_reduce(tensor, group=group)
    return tensor


class _CrossReplicaMean(torch.autograd.Function):
    """pmean: forward and backward are both a sum all-reduce over the group
    divided by its size. Each rank's loss reads the same mean, so the
    cotangent of its own contribution is the mean of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad / dist.get_world_size(ctx.group), None


def cross_replica_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (default: the whole
    world), differentiable. Raises outside an initialised process group:
    SyncBN never falls back to per-replica statistics."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "cross-replica BatchNorm (sync_bn / bn_axis_name) needs an "
            "initialised torch.distributed process group; launch with "
            "torchrun (python -m torch.distributed.run --nproc-per-node N "
            "...) or drop --sync-bn")
    return _CrossReplicaMean.apply(x, group)
