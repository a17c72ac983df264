"""Data parallelism over `torch.distributed` ranks (counterpart of
`efg_tpu/parallel/mesh.py`).

efg_tpu shards one logical global batch over the `data` mesh axis, and XLA
compiles every batch statistic, every loss normaliser and the gradient
into sums over that global batch. Here each rank runs its own slice of the
batch eagerly, so the port holds it to the same result by hand:

- the BN layers sum their statistics over the ranks with the
  differentiable `all_reduce_sum` (`modeling/common/norms.py`);
- the loss normalisers (positive counts, box counts) are `global_sum`s,
  so each rank's loss is its local sum over the global count and the
  ranks' losses add up to efg_tpu's;
- `reduce_gradients` sums the ranks' gradients. The backward of
  `all_reduce_sum` already sums the upstream gradients of the statistics
  over the ranks, so each rank's gradient is its own share of d(Σ losses)
  and the total is their sum, not their mean;
- random draws over the batch (ConQueR's denoising noise) are made for the
  global batch and sliced (`global_batch`).

The process group comes from explicit arguments (`init_process_group`):
`nccl` when every rank has its own card, `gloo` on the CPU or when the
caller puts several ranks on one card. Nothing falls back.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from efg_tpu_torch.utils import distributed as comm

BACKENDS = ("nccl", "gloo")


def rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank `local_rank`: `cuda` maps to
    `cuda:<local_rank>`; an indexed card (`cuda:0`) or `cpu` is taken as
    given, for every rank."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", local_rank)
    return device


def init_process_group(backend: str, init_method: str, rank: int, world_size: int, device,
                       local_rank: int = 0, local_size: int = 1) -> torch.device:
    """Join the process group as `rank` of `world_size` (local rank
    `local_rank` of `local_size` on its machine) on `device`, with the
    gloo side group for objects (`utils/distributed.py`). Returns the
    device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend nccl needs a card; this rank's device is {device}")
        if device.index is None or local_size > torch.cuda.device_count():
            raise ValueError(
                f"backend nccl with {local_size} ranks on {torch.cuda.device_count()} card(s): "
                "NCCL refuses two ranks on one device; pass backend gloo to share a card")
    if device.type == "cuda":
        if device.index is None or device.index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank}: no card {device} "
                               f"({torch.cuda.device_count()} visible)")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    side = dist.new_group(backend="gloo") if backend != "gloo" else dist.group.WORLD
    comm.set_local(local_rank, local_size, side)
    return device


def destroy_process_group() -> None:
    if comm.is_initialized():
        dist.destroy_process_group()
    comm.set_local(0, 1, None)


def active() -> bool:
    """Whether several ranks share the batch."""
    return comm.get_world_size() > 1


def mesh_shape(mesh_cfg: Optional[Dict[str, Any]], world_size: int) -> Dict[str, int]:
    """The `mesh` config ({axes: [data, model], shape: [-1, 1]}) against
    the world: a `model` axis wider than 1 (tensor parallelism) is not
    ported; -1 takes every rank, and the product must be the world size
    (`build_mesh`'s check)."""
    mesh_cfg = mesh_cfg or {}
    axes = list(mesh_cfg.get("axes", ["data", "model"]))
    shape = [int(s) for s in mesh_cfg.get("shape", [-1, 1])]
    if dict(zip(axes, shape)).get("model", 1) > 1:
        raise NotImplementedError(
            "mesh: a `model` axis wider than 1 (tensor parallelism) is not ported to "
            "efg_tpu_torch yet (ROADMAP queue 1 item 5)")
    known = 1
    for s in shape:
        known *= s if s != -1 else 1
    shape = [world_size // known if s == -1 else s for s in shape]
    total = 1
    for s in shape:
        total *= s
    if total != world_size:
        raise AssertionError(f"mesh shape {shape} != {world_size} devices (ranks)")
    return dict(zip(axes, shape))


class _AllReduceSum(torch.autograd.Function):
    """Σ over the ranks; its backward is the same sum of the upstream
    gradients (d(Σ_r loss_r)/dx_r = Σ_r' ∂loss_r'/∂sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks (`x` itself in a world of
    one)."""
    return _AllReduceSum.apply(x) if active() else x


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, outside autograd: a loss
    normaliser's count (`x` itself in a world of one)."""
    if not active():
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y


def global_batch(b: int) -> Tuple[int, int]:
    """(global batch size, this rank's first row) for a local batch of
    `b` rows, every rank holding as many (the loader's slices): draws over
    the batch are made at the global size and sliced at the offset."""
    n = comm.get_world_size()
    return b * n, b * comm.get_rank()


def sum_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each value summed over the ranks, in one all-reduce: every loss
    part is a rank's share of the global value (its local sum over the
    global normaliser), and every count a local count."""
    if not active() or not metrics:
        return metrics
    keys = list(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat)
    return dict(zip(keys, flat.unbind()))


def _buckets(tensors: Sequence[torch.Tensor]) -> Dict[Tuple, List[int]]:
    out: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        out.setdefault((t.dtype, t.device), []).append(i)
    return out


@torch.no_grad()
def reduce_gradients(module: torch.nn.Module) -> None:
    """Sum every parameter's gradient over the ranks, in place, one flat
    all-reduce per dtype; a parameter without a gradient counts as zeros
    (and gets the sum), as `apply_grads` counts it. No-op in a world of
    one."""
    if not active():
        return
    params = [p for p in module.parameters() if p.requires_grad]
    for idx in _buckets(params).values():
        grads = [params[i].grad if params[i].grad is not None else torch.zeros_like(params[i])
                 for i in idx]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        off = 0
        for i in idx:
            p = params[i]
            n = p.numel()
            p.grad = flat[off:off + n].view_as(p).clone()
            off += n


@torch.no_grad()
def replicas_differ(tensors: Dict[str, torch.Tensor]) -> List[str]:
    """The names whose tensor differs, in any bit, from rank 0's: each
    is compared with rank 0's copy, broadcast one flat tensor per dtype.
    Every rank gets the same answer. Empty in a world of one."""
    if not active():
        return []
    names = list(tensors)
    vals = [tensors[n].detach() for n in names]
    bad = torch.zeros(len(names), dtype=torch.int32)
    for idx in _buckets(vals).values():
        flat = torch.cat([vals[i].reshape(-1) for i in idx])
        ref = flat.clone()
        dist.broadcast(ref, src=0)
        off = 0
        for i in idx:
            n = vals[i].numel()
            a, b = flat[off:off + n], ref[off:off + n]
            # bit for bit: NaNs compare by their bits, -0.0 against 0.0 differs
            if a.is_floating_point():
                a, b = a.view(_int_view(a.dtype)), b.view(_int_view(b.dtype))
            bad[i] = int(not torch.equal(a, b))
            off += n
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=comm._GLOO_GROUP)
    return [n for n, x in zip(names, bad.tolist()) if x]


def _int_view(dtype: torch.dtype) -> torch.dtype:
    return {2: torch.int16, 4: torch.int32, 8: torch.int64}[torch.empty((), dtype=dtype)
                                                            .element_size()]


def check_replicas_equal(module: torch.nn.Module, what: str,
                         extra: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Raise on every rank unless the module's parameters and buffers
    (and `extra`) equal rank 0's bit for bit."""
    tensors = dict(module.state_dict())
    tensors.update({f"extra.{k}": v for k, v in (extra or {}).items()})
    differ = replicas_differ(tensors)
    if differ:
        raise RuntimeError(f"{what}: rank {comm.get_rank()} differs from rank 0 in "
                           f"{len(differ)} tensors: {differ[:8]}")
