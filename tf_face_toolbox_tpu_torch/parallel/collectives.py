"""The collectives of the train step, by name.

Counterpart of ``tf_face_toolbox_tpu/parallel/collectives.py``: the
trainer calls these where the JAX step calls its ``psum``/``pmean``/
``pmax``/``all_gather``. Each is built from ``all_reduce`` (SUM, or MAX
for ``model_pmax``) over one flat buffer per dtype, or from
``broadcast``: nothing else, so that gloo carries CUDA tensors as well
as NCCL does. A gather is an all-reduce SUM into a zero buffer that
holds each rank's block at its place (exact: the other ranks add
zeros). Over an axis of size 1, or with no process group, each is the
identity and launches nothing.

``mesh`` is a ``parallel.mesh.Topology`` (None: one process). The axes:
every rank (``world``), a data column (the ranks of one model index,
``mesh.data_group``) and a model row (the ranks of one data index,
``mesh.model_group``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _size(mesh, axis: str) -> int:
    if mesh is None or not dist.is_initialized():
        return 1
    return {"world": mesh.world, "data": mesh.data, "model": mesh.model}[axis]


def _group(mesh, axis: str):
    return {"world": None, "data": mesh.data_group,
            "model": mesh.model_group}[axis]


def model_sharded(mesh) -> bool:
    """The classifier is split over more than one rank of a live group."""
    return _size(mesh, "model") > 1


def _mean_(tensors: Sequence[torch.Tensor], mesh, axis: str,
           divisor: int) -> None:
    """Sum ``tensors`` over ``axis`` and divide by ``divisor``, in place."""
    if _size(mesh, axis) == 1:
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=_group(mesh, axis))
        flat.div_(divisor)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def sync_gradients(grads: Sequence[torch.Tensor], mesh) -> None:
    """The backbone's gradient exchange, in place: a sum over the model
    axis (the ranks of a model row hold complementary parts of their
    rows' gradient) and a mean over the data axis (each data row's
    gradient is of its rows' mean loss): one all-reduce over every rank,
    divided by the data size."""
    if mesh is not None:
        _mean_(grads, mesh, "world", mesh.data)


def sync_classifier_gradients(grads: Sequence[torch.Tensor], mesh) -> None:
    """The classifier shard's gradient, averaged over the data axis (its
    column of ranks) in place."""
    if mesh is not None:
        _mean_(grads, mesh, "data", mesh.data)


def sync_batch_stats(stats: Sequence[torch.Tensor], mesh) -> None:
    """BN running statistics, averaged over every rank in place, so the
    replicas never drift; the batch statistics that normalized each
    rank's rows stay its own."""
    if mesh is not None:
        _mean_(stats, mesh, "world", mesh.world)


def replicate_mean(value: torch.Tensor, mesh) -> torch.Tensor:
    """A metric's mean over every rank (a new tensor)."""
    value = value.detach().clone()
    if mesh is not None:
        _mean_([value], mesh, "world", mesh.world)
    return value


def data_pmean(value: torch.Tensor, mesh) -> torch.Tensor:
    """``value``'s mean over the data axis (a new tensor)."""
    value = value.detach().clone()
    if mesh is not None:
        _mean_([value], mesh, "data", mesh.data)
    return value


def data_psum(value: torch.Tensor, mesh) -> torch.Tensor:
    """``value``'s sum over the data axis (a new tensor, not
    differentiable): the global batch's statistics of the loss heads
    (AdaFace's norm moments, the center sums)."""
    value = value.detach().clone()
    if mesh is not None:
        _mean_([value], mesh, "data", 1)
    return value


class _ModelSum(torch.autograd.Function):
    """psum over a model row; its backward sums the cotangent over the
    row too (the transpose JAX takes inside ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def model_psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the model row, differentiable."""
    if _size(mesh, "model") == 1:
        return x
    return _ModelSum.apply(x, mesh.model_group)


def model_pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """The max of ``x`` over the model row, detached (a softmax shift,
    whose gradient is zero)."""
    x = x.detach()
    if _size(mesh, "model") == 1:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.model_group)
    return out


def _gathered(x: torch.Tensor, size: int, index: int, group) -> torch.Tensor:
    out = x.new_zeros((size * x.shape[0], *x.shape[1:]))
    out[index * x.shape[0]:(index + 1) * x.shape[0]] = x
    dist.all_reduce(out, group=group)
    return out


class _ModelGather(torch.autograd.Function):
    """The model row's blocks of ``x`` in model order (JAX's tiled
    ``all_gather``); backward sums the cotangent over the row and keeps
    this rank's block (the reduce-scatter JAX transposes it to)."""

    @staticmethod
    def forward(ctx, x, size, index, group):
        ctx.rows, ctx.index, ctx.group = x.shape[0], index, group
        return _gathered(x.detach(), size, index, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        n = ctx.rows
        return grad[ctx.index * n:(ctx.index + 1) * n], None, None, None


def model_all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of every rank of the model row, stacked on dim 0 in model
    order; differentiable where ``x`` is floating."""
    size = _size(mesh, "model")
    if size == 1:
        return x
    if x.requires_grad:
        return _ModelGather.apply(x, size, mesh.model_index,
                                  mesh.model_group)
    return _gathered(x, size, mesh.model_index, mesh.model_group)


def data_all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of every rank of the data column, stacked on dim 0 in data
    order (not differentiable)."""
    size = _size(mesh, "data")
    if size == 1:
        return x
    return _gathered(x.detach(), size, mesh.data_index, mesh.data_group)


def _device(mesh) -> torch.device:
    return mesh.device if mesh is not None else torch.device("cpu")


def broadcast_value(value: float, mesh) -> float:
    """Rank 0's ``value`` on every rank, as a float64 (an eval metric the
    other ranks did not compute, a save decision)."""
    if _size(mesh, "world") == 1:
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_device(mesh))
    dist.broadcast(t, 0)
    return float(t.item())


def any_rank(flag: bool, mesh) -> bool:
    """True on every rank when it is True on any (the all-reduce SUM of
    0/1 flags, which is their MAX once compared with 0)."""
    if _size(mesh, "world") == 1:
        return bool(flag)
    t = torch.tensor([float(bool(flag))], device=_device(mesh))
    dist.all_reduce(t)
    return t.item() > 0


def barrier(mesh) -> None:
    """Return once every rank has reached this call."""
    if _size(mesh, "world") > 1:
        t = torch.zeros(1, device=_device(mesh))
        dist.all_reduce(t)
        t.item()


def check_replicated(tensors: Sequence[torch.Tensor], mesh,
                     what: str) -> None:
    """Raise on every rank unless ``tensors`` hold the same values on every
    rank: each tensor's f64 sum and sum of squares are broadcast from
    rank 0 and compared."""
    if _size(mesh, "world") == 1:
        return
    local = torch.stack([v for t in tensors
                         for v in (t.detach().double().sum(),
                                   t.detach().double().square().sum())])
    ref = local.clone()
    dist.broadcast(ref, 0)
    if any_rank(not torch.equal(local, ref), mesh):
        raise RuntimeError(f"{what} differs across ranks: start every rank "
                           "from the same seed and the same weights")
