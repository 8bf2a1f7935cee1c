"""The collectives of the data-parallel step, by name.

Counterpart of ``tf_face_toolbox_tpu/parallel/collectives.py``: the
trainer calls these where the JAX step calls its ``psum``/``pmean``.
Each is built from ``all_reduce(SUM)`` over one flat buffer per dtype,
divided by the data size, or from ``broadcast``: nothing else, so that
gloo carries CUDA tensors as well as NCCL does. At a data size of 1, or
with no process group, each is the identity and launches nothing.

``mesh`` is a ``parallel.mesh.Topology`` (None: one process).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _active(mesh) -> bool:
    return mesh is not None and mesh.data > 1 and dist.is_initialized()


def _pmean_(tensors: Sequence[torch.Tensor], mesh) -> None:
    """Average ``tensors`` over the data axis, in place."""
    if not _active(mesh):
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat.div_(mesh.data)
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def sync_gradients(grads: Sequence[torch.Tensor], mesh) -> None:
    """The data-parallel gradient exchange of the backbone, in place:
    each rank's gradient is of its rows' mean loss, so their mean is the
    global batch's. (JAX first sums over the model axis, which is 1
    here.)"""
    _pmean_(grads, mesh)


def sync_classifier_gradients(grads: Sequence[torch.Tensor], mesh) -> None:
    """The classifier's gradient, averaged over the data axis in place."""
    _pmean_(grads, mesh)


def sync_batch_stats(stats: Sequence[torch.Tensor], mesh) -> None:
    """BN running statistics, averaged over every replica in place, so the
    replicas never drift; the batch statistics that normalized each
    rank's rows stay its own."""
    _pmean_(stats, mesh)


def replicate_mean(value: torch.Tensor, mesh) -> torch.Tensor:
    """A metric's mean over the data axis (a new tensor)."""
    value = value.detach().clone()
    _pmean_([value], mesh)
    return value


def _device(mesh) -> torch.device:
    return mesh.device if mesh is not None else torch.device("cpu")


def broadcast_value(value: float, mesh) -> float:
    """Rank 0's ``value`` on every rank, as a float64 (an eval metric the
    other ranks did not compute, a save decision)."""
    if not _active(mesh):
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_device(mesh))
    dist.broadcast(t, 0)
    return float(t.item())


def any_rank(flag: bool, mesh) -> bool:
    """True on every rank when it is True on any (the all-reduce SUM of
    0/1 flags, which is their MAX once compared with 0)."""
    if not _active(mesh):
        return bool(flag)
    t = torch.tensor([float(bool(flag))], device=_device(mesh))
    dist.all_reduce(t)
    return t.item() > 0


def barrier(mesh) -> None:
    """Return once every rank has reached this call."""
    if _active(mesh):
        t = torch.zeros(1, device=_device(mesh))
        dist.all_reduce(t)
        t.item()


def check_replicated(tensors: Sequence[torch.Tensor], mesh,
                     what: str) -> None:
    """Raise on every rank unless ``tensors`` hold the same values on every
    rank: each tensor's f64 sum and sum of squares are broadcast from
    rank 0 and compared."""
    if not _active(mesh):
        return
    local = torch.stack([v for t in tensors
                         for v in (t.detach().double().sum(),
                                   t.detach().double().square().sum())])
    ref = local.clone()
    dist.broadcast(ref, 0)
    if any_rank(not torch.equal(local, ref), mesh):
        raise RuntimeError(f"{what} differs across ranks: start every rank "
                           "from the same seed and the same weights")
