"""Process topology: one process a GPU, on a (data, model) grid.

Counterpart of ``tf_face_toolbox_tpu/parallel/mesh.py``. JAX builds a
(data, model) device mesh inside one program; here each process is one
device of that grid, launched by torchrun, and ``Topology`` says where
this process sits. Rank r is at data index r // model and model index
r % model, the order of JAX's ``grid.reshape(data, model)``.

Axis names, kept for readers of the JAX package:

- ``data``: data parallelism. Each rank takes its own rows of the global
  batch; gradients and BN running statistics are averaged over it
  (``parallel/collectives.py``).
- ``model``: class sharding of the margin-softmax head (the Partial-FC
  head, ``parallel/sharded_softmax.py``): rank (d, m) holds classes
  [m * C_local, (m + 1) * C_local) of the classifier, and the ranks of
  one data index (a model row) share their rows' embeddings.

Each rank keeps one process group for its data column (the ranks of its
model index) and one for its model row (the ranks of its data index).

Multi-node runs keep the JAX multi-slice mesh's rule
(``create_multislice_mesh``): ranks split into equal nodes and are
numbered node-major, as torchrun numbers them, so the one all-reduce of
the step can be split by NCCL into a reduction inside each node and one
exchange across them; the model axis stays inside a node.
"""

from __future__ import annotations

import collections
import dataclasses
import os

from typing import Any

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Topology:
    """This process's place: ``rank`` of ``data * model`` ranks,
    ``local_rank`` on its node, ``nodes`` equal nodes, and the
    ``device`` it trains on. ``data_group`` / ``model_group``: the
    process groups of its data column and model row (None: every rank,
    or no group where the axis is 1 or no process group exists)."""
    rank: int = 0
    local_rank: int = 0
    data: int = 1
    model: int = 1
    nodes: int = 1
    device: torch.device = torch.device("cpu")
    data_group: Any = dataclasses.field(default=None, compare=False,
                                        repr=False)
    model_group: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        """More than one rank: the collectives exchange (at one they are
        the identity)."""
        return self.world > 1


def node_layout(world: int, *, nodes: int = 0, node_ids=None,
                model: int = 1) -> int:
    """The node count of ``world`` ranks, checked as the JAX multi-slice
    mesh checks its slices: ``node_ids`` (rank -> node; default one
    node) must be node-major; one node asked to act as ``nodes`` splits
    evenly (a virtual layout, as JAX's CPU tests use); the nodes found
    must be ``nodes`` when given, of one size, divisible by ``model``
    (the model axis stays inside a node)."""
    node_ids = [0] * world if node_ids is None else list(node_ids)
    if len(node_ids) != world:
        raise ValueError("node_ids must match the ranks")
    if any(b < a for a, b in zip(node_ids, node_ids[1:])):
        raise ValueError(f"ranks are not node-major: {node_ids} (torchrun "
                         "numbers ranks node by node)")
    by_node = collections.Counter(node_ids)
    n = nodes or len(by_node)
    if len(by_node) == 1 and n > 1:
        if world % n:
            raise ValueError(f"{world} ranks not divisible into {n} nodes")
        by_node = collections.Counter({i: world // n for i in range(n)})
    if len(by_node) != n:
        raise ValueError(f"found {len(by_node)} nodes, expected {n}")
    sizes = set(by_node.values())
    if len(sizes) != 1:
        raise ValueError(f"uneven nodes: {dict(sorted(by_node.items()))}")
    per = sizes.pop()
    if per % model:
        raise ValueError(
            f"{per} ranks a node not divisible by model={model}; the model "
            "axis must stay inside one node")
    return n


def _axis_groups(data: int, model: int, rank: int) -> tuple[Any, Any]:
    """This rank's (data column, model row) process groups. Every rank
    creates every group, in the same order (``dist.new_group`` asks it
    of them); an axis that spans every rank uses the default group."""
    if not dist.is_initialized() or data == 1 or model == 1:
        return None, None
    world = data * model
    columns = [list(range(m, world, model)) for m in range(model)]
    rows = [list(range(d * model, (d + 1) * model)) for d in range(data)]
    mine = []
    for layout in (columns, rows):
        for ranks in layout:
            group = dist.new_group(ranks)
            if rank in ranks:
                mine.append(group)
    return mine[0], mine[1]


def create_topology(world: int, *, model: int = 1, rank: int = 0,
                    local_rank: int | None = None, nodes: int = 0,
                    node_ids=None, device="cpu") -> Topology:
    """A topology of ``world`` ranks on a (world / model, model) grid, as
    the JAX ``create_mesh(model=...)`` lays its devices out. With a
    process group, it must span ``world`` ranks, and every rank must
    call this (it creates the axes' groups)."""
    if model < 1 or world % model:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    n = node_layout(world, nodes=nodes, node_ids=node_ids, model=model)
    if dist.is_initialized() and dist.get_world_size() != world:
        raise ValueError(f"a topology of {world} ranks in a process group "
                         f"of {dist.get_world_size()}")
    data_group, model_group = _axis_groups(world // model, model, rank)
    return Topology(rank=rank, local_rank=rank if local_rank is None
                    else local_rank, data=world // model, model=model,
                    nodes=n, device=torch.device(device),
                    data_group=data_group, model_group=model_group)


def init_distributed(device="cuda", *, model: int = 1, nodes: int = 0,
                     backend: str | None = None) -> Topology:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    and return this process's topology.

    ``device`` "cuda" means ``cuda:<LOCAL_RANK>``; an explicit index is
    kept (several ranks may share one card over gloo). ``backend``:
    NCCL on CUDA devices and gloo on the CPU by default. ``nodes``: the
    node count to check (``--mesh_slices``); the ranks' nodes come from
    LOCAL_WORLD_SIZE. ``model``: the model axis (``--mesh_model``).
    """
    env = os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in env]
    if missing:
        raise RuntimeError(
            f"init_distributed reads torchrun's environment, and "
            f"{', '.join(missing)} is not set: launch with `torchrun "
            "--nproc_per_node <GPUs> -m <module> ...`")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: torch sees no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, **kwargs)
    return create_topology(world, model=model, rank=rank,
                           local_rank=local_rank, nodes=nodes,
                           node_ids=[r // local_world for r in range(world)],
                           device=dev)


def local_batch_size(global_batch: int, mesh: Topology) -> int:
    """Rows a data replica (a model row of ranks shares them), as the JAX
    ``local_batch_size``."""
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel size {n}")
    return global_batch // n


def rank_batch_size(global_batch: int, mesh: Topology) -> int:
    """Rows a rank forwards: global batch / (data * model), the block
    ``rank`` of the batch (JAX shards it as ``P((data, model))``)."""
    if global_batch % mesh.world:
        raise ValueError(f"global batch {global_batch} not divisible by the "
                         f"{mesh.world} ranks ({mesh.data} x {mesh.model})")
    return global_batch // mesh.world
