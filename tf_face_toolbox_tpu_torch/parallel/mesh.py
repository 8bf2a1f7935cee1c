"""Process topology: one process a GPU, the data axis over all of them.

Counterpart of ``tf_face_toolbox_tpu/parallel/mesh.py``. JAX builds a
(data, model) device mesh inside one program; here each process is one
replica of the ``data`` axis (rank r of ``data``), launched by torchrun,
and ``Topology`` says where this process sits. The ``model`` axis (the
class-sharded Partial-FC head) must be 1: more raises naming ROADMAP.md
§1 item 11.

Axis names, kept for readers of the JAX package:

- ``data``: data parallelism. Each rank takes its own rows of the global
  batch; gradients and BN running statistics are averaged over it
  (``parallel/collectives.py``).
- ``model``: class sharding of the margin-softmax head (item 11).

Multi-node runs keep the JAX multi-slice mesh's rule
(``create_multislice_mesh``): ranks split into equal nodes and are
numbered node-major, as torchrun numbers them, so the one all-reduce of
the step can be split by NCCL into a reduction inside each node and one
exchange across them.
"""

from __future__ import annotations

import collections
import dataclasses
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Topology:
    """This process's place: ``rank`` of ``data`` ranks, ``local_rank`` on
    its node, ``nodes`` equal nodes (rank r on node r // (data / nodes)),
    and the ``device`` it trains on."""
    rank: int = 0
    local_rank: int = 0
    data: int = 1
    model: int = 1
    nodes: int = 1
    device: torch.device = torch.device("cpu")

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def distributed(self) -> bool:
        """More than one replica: the collectives exchange (at one they
        are the identity)."""
        return self.data > 1


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


def create_topology(world: int, *, model: int = 1, rank: int = 0,
                    local_rank: int | None = None, nodes: int = 0,
                    node_ids=None, device="cpu") -> Topology:
    """A topology of ``world`` ranks, all on the data axis, as the JAX
    ``create_mesh`` puts every device on it. ``model`` > 1 raises naming
    item 11 once the layout checks pass."""
    if world % model:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    n = node_layout(world, nodes=nodes, node_ids=node_ids, model=model)
    if model > 1:
        raise NotImplementedError(
            f"a model axis of {model} (the class-sharded Partial-FC head) "
            "is not ported yet (ROADMAP.md §1 item 11)")
    return Topology(rank=rank, local_rank=rank if local_rank is None
                    else local_rank, data=world, nodes=n,
                    device=torch.device(device))


def init_distributed(device="cuda", *, nodes: int = 0,
                     backend: str | None = None) -> Topology:
    """Join the process group torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    and return this process's topology.

    ``device`` "cuda" means ``cuda:<LOCAL_RANK>``; an explicit index is
    kept (several ranks may share one card over gloo). ``backend``:
    NCCL on CUDA devices and gloo on the CPU by default. ``nodes``: the
    node count to check (``--mesh_slices``); the ranks' nodes come from
    LOCAL_WORLD_SIZE.
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
    return create_topology(world, rank=rank, local_rank=local_rank,
                           nodes=nodes,
                           node_ids=[r // local_world for r in range(world)],
                           device=dev)


def local_batch_size(global_batch: int, mesh: Topology) -> int:
    n = mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"data-parallel size {n}")
    return global_batch // n
