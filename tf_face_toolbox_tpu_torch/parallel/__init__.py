"""Data-parallel training across processes: the topology (one process a
GPU, ``torch.distributed``), the explicit collectives of the train step,
and the plain one-process version of that step the tests hold it
against.

Counterpart of ``tf_face_toolbox_tpu/parallel/``. The JAX package's mesh
has a ``data`` and a ``model`` axis; the port serves the ``data`` axis.
A ``model`` axis above 1 (the class-sharded Partial-FC head) raises
naming ROADMAP.md §1 item 11.
"""

from tf_face_toolbox_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Topology,
    create_topology,
    init_distributed,
    local_batch_size,
    node_layout,
)
