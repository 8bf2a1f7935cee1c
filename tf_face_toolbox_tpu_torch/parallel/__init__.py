"""Training across processes: the topology (one process a GPU on a
(data, model) grid, ``torch.distributed``), the explicit collectives of
the train step, the class-sharded Partial-FC head, and the plain
one-process version of that step the tests hold it against.

Counterpart of ``tf_face_toolbox_tpu/parallel/``: the ``data`` axis
averages gradients; the ``model`` axis shards the classifier's classes
(``sharded_softmax.py``).
"""

from tf_face_toolbox_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Topology,
    create_topology,
    init_distributed,
    local_batch_size,
    node_layout,
    rank_batch_size,
)
