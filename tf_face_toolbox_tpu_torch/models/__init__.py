"""Network factory: name -> backbone module, and seeded random weights.

    net = create_network("resnet_v1_50", dtype=torch.bfloat16)
    load_jax_variables(net, random_variables(net, seed=0))
    embeddings = net(images)                       # (N, 512) float32

Only the ResNet entries of the JAX registry are ported; the others
raise NotImplementedError naming the ROADMAP.md item.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models.resnet import ResNet

# name -> (module class, fixed kwargs), as in the JAX registry
_REGISTRY: dict[str, tuple[type, dict[str, Any]]] = {
    "resnet_v1_50": (ResNet, dict(stage_sizes=(3, 4, 6, 3))),
    "resnet_v1_101": (ResNet, dict(stage_sizes=(3, 4, 23, 3))),
    "resnet_v1_152": (ResNet, dict(stage_sizes=(3, 8, 36, 3))),
    # Tiny variant for smoke tests, not a reference model.
    "resnet_tiny": (ResNet, dict(stage_sizes=(1,), width_per_group=16)),
}


def list_networks() -> list[str]:
    return sorted(_REGISTRY)


def create_network(name: str, *, embedding_dim: int = 512,
                   dtype: torch.dtype = torch.float32,
                   **overrides: Any) -> ResNet:
    """Instantiate a backbone by name (eval mode).

    ``overrides``: any ResNet field (stem, head_variant, stage_sizes,
    width_per_group, input_size, ...).
    """
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"network '{name}' is not ported (ROADMAP.md §1 items 4 and "
            f"17); available: {list_networks()}")
    cls, kwargs = _REGISTRY[name]
    net = cls(**{**kwargs, **overrides, "embedding_dim": embedding_dim,
                 "dtype": dtype})
    return net.eval()


def random_variables(net: torch.nn.Module, seed: int = 0
                     ) -> dict[str, np.ndarray]:
    """Seeded random weights as a flat dict in the JAX ``.npz`` key
    space and layouts, for runs without a checkpoint.

    BatchNorm gets non-trivial statistics (mean ~ N(0, 0.2), var ~
    U(0.5, 2)) so folding them is exercised. The last BN of each
    residual branch gets a scale of U(0.2, 0.5), as a trained net's
    branches are small against the identity; with unit scales the
    random net's activations grow block by block.
    """
    from tf_face_toolbox_tpu_torch.interop.port import jax_leaves, jax_shape

    rng = np.random.default_rng(seed)
    flat = {}
    for key, tensor, kind in jax_leaves(net):
        shape = jax_shape(tensor, kind)
        leaf = key.rsplit("/", 1)[1]
        if kind in ("conv", "dense"):
            fan_in = int(np.prod(shape[:-1]))
            gain = 2.0 if kind == "conv" else 1.0
            v = rng.standard_normal(shape) * np.sqrt(gain / fan_in)
        elif leaf == "scale":
            branch_end = "/ConvBN_2/" in key
            v = rng.uniform(0.2, 0.5, shape) if branch_end \
                else rng.uniform(0.8, 1.2, shape)
        elif leaf == "mean":
            v = rng.normal(0.0, 0.2, shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 2.0, shape)
        else:  # BN and Dense biases
            v = rng.normal(0.0, 0.1, shape)
        flat[key] = v.astype(np.float32)
    return flat
