"""Backbone variables from a port train checkpoint (flag-free).

Counterpart of ``tf_face_toolbox_tpu/pretrained.py``: the logic behind
every consumer of trained weights (``cli.extract --checkpoint_dir``,
the daemon) lives here rather than in a CLI module.
"""

from __future__ import annotations

import logging

import torch


def load_variables(checkpoint_dir: str, network: str, embedding_dim: int,
                   image_size: int, dtype: torch.dtype,
                   use_ema: bool = False, stem: str = "face",
                   head: str = "gap", quantized: bool | str = False,
                   step: int | None = None):
    """Backbone variables from a train checkpoint.

    Returns ``(net, flat)``: the network (eval mode, on the host,
    holding ``flat``; in ``quantized``'s int8 mode, and for "static" not
    yet holding it: it needs ``models.calibrate_quant_stats`` first, as
    JAX restores into the fp twin) and its variables as a flat dict in
    the JAX key space and layouts
    (``params/BottleneckBlock_0/ConvBN_0/kernel``, ...), which
    ``serving.make_serving_apply`` and ``interop.port.load_jax_variables``
    take. The port's checkpoint names every tensor, so it is read raw,
    with no template: the classifier and the loss heads' state are not
    needed to serve.
    ``use_ema`` selects the EMA weight set (with the running BN
    statistics); ``step`` pins a retained checkpoint (None = the
    latest).
    """
    from tf_face_toolbox_tpu_torch.interop.port import (
        load_jax_variables, named_to_flat)
    from tf_face_toolbox_tpu_torch.models import create_network
    from tf_face_toolbox_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(checkpoint_dir)
    meta = mgr.metadata(step)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    raw = mgr.restore_raw(meta["step"])
    params = raw["params"]
    if use_ema:
        if "ema_params" not in raw:
            raise ValueError("--use_ema set but checkpoint has no EMA")
        params = raw["ema_params"]
    flat = named_to_flat({**params, **raw["batch_stats"]})
    net = create_network(network, embedding_dim=embedding_dim, dtype=dtype,
                         stem=stem, head_variant=head, input_size=image_size,
                         quantized=quantized)
    # the classifier holds C * K rows, the center table (where one was
    # trained) C: the identity count and the sub-centers from the shapes
    rows = raw["classifier"].shape[0]
    centers = raw.get("head_state", {}).get("centers")
    num_classes = rows if centers is None else centers.shape[0]
    logging.info("restored step %d from %s (%d identities, %d sub-centers, "
                 "loss-head state %s, ema=%s)", raw["step"], checkpoint_dir,
                 num_classes, rows // num_classes,
                 sorted(mgr.head_state_children(meta)) or "none", use_ema)
    if quantized in ("static", "static_dense"):
        return net, flat
    return load_jax_variables(net, flat).eval(), flat
