"""Import a TF/Keras model file into the ``.npz`` key space.

Counterpart of ``tf_face_toolbox_tpu/cli/import_keras.py``: load a
Keras model (.keras / .h5) whose architecture matches one of the
backbones (e.g. one built with ``interop.build_keras_resnet``, or the
reference's network re-saved through Keras), port every weight (BN
moving statistics included) and write a portable .npz that
``cli.extract --variables_npz`` serves:

    python -m tf_face_toolbox_tpu_torch.cli.import_keras \\
        --keras_model=/models/face_r50.keras --output=/models/r50.npz \\
        --network=resnet_v1_50 --stem=face
    python -m tf_face_toolbox_tpu_torch.cli.extract \\
        --variables_npz=/models/r50.npz --data=... --output=...

The port is total-consumption checked against the port's own network
(``create_network``, ``interop.port.jax_leaves``): any architecture
drift between the Keras file and the named backbone fails with the
missing layer paths. Needs TensorFlow on the host; touches no device.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--keras_model", required=True, help=".keras/.h5 model file")
    p.add_argument("--output", required=True, help="output .npz variables path")
    p.add_argument("--network", default="resnet_v1_50", help="backbone name")
    p.add_argument("--stem", default="face",
                   choices=["face", "imagenet", "space2depth"],
                   help="backbone stem matching the Keras model")
    p.add_argument("--head", default="gap", choices=["gap", "flatten"],
                   help="embedding head variant")
    p.add_argument("--embedding_dim", type=int, default=512,
                   help="embedding size")
    p.add_argument("--image_size", type=int, default=112,
                   help="input size for shape checks")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import numpy as np
    import tensorflow as tf

    from tf_face_toolbox_tpu_torch.interop.port import (
        flatten_variables, jax_variables, keras_to_jax, save_variables_npz)
    from tf_face_toolbox_tpu_torch.models import create_network

    model = tf.keras.models.load_model(args.keras_model, compile=False)
    net = create_network(args.network, embedding_dim=args.embedding_dim,
                         stem=args.stem, head_variant=args.head,
                         input_size=args.image_size)
    variables = keras_to_jax(model, jax_variables(net))
    save_variables_npz(args.output, variables)
    n = sum(np.asarray(v).size for v in flatten_variables(variables).values())
    print(f"imported {n:,} weights from {args.keras_model} "
          f"into {args.output}")


if __name__ == "__main__":
    main()
