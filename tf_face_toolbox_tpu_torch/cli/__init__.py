"""Command-line entry points of the port (argparse, the JAX CLIs' flag names).

    python -m tf_face_toolbox_tpu_torch.cli.extract   # feature extraction
    python -m tf_face_toolbox_tpu_torch.cli.eval_lfw  # pair verification
    python -m tf_face_toolbox_tpu_torch.cli.search    # 1:N top-k matches
    python -m tf_face_toolbox_tpu_torch.cli.eval_identification  # CMC, DIR@FAR
    python -m tf_face_toolbox_tpu_torch.cli.cluster   # kNN-graph clustering
    python -m tf_face_toolbox_tpu_torch.cli.eval_templates  # IJB templates, TAR@FAR
    python -m tf_face_toolbox_tpu_torch.cli.train     # margin-softmax training
    python -m tf_face_toolbox_tpu_torch.cli.export    # one-file deployment bundle
    python -m tf_face_toolbox_tpu_torch.cli.serve     # HTTP/gRPC embedding daemon
    python -m tf_face_toolbox_tpu_torch.cli.pack      # image list -> FaceShard
    python -m tf_face_toolbox_tpu_torch.cli.merge     # FaceShards -> one
    python -m tf_face_toolbox_tpu_torch.cli.import_bin  # verification .bin
    python -m tf_face_toolbox_tpu_torch.cli.import_rec  # MXNet .rec
    python -m tf_face_toolbox_tpu_torch.cli.convert_tfrecord  # TFRecords
"""


def json_sanitize(value):
    """Replace non-finite floats with None (JSON null), recursively —
    json.dumps would otherwise emit bare NaN/Infinity tokens that
    strict RFC-8259 parsers (jq, JSON.parse) reject. Used by eval_lfw,
    whose report can contain NaN (TAR at a FAR finer than the pair set
    resolves)."""
    import math

    if isinstance(value, dict):
        return {k: json_sanitize(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [json_sanitize(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value
