"""Serving: BN folding, the fused-block kernel and the serving engine."""

from tf_face_toolbox_tpu_torch.serving.engine import (  # noqa: F401
    build_plan,
    make_serving_apply,
)
