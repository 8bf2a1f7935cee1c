"""Serving: BN folding, the fused-block kernel, the serving engine, the
1:N gallery, bundles and the HTTP/gRPC daemon."""

from tf_face_toolbox_tpu_torch.serving.engine import (  # noqa: F401
    build_plan,
    make_serving_apply,
)
