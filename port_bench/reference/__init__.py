"""Plain PyTorch references, f32 with TF32 off, for the benchmark's
check of correctness.

Each network's forward is its family's (``families/<family>.py``),
built from the layers here. They follow the published descriptions
and import nothing of the program (``tf_face_toolbox_tpu_torch``), of
JAX or of the JAX package. They read only the benchmark's own inputs: the seeded variables in the
``.npz`` key space, the uint8 faces and the gallery rows, and work out
again what the program derives from them (the standardized crops, the
folded BatchNorms, the bf16 store).
"""

import contextlib

import torch

from port_bench.reference.preprocess import flip_averaged, standardized_crops

__all__ = ["exact_f32", "flip_averaged", "standardized_crops"]


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the reference's products (cuBLAS and cuDNN) inside
    the block; the settings the program runs with come back after it."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
