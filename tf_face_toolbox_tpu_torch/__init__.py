"""PyTorch/CUDA port of tf_face_toolbox_tpu for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports torch
and numpy, never jax; its hand-written CUDA kernels are built from
``csrc/`` at first use (``kernels/build.py``).
"""
