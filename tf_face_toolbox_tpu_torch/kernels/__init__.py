"""kernels."""
