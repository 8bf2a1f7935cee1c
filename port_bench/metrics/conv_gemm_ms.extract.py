"""Device milliseconds a batch of the cuDNN convs and the cuBLAS or
CUTLASS GEMMs, over the traced extraction window."""

from port_bench.readers import device_ms_per_call


def read(run):
    return device_ms_per_call(run, ("conv", "gemm"))
