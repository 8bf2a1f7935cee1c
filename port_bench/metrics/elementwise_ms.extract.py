"""Device milliseconds a batch of the kernels that are neither convs nor
GEMMs (elementwise, reduction, layout and pooling passes; copies
excluded), over the traced extraction window."""

from port_bench.readers import device_ms_per_call


def read(run):
    return device_ms_per_call(run, ("other",))
