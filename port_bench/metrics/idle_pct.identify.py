"""The device's idle share of a traced identification window, in percent:
1 - (union of kernel and copy intervals) / window."""

from port_bench.readers import idle_pct


def read(run):
    return idle_pct(run)
