"""The whole search's share of the card's bf16 peak, in percent: the
requests of the traced window times a search's operations (every
probe against every row, ``work.topk_flops``) over the window. It bounds
kernel 3's roofline from the side of the whole request, which a later
change that takes the kernel off the path cannot leave silent."""

from port_bench import work
from port_bench.readers import peak_share


def read(run):
    t = run.traffic
    ops = run.units * work.topk_flops(t["rows"], run.cfg["embedding_dim"],
                                      t["batch"])
    return peak_share(run, ops, "bf16_flop_per_s")
