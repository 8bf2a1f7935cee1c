"""Kernel 3's share of its roofline in a search, in percent: the bytes a
search has to move (``work.topk_bytes``: the store's rows, its 4-byte
tombstone bias, the probes and the results, each once) at the card's
published HBM rate, over the device time of its two kernels
(``topk_stream_kernel`` and ``topk_merge_kernel``) a search in the
traced window. Memory bounds it: its operations at the bf16 peak take
a fifth of that time."""

from port_bench import work

KERNELS = ("topk_stream_kernel", "topk_merge_kernel")


def read(run):
    peaks = work.peaks(run.device_kind)
    if run.trace is None or peaks is None or not run.batches:
        return None
    s = run.trace.seconds(lambda name: any(k in name for k in KERNELS))
    if s <= 0:
        return None
    t = run.traffic
    need = work.topk_bytes(t["rows"], run.cfg["embedding_dim"], t["store"],
                           t["batch"], t["k"]) / peaks["hbm_bytes_per_s"]
    return 100.0 * need / (s / run.batches)
