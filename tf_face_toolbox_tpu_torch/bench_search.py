"""Port bench for 1:N search on one GPU: top-k kernel times and gallery
search latency at 10^7 seeded random unit rows of D=512.

    python -m tf_face_toolbox_tpu_torch.bench_search topk
    python -m tf_face_toolbox_tpu_torch.bench_search gallery

``topk``: device milliseconds per call (CUDA events, 10 calls after
one) of ``cosine_topk`` (f32, bf16 store) and ``cosine_topk_q`` (int8)
for every store, B 1 and 64, k 5 and 20; the kernels only, no plain
version. ``gallery``: ``DeviceGallery.search`` (k 5, B 1 and 64) on the
host clock, p50 and p99 of 50 searches after 3, then the device time
of 10 more by kernel (torch.profiler: stream kernel, merge, the rest)
and the idle share 1 - device time / p50. Prints one JSON line per
measurement. There is no CPU mode: a measurement that finds no card
fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

DTYPES = ("float32", "bfloat16", "int8")
DIM = 512
ROWS = 10_000_000


def unit_rows(g, n: int, d: int, dtype=torch.float32,
              chunk: int = 1 << 20) -> torch.Tensor:
    """(n, d) seeded random unit rows on the card, made in chunks."""
    out = torch.empty((n, d), dtype=dtype, device="cuda")
    for i in range(0, n, chunk):
        x = torch.randn((min(chunk, n - i), d), generator=g, device="cuda")
        out[i:i + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    return out


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 on the card (serving/gallery._quantize_rows'
    math: scale = max|x|/127 floored at 1e-12, round half to even)."""
    scale = (x.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    q = torch.round(x / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def topk_times(cap: int = ROWS, batches=(1, 64), ks=(5, 20), iters: int = 10,
               seed: int = 0) -> list:
    """Kernel ms per search of a ``cap``-row store of every dtype."""
    from tf_face_toolbox_tpu_torch.bench import time_ms
    from tf_face_toolbox_tpu_torch.ops import topk as ttk

    g = torch.Generator(device="cuda").manual_seed(seed)
    base = unit_rows(g, cap, DIM, dtype=torch.bfloat16)
    probes = unit_rows(g, max(batches), DIM)
    rows = []
    for dtype in DTYPES:
        if dtype == "int8":
            store = torch.empty((cap, DIM), dtype=torch.int8, device="cuda")
            scale = torch.empty(cap, device="cuda")
            for i in range(0, cap, 1 << 20):
                store[i:i + (1 << 20)], scale[i:i + (1 << 20)] = \
                    quantize_rows(base[i:i + (1 << 20)].float())
            pq, ps = quantize_rows(probes)
        else:
            store = base.float() if dtype == "float32" else base
        for b in batches:
            for k in ks:
                if dtype == "int8":
                    def fn():
                        return ttk.cosine_topk_q(store, scale, pq[:b], ps[:b], cap, k)
                else:
                    def fn():
                        return ttk.cosine_topk(store, probes[:b], cap, k)
                ms = time_ms(fn, iters=iters, warmup=1)
                rows.append({"dtype": dtype, "rows": cap, "batch": b, "k": k,
                             "ms": ms, "store_gb_per_s":
                             store.numel() * store.element_size() / ms / 1e6})
        del store
        torch.cuda.empty_cache()
    return rows


def gallery_search_latency(cap: int, dtypes=DTYPES, profile: bool = False,
                           seed: int = 0) -> list:
    """Host p50/p99 of ``DeviceGallery.search`` (k 5, B 1 and 64) on a
    ``cap``-row gallery of each dtype; with ``profile``, device ms a
    search by kernel and the idle share."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = unit_rows(g, cap, DIM).cpu().numpy()
    probes = unit_rows(g, 64, DIM).cpu().numpy()
    out = []
    for dtype in dtypes:
        t0 = time.perf_counter()
        gal = DeviceGallery(DIM, dtype=dtype, hbm_limit_gb=0, device="cuda")
        gal.enroll(rows, np.arange(cap))
        enroll_s = time.perf_counter() - t0
        for b in (1, 64):
            for _ in range(3):
                gal.search(probes[:b], k=5)
            ms = []
            for _ in range(50):
                t0 = time.perf_counter()
                labels, scores = gal.search(probes[:b], k=5)
                ms.append((time.perf_counter() - t0) * 1e3)
            if labels.shape != (b, 5) or not np.isfinite(scores).all():
                raise RuntimeError(f"{dtype} gallery search gave {labels.shape} "
                                   "labels or non-finite scores")
            p50, p99 = (float(v) for v in np.percentile(ms, [50, 99]))
            r = {"dtype": dtype, "rows": cap, "batch": b, "k": 5,
                 "p50_ms": p50, "p99_ms": p99, "enroll_s": enroll_s}
            if profile:
                with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(10):
                        gal.search(probes[:b], k=5)
                    torch.cuda.synchronize()
                by = {"stream": 0.0, "merge": 0.0, "other": 0.0}
                for e in prof.key_averages():
                    part = ("stream" if "topk_stream_kernel" in e.key else
                            "merge" if "topk_merge_kernel" in e.key else "other")
                    by[part] += e.device_time_total / 1e3 / 10
                dev = sum(by.values())
                r.update(device_ms=dev, stream_ms=by["stream"], merge_ms=by["merge"],
                         other_ms=by["other"], idle=1 - dev / p50)
            out.append(r)
        del gal
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("what", choices=["topk", "gallery"])
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_search: torch sees no CUDA device; there is no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    from tf_face_toolbox_tpu_torch.bench import gpu_info

    gpu = gpu_info()
    rows = (topk_times() if args.what == "topk" else
            gallery_search_latency(ROWS, profile=True))
    for r in rows:
        print(json.dumps({**r, "gpu": gpu}), flush=True)


if __name__ == "__main__":
    main()
