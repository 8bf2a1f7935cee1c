"""1:N identification: one client sends search requests back to back to
``serving/gallery.DeviceGallery.search``.

Set-up enrolls ``rows`` seeded unit rows (labels 0 .. rows - 1) in one
``enroll`` call, from one host array the rows were copied into from
the card, and removes ``removed_rows`` of them (tombstones in the
search bias). A request is ``batch`` probe embeddings and ``k``: the
first ``enrolled_share`` of them noisy copies of enrolled rows (a
perturbation of norm ``noise`` against the unit row, then normalized),
some of whose source rows were removed, the rest fresh unit rows that
match nothing enrolled. Requests cycle through a pool of
``request_pool`` drawn from the seed. A request's latency runs from the
call into ``search`` until its labels and scores are host arrays.

The check takes a sample of the window's requests, drawn from the
seed, and holds each answer against the plain exact search over the
same rows (``reference/search.py``): the widest score gap, over every
probe and rank, between what the program said and the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import reference, weights
from port_bench.common import (Run, closed_loop, device_kind, profiled,
                               sync)
from port_bench.reference import search as ref_search


# the search runs kernel 3 from the program's nvcc-built library
BUILDS_KERNELS = True


class State:
    pass


def unit_block(seed: int, i: int, rows: int, dim: int, device
               ) -> torch.Tensor:
    """Gallery rows [i * rows, ...) of a seed: f32 unit rows made on the
    device, the same whichever block is asked for first."""
    g = weights.generator(seed, f"rows/{i}", device)
    x = torch.randn((rows, dim), generator=g, device=device)
    return x / x.norm(dim=1, keepdim=True)


def gallery_rows(seed: int, n: int, dim: int, block: int, device):
    """(first row, f32 rows on the device) blocks of the gallery."""
    for i, lo in enumerate(range(0, n, block)):
        yield lo, unit_block(seed, i, min(block, n - lo), dim, device)


def make_requests(seed: int, t: dict, rows: np.ndarray, device):
    """(the request pool (P, batch, D) f32 unit probes, the sorted rows
    to remove) of a seed over the gallery ``rows``: noisy copies of
    enrolled rows first, then fresh rows; the removed rows are the
    sources of the first copies, which would otherwise be their best
    match."""
    n, dim = rows.shape
    b, pool = t["batch"], t["request_pool"]
    rng = np.random.default_rng(weights.stream_seed(seed, "requests"))
    n_copies = int(round(b * t["enrolled_share"]))
    src = rng.integers(0, n, size=(pool, n_copies))
    g = weights.generator(seed, "probes", device)
    noise = torch.randn((pool, n_copies, dim), generator=g, device=device)
    noise *= t["noise"] / noise.norm(dim=2, keepdim=True)
    copies = torch.from_numpy(rows[src.ravel()]).to(device).reshape(
        noise.shape) + noise
    fresh = torch.randn((pool, b - n_copies, dim), generator=g,
                        device=device)
    probes = torch.cat([copies, fresh], dim=1)
    probes = (probes / probes.norm(dim=2, keepdim=True)).cpu().numpy()
    return probes, np.unique(src.ravel()[:t["removed_rows"]])


def setup(cell: dict, seed: int, device, spans) -> State:
    from tf_face_toolbox_tpu_torch.serving.gallery import DeviceGallery

    s = State()
    s.cfg, s.traffic, s.limits = cell["cfg"], cell["traffic"], cell["limits"]
    t = s.traffic
    s.device, s.spans, s.seed = torch.device(device), spans, seed
    n, dim = t["rows"], s.cfg["embedding_dim"]
    s.n, s.dim, s.k = n, dim, t["k"]
    host = np.empty((n, dim), np.float32)     # the one host copy
    for lo, rows in gallery_rows(seed, n, dim, t["row_block"], device):
        torch.from_numpy(host[lo:lo + rows.shape[0]]).copy_(rows)

    s.probes, s.dead = make_requests(seed, t, host, device)

    s.gallery = DeviceGallery(dim, dtype=t["store"],
                              hbm_limit_gb=t["hbm_limit_gb"], device=device)
    s.gallery.enroll(host, np.arange(n))
    del host
    for label in s.dead:
        s.gallery.remove(int(label))
    s.answers = []          # (pool index, labels, scores) a request
    s.ms = []

    def step(i: int) -> None:
        j = i % t["request_pool"]
        with spans("search"):
            t0 = time.perf_counter()
            labels, scores = s.gallery.search(s.probes[j], k=s.k)
            s.ms.append((time.perf_counter() - t0) * 1e3)
        s.answers.append((j, labels, scores))

    s.step = step
    closed_loop(step, 0.0, device, units=t["warmup_requests"])
    s.answers.clear()
    s.ms.clear()
    return s


def window(s: State, seconds: float, trace: bool = False) -> Run:
    with profiled(trace, s.device, s.spans) as traced:
        calls, secs = closed_loop(
            s.step, seconds, s.device,
            units=s.traffic["trace_requests"] if trace else None)
    return Run(attempted=calls, units=calls, batches=calls,
               trace=traced[0] if traced else None,
               metrics={"identify_p95_ms": float(np.percentile(s.ms, 95))},
               cfg=s.cfg, traffic=s.traffic,
               device_kind=device_kind(s.device))


def sample(s: State) -> list[int]:
    """The window's requests the check compares, drawn from the seed."""
    rng = np.random.default_rng(weights.stream_seed(s.seed, "check"))
    m = min(s.traffic["checked_requests"], len(s.answers))
    return sorted(rng.choice(len(s.answers), size=m, replace=False))


def reference_gap(s: State, probes: np.ndarray, said_rows: np.ndarray,
                  said_scores: np.ndarray) -> float:
    """The exact search's widest gap against answers (rows, scores)."""
    p = torch.from_numpy(probes).to(s.device)
    dead = torch.from_numpy(s.dead.astype(np.int64)).to(s.device)
    returned = torch.from_numpy(said_rows.astype(np.int64)).to(s.device)
    with torch.no_grad(), reference.exact_f32():
        top_s, _, got = ref_search.exact_search(
            gallery_rows(s.seed, s.n, s.dim, s.traffic["row_block"],
                         s.device), p, s.k, dead, returned,
            s.traffic["store"])
    said = torch.from_numpy(np.asarray(said_scores, np.float32)).to(s.device)
    return ref_search.score_gap(said, got, top_s)


def free_program(s: State) -> None:
    s.gallery = s.step = None
    sync(s.device)
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def check(s: State, run: Run) -> dict:
    free_program(s)
    run.failed = sum(int(not np.isfinite(sc).all())
                     for _, _, sc in s.answers)
    picked = [s.answers[i] for i in sample(s)]
    probes = np.concatenate([s.probes[j] for j, _, _ in picked])
    rows = np.concatenate([lab for _, lab, _ in picked])
    scores = np.concatenate([sc for _, _, sc in picked])
    gap = reference_gap(s, probes, rows, scores)
    return {"score_gap": {"value": gap, "limit": s.limits["score_gap"]}}


def control(s: State) -> dict:
    """The control: the exact search over an int8 store (per-row
    symmetric scales, probes quantized alike), in the program's place,
    held to the same number."""
    picked = sample(s)
    probes = np.concatenate([s.probes[s.answers[i][0]] for i in picked])
    p = torch.from_numpy(probes).to(s.device)
    dead = torch.from_numpy(s.dead.astype(np.int64)).to(s.device)
    with torch.no_grad(), reference.exact_f32():
        ctl_s, ctl_i, _ = ref_search.exact_search(
            gallery_rows(s.seed, s.n, s.dim, s.traffic["row_block"],
                         s.device), p, s.k, dead,
            torch.zeros((p.shape[0], s.k), dtype=torch.int64,
                        device=s.device), "int8")
    return {"score_gap": reference_gap(s, probes, ctl_i.cpu().numpy(),
                                       ctl_s.cpu().numpy())}

