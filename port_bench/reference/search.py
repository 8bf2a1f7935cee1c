"""Exact 1:N search over a bf16 store, by brute force in f32.

A bf16 store holds each enrolled f32 row rounded to bf16, and a probe
is rounded to the store's type too; a score is their dot product summed
in f32 (every product of two bf16 values is exact in f32). An int8
store (the control's) rounds rows and probes to int8 with a scale a
row. A removed row never matches. Rows come in blocks from ``rows_fn`` so that a store
of 10^7 rows is never held in f32.
"""

from __future__ import annotations

from typing import Iterable

import torch


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows rounded to symmetric int8 with a scale a row (max |x| / 127,
    round half to even), dequantized to f32."""
    scale = (x.abs().amax(dim=1, keepdim=True) / 127.0).clamp_min(1e-12)
    return torch.round(x / scale).clamp(-127, 127) * scale


def store_scores(rows: torch.Tensor, probes: torch.Tensor, store: str
                 ) -> torch.Tensor:
    """(B, R) scores of f32 ``rows`` stored as ``store``, against f32
    ``probes`` rounded alike; summed in f32."""
    if store == "int8":
        return int8_rows(probes) @ int8_rows(rows).T
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[store]
    return probes.to(dt).float() @ rows.to(dt).float().T


def exact_search(blocks: Iterable[tuple[int, torch.Tensor]],
                 probes: torch.Tensor, k: int, dead: torch.Tensor,
                 returned: torch.Tensor, store: str = "bfloat16"):
    """Top-``k`` rows of every probe over the store, and the scores of the
    rows the program returned.

    ``blocks`` yields (first row, f32 rows) in order; ``dead``: sorted
    int64 row indices that were removed; ``returned``: (B, k) int64 rows
    the program answered (any value). -> (top scores (B, k), top rows
    (B, k), scores of ``returned`` (B, k); a dead or unknown row scores
    -inf)."""
    b = probes.shape[0]
    dev = probes.device
    top_s = torch.full((b, k), -float("inf"), device=dev)
    top_i = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    got = torch.full(returned.shape, -float("inf"), device=dev)
    for lo, rows in blocks:
        hi = lo + rows.shape[0]
        s = store_scores(rows, probes, store)
        d = dead[(dead >= lo) & (dead < hi)] - lo
        s[:, d] = -float("inf")
        inside = (returned >= lo) & (returned < hi)
        pick = torch.where(inside, returned - lo, 0)
        got = torch.where(inside, torch.gather(s, 1, pick), got)
        cs, ci = torch.topk(s, min(k, s.shape[1]), dim=1)
        both_s = torch.cat([top_s, cs], dim=1)
        both_i = torch.cat([top_i, ci + lo], dim=1)
        top_s, order = torch.topk(both_s, k, dim=1)
        top_i = torch.gather(both_i, 1, order)
    return top_s, top_i, got


def score_gap(scores: torch.Tensor, returned_scores: torch.Tensor,
              top_scores: torch.Tensor) -> float:
    """The widest gap, over every probe and rank, between what the program
    said and the reference: its score against the reference's score of
    the row it named, and the reference's score of that row against the
    reference's best at that rank (a row missing from the true top-k
    reads as the distance to it)."""
    said = (scores - returned_scores).abs()
    below = top_scores - returned_scores.sort(dim=1, descending=True).values
    gap = torch.maximum(said, below)
    return float(gap.max())

