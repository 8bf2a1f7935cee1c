"""Arithmetic the per-layer metric readers share (``metrics/*.py``).

Each reader takes the ``common.Run`` of a traced window and returns a
number, or None where the run holds nothing to read: no trace, no
device time of the kind asked for, or a card the table of peaks does
not hold. A share of a peak is never reported as 0 for want of data.
"""

from __future__ import annotations

from port_bench import trace, work


def idle_pct(run) -> float | None:
    """The share of the traced window in which no kernel or copy ran on
    the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def device_ms_per_call(run, kinds: tuple[str, ...]) -> float | None:
    """Device milliseconds of the kernels of ``kinds`` (``trace.kind``)
    for each call of the timed entry (a batch, a search)."""
    if run.trace is None or not run.batches:
        return None
    s = run.trace.seconds(lambda name: trace.kind(name) in kinds)
    return 1e3 * s / run.batches if s > 0 else None


def peak_share(run, operations: float, rate_key: str) -> float | None:
    """``operations`` done in the traced window over what the card's
    published peak ``rate_key`` allows in that time, in percent."""
    peaks = work.peaks(run.device_kind)
    if run.trace is None or peaks is None or run.trace.window_s <= 0:
        return None
    return 100.0 * operations / run.trace.window_s / peaks[rate_key]


def flop_key(cfg: dict) -> str:
    return {"bfloat16": "bf16_flop_per_s", "float16": "bf16_flop_per_s",
            "float32": "f32_flop_per_s"}[cfg["dtype"]]
