"""What every kind of traffic shares: the run's record, dtypes, the closed loop's
clock and the profiler around the traced units."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

from port_bench import trace as trace_mod


@dataclass
class Run:
    """What a window produced, for the metric readers and the check."""

    attempted: int = 0          # units of work sent (faces, requests)
    failed: int = 0             # of those, answers that never came or broke
    metrics: dict = field(default_factory=dict)   # end-to-end, by name
    units: int = 0              # units completed in the window
    batches: int = 0            # calls of the timed entry in the window
    trace: trace_mod.Trace | None = None
    cfg: dict = field(default_factory=dict)
    traffic: dict = field(default_factory=dict)
    device_kind: str = ""


def torch_dtype(name: str):
    import torch
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_kind(device) -> str:
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


@contextlib.contextmanager
def profiled(on: bool, device, spans):
    """A torch.profiler trace of the body, inside one ``window`` span;
    yields a list that holds the ``trace.Trace`` once the body is done.
    Off: the body runs bare and the list stays empty."""
    out: list = []
    if not on:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    import torch
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with spans(trace_mod.WINDOW):
            yield out
        sync(device)
    out.append(trace_mod.from_profiler(prof))


def closed_loop(step, seconds: float, device, *, units: int | None = None):
    """Call ``step(i)`` back to back, i = 0, 1, ..., until ``seconds`` of
    host time have passed at the end of a call (or ``units`` calls are
    done); the device is synchronised before the clock stops. Returns
    (calls, seconds)."""
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while True:
        step(i)
        i += 1
        if units is not None:
            if i >= units:
                break
        elif time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return i, time.perf_counter() - t0
