"""On the card: each cell's control (the reference at the next precision
down, in the program's place) comes out not correct at the cell's own
size, on three seeds; and a short run of each cell prints a result line
with the result line's keys and comes out correct.

    python -m pytest port_bench/tests/test_card.py -q -s

(``-s`` shows each control reading beside the limits.)

Skips without a CUDA device (decided inside a fixture).
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

import pytest
import torch

from port_bench import run as harness

KEYS = {"correct", "attempted", "failed", "metrics", "device", "setup",
        "checks"}


@pytest.fixture
def card():
    """The card, with nothing of this process's cached on it before and
    after the test (a run holds the card alone, as the benchmark's
    runs do: ``test_short_run``'s subprocess needs all of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.empty_cache()
    yield "cuda"
    gc.collect()
    torch.cuda.empty_cache()


def _cells() -> list[str]:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


CELLS = _cells()


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(card, workload):
    from port_bench.trace import Spans

    cell = harness.load_cell(workload)
    drv = harness.kind_module(cell["traffic"]["kind"])
    limits = cell["limits"]
    for seed in (3_000_000_101, 3_000_000_102, 3_000_000_103):
        state = drv.setup(cell, seed, card, Spans(False))
        drv.window(state, 1.0)
        reading = drv.control(state)
        # one seed's program on the card at a time
        del state
        gc.collect()
        torch.cuda.empty_cache()
        print(f"control {workload} seed {seed} {reading} limits {limits}")
        # the int8 control fails at least one number
        assert any(reading[k] > limits[k] for k in limits), reading


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_short_run(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", workload,
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(result) == KEYS and list(result)[-1] == "checks"
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
