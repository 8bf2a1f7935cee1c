"""Readings that a cell's limits are set from: the program's number on
many seeds, and the control's (the reference at the next precision
down, in the program's place) on a few, at the cell's own size, in one
process.

    python3 -m port_bench.calibrate --workload resnet50_face.extract \
        --seeds 101,102,103 --seconds 3 --controls 3

Prints one JSON line a seed: the program's numbers (``program``), the
end-to-end metrics of its short window and, for the first ``controls``
seeds, the control's numbers (``control``). The limit of each number
lies between the largest ``program`` reading and the smallest
``control`` one (PERF.md gives both beside the limit).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from port_bench import run as harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)

    import torch

    from port_bench.trace import Spans

    if args.device == "cuda" and not torch.cuda.is_available():
        print("calibrate: torch sees no CUDA device", file=sys.stderr)
        return 2
    drv = harness.kind_module(cell["traffic"]["kind"])
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        state = drv.setup(cell, seed, args.device, Spans(False))
        setup_s = time.monotonic() - t0
        run = drv.window(state, args.seconds)
        t1 = time.monotonic()
        checks = drv.check(state, run)
        line = {"workload": args.workload, "seed": seed,
                "program": {k: c["value"] for k, c in checks.items()},
                "failed": run.failed, "attempted": run.attempted,
                "metrics": run.metrics, "setup_s": setup_s,
                "check_s": time.monotonic() - t1}
        if i < args.controls:
            line["control"] = drv.control(state)
        print(json.dumps(line), flush=True)
        del state, run
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
