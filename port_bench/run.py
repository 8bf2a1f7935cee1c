"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload resnet50_face.extract \
        --seed 1234 --seconds 20 --trace 0

The cell is looked up by name in ``BENCHMARK.json`` at the root of the
checkout; its configuration (``configs/<config>.json``), traffic mix
(``traffic/<traffic>.json``), the limits of its check
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``) are files of their own, found by those names.
The traffic file names its kind (``kinds/<kind>.py``), the module that sets
the program up, runs the closed loop and checks what it produced
against the plain reference (``reference/``).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` runs
the loop under torch.profiler for the traffic's ``trace_*`` units
and prints its per-layer metrics, the device's busy and window seconds
and the breakdown. Either way the last line of standard output is one
JSON object. Its ``setup`` key gives the set-up's seconds with the part
spent building or loading the program's CUDA kernels apart (a fresh
checkout's first run compiles them); its last key, ``checks``, and the
last lines of standard error name each number the check compared,
beside its limit. A run that finds no CUDA device, too
few of them, or JAX or the JAX package loaded in this process, exits
with 2 and prints no result.
"""

from __future__ import annotations

import time

T0 = time.monotonic()       # process start, for setup_s

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "tf_face_toolbox_tpu_torch"
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "tf_face_toolbox_tpu")


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's nvcc build already lives in ``build/torch_kernels``)."""
    build = os.path.join(ROOT, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(workload: str, root: str = ROOT) -> dict:
    """The cell's entry, configuration, traffic, limits and metric
    entries, by the names in ``BENCHMARK.json``."""
    spec = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"run: no workload {workload!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    return make_cell(cells[workload], spec, root)


def make_cell(cell: dict, spec: dict, root: str = ROOT) -> dict:
    """A cell's files found by the names in its ``workloads`` entry
    ``cell``, with the metrics of ``spec`` (BENCHMARK.json's shape) that
    it reports."""
    workload = cell["name"]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    end_to_end = [m for m in spec["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return {"workload": workload, "cell": cell,
            "cfg": load_json(root, conf["file"]),
            "traffic": load_json(HERE, "traffic", cell["traffic"] + ".json"),
            "limits": load_json(HERE, "limits", workload + ".json"),
            "end_to_end": end_to_end, "per_layer": per_layer,
            "chips": cell["chips"]}


def kind_module(name: str):
    return importlib.import_module(f"port_bench.kinds.{name}")


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``, loaded by its file name (a
    metric's name may hold dots)."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + metric.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def check_program() -> None:
    """The program under test is the checkout's own package."""
    mod = importlib.import_module(PROGRAM)
    where = os.path.dirname(os.path.abspath(mod.__file__))
    if os.path.dirname(where) != ROOT:
        raise SystemExit(f"run: {PROGRAM} loaded from {where}, not from "
                         f"the checkout at {ROOT}")


def device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def build_kernels(drv, device) -> dict:
    """The program's CUDA library, built (a fresh checkout's first run
    compiles it with nvcc) or loaded, timed apart from the rest of
    set-up, for a kind whose timed path runs the port's own kernels."""
    import torch

    out = {"kernel_build_s": 0.0, "kernels_built": False}
    if torch.device(device).type != "cuda" or not drv.BUILDS_KERNELS:
        return out
    from tf_face_toolbox_tpu_torch.kernels import build

    out["kernels_built"] = not os.path.exists(build.library_path())
    t0 = time.monotonic()
    build.load_library()
    out["kernel_build_s"] = time.monotonic() - t0
    return out


def per_layer_metrics(cell: dict, run) -> dict:
    out = {}
    for m in cell["per_layer"]:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float = T0) -> dict:
    """Set up, measure and check one cell; -> the result line's object.
    (``main`` looks for the chips first; tests call this on the CPU.)"""
    from port_bench.common import sync
    from port_bench.trace import Spans

    drv = kind_module(cell["traffic"]["kind"])
    spans = Spans(trace)
    setup = build_kernels(drv, device)
    state = drv.setup(cell, seed, device, spans)
    sync(device)
    setup_s = time.monotonic() - t0
    setup = {"setup_s": setup_s, **setup}
    run = drv.window(state, seconds, trace=trace)
    sync(device)
    dev = device_info(device, cell["chips"])
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        metrics = per_layer_metrics(cell, run)
    else:
        metrics = {m["name"]: {"value": float(run.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    checks = drv.check(state, run)
    correct = run.failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
    result = {"correct": correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = {"device_ops": run.trace.top_ops(10),
                               "idle_gaps": run.trace.idle_by_span(10)}
    result["setup"] = setup
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    args = p.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("run: torch sees no CUDA device; the benchmark measures a GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"run: {args.workload} needs {cell['chips']} GPUs, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    check_program()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"run: {', '.join(found)} loaded in the benchmark's process",
              file=sys.stderr)
        return 2
    print("setup " + " ".join(f"{k} {v!r}"
                              for k, v in result["setup"].items()),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
