"""Bulk extraction: a closed loop of batches through ``cli.extract``'s
chain, with the decode left out.

Each batch of the traffic's ``batch`` faces is a slice of a pool of
``pool_faces`` seeded uint8 faces in host memory, taken in order as a
corpus is read. It is copied to the card, center-cropped and
standardized (``ops/preprocess.preprocess_eval``), embedded flip-averaged
(``extract.make_extract_fn`` over the backbone on ``--engine auto``'s
route: the folded engine where it serves the network, else the module
path) and copied back to a host array.

The check holds every embedding the window produced against the plain
reference's f32 embedding of the same face: the widest distance,
measured in units of the reference embeddings' spread about their mean
(random-weight embeddings share a large common part, which a plain
cosine would count as agreement).
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench import reference, weights
from port_bench.common import (Run, closed_loop, device_kind, profiled,
                               sync, torch_dtype)
from port_bench.families import family


# cli.extract's eval chain runs no kernel of the program's own library
BUILDS_KERNELS = False


class State:
    pass


def build_program(cfg: dict, variables: dict, device):
    """``extract(standardized NHWC) -> (N, D) f32`` as ``cli.extract
    --engine auto`` builds it."""
    from tf_face_toolbox_tpu_torch.extract import make_extract_fn
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    from tf_face_toolbox_tpu_torch.models import create_network
    from tf_face_toolbox_tpu_torch.serving import make_serving_apply

    net = create_network(cfg["port_network"],
                         embedding_dim=cfg["embedding_dim"],
                         dtype=torch_dtype(cfg["dtype"]),
                         **family(cfg["family"]).program_kwargs(cfg))
    try:
        apply_fn = make_serving_apply(net, variables, device=device,
                                      use_kernels=False)
    except ValueError:      # outside the engine's scope: the module path
        apply_fn = load_jax_variables(net, variables).to(device)
    return make_extract_fn(apply_fn)


def setup(cell: dict, seed: int, device, spans) -> State:
    from tf_face_toolbox_tpu_torch.ops.preprocess import preprocess_eval

    s = State()
    s.cfg, s.traffic, s.limits = cell["cfg"], cell["traffic"], cell["limits"]
    s.device, s.spans = torch.device(device), spans
    s.variables = weights.make_variables(s.cfg, seed, device)
    s.extract = build_program(s.cfg, s.variables, device)
    s.pool = weights.make_faces(seed, s.traffic["pool_faces"],
                                s.cfg["crop_from"], device)
    s.batch = s.traffic["batch"]
    if s.traffic["pool_faces"] % s.batch:
        raise ValueError("the pool holds whole batches")
    s.n_batches = s.traffic["pool_faces"] // s.batch
    size, norm = s.cfg["image_size"], s.cfg["input_norm"]
    s.outs = []
    s.sent = 0          # batches sent, warm-up included: the corpus runs on

    def step(i: int) -> None:
        lo = (s.sent % s.n_batches) * s.batch
        s.sent += 1
        with spans("h2d"):
            x = torch.from_numpy(s.pool[lo:lo + s.batch]).to(s.device)
        with spans("preprocess"):
            x = preprocess_eval(x, size, size, norm)
        with spans("forward"):
            e = s.extract(x)
        with spans("d2h"):
            s.outs.append((lo, e.cpu().numpy()))

    s.step = step
    # every shape of the window: one batch shape, warmed until steady
    closed_loop(step, 0.0, device, units=s.traffic["warmup_batches"])
    s.outs.clear()
    return s


def window(s: State, seconds: float, trace: bool = False) -> Run:
    with profiled(trace, s.device, s.spans) as traced:
        calls, secs = closed_loop(
            s.step, seconds, s.device,
            units=s.traffic["trace_batches"] if trace else None)
    faces = calls * s.batch
    return Run(attempted=faces, units=faces, batches=calls,
               trace=traced[0] if traced else None,
               metrics={"extract_faces_per_s": faces / secs},
               cfg=s.cfg, traffic=s.traffic, device_kind=device_kind(
                   s.device))


def reference_embeddings(s: State, quant: str | None = None) -> torch.Tensor:
    """The plain reference's f32 (or ``quant``) embeddings of every pool
    face, in blocks, on the device."""
    v = {k: torch.from_numpy(a).to(s.device) for k, a in s.variables.items()}
    forward = family(s.cfg["family"]).forward
    block = s.traffic["reference_block"]
    out = []
    with torch.no_grad(), reference.exact_f32():
        for lo in range(0, s.pool.shape[0], block):
            u8 = torch.from_numpy(s.pool[lo:lo + block]).to(s.device)
            x = reference.standardized_crops(u8, s.cfg["image_size"],
                                             s.cfg["input_norm"])
            out.append(reference.flip_averaged(
                lambda t: forward(v, t, s.cfg, quant), x))
    return torch.cat(out)


def gaps(ref: torch.Tensor, answers) -> tuple[float, int]:
    """The widest distance of an answer from the reference embedding of
    its face, over the median distance of a reference embedding from
    their mean; and the count of answers with a value that is not
    finite. ``answers``: (first pool row, (n, D) array) pairs."""
    spread = float((ref - ref.mean(dim=0)).norm(dim=1).median())
    ref = ref.cpu().numpy()
    worst, bad = 0.0, 0
    for lo, e in answers:
        finite = np.isfinite(e).all(axis=1)
        bad += int((~finite).sum())
        d = np.linalg.norm(e - ref[lo:lo + e.shape[0]], axis=1)
        worst = max(worst, float(np.where(finite, d, np.inf).max()))
    return worst / spread, bad


def free_program(s: State) -> None:
    s.extract = s.step = None
    sync(s.device)
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def check(s: State, run: Run) -> dict:
    free_program(s)
    gap, bad = gaps(reference_embeddings(s), s.outs)
    run.failed = bad
    return {"emb_gap": {"value": gap, "limit": s.limits["emb_gap"]}}


def control(s: State) -> dict:
    """The control: the reference at int8 (W8A8) in the program's place,
    held to the same number."""
    ref = reference_embeddings(s)
    ctl = reference_embeddings(s, "int8").cpu().numpy()
    gap, _ = gaps(ref, [(0, ctl)])
    return {"emb_gap": gap}
