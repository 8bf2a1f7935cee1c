"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, ``load_library()`` compiles every ``csrc/*.cu`` of this
package for Hopper (``sm_90a``), one nvcc process per source, all
started together, and links the objects into one shared library with a
plain C interface under ``build/torch_kernels/`` at the repository root.
The file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. A failed build
raises with nvcc's stderr; there is no fallback.

Nothing here runs at import time: the CPU tests import every module of
the package on machines that have no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> (restype, argtypes). Every pointer and the
# stream are c_void_p; ctypes would otherwise pass them as 32-bit ints.
SIGNATURES = {
    # the plan's launch structure (PreLaunch; ops/fused_preprocess.py's
    # _Launch), images, flips (null: none flipped), out, device, stream
    "tfft_preprocess": (_I, [_P, _P, _P, _P, _I, _P]),
    # x, out, w1, b1, w2, b2, w3, b3, wp, bp, n, h, w, cin, b, c, then
    # the plan (th, tw, g, nb1, nb2, nb3, stages, ctas_per_sm, cluster,
    # smem_bytes), device, stream
    "tfft_bottleneck_block": (_I, [_P] * 10 + [_I] * 6 + [_I] * 10
                              + [_I, _P]),
    # store, probes, bias, n_valid, cap, d, b, k, store_bf16, then the
    # plan (per_cta, slots, stages, slice_rows, slices, smem_bytes,
    # shared_lists), part_s, part_i, merge_scratch, out_s, out_i,
    # device, stream
    "tfft_topk": (_I, [_P, _P, _P, _I, _I, _I, _I, _I, _I]
                  + [_I] * 7 + [_P] * 5 + [_I, _P]),
    # store, row_scale, probes, probe_scale, bias, n_valid, cap, d, b, k,
    # then the same plan and buffers as tfft_topk
    "tfft_topk_q": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
                    + [_I] * 7 + [_P] * 5 + [_I, _P]),
    "tfft_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's "
            "CUDA kernels are built from source at first use")
    return path


def _sources() -> list[str]:
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libtfft_kernels_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str], proc: subprocess.Popen) -> None:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")


def build() -> str:
    """Compile the sources unless the library for them exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    objs, jobs = [], []
    for src in _sources():
        obj = f"{tag}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                           stderr=subprocess.PIPE,
                                           text=True)))
        objs.append(obj)
    try:
        for cmd, proc in jobs:
            _run(cmd, proc)
        tmp = f"{tag}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        _run(cmd, subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                   stderr=subprocess.PIPE, text=True))
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    # atomic: a concurrent process never loads a half-written library
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, status: int, name: str) -> None:
    """Raise if a C entry point reported an error: a cudaError_t, or a
    negative code for arguments or a tile the kernel does not take."""
    if status != 0:
        msg = lib.tfft_error_string(status).decode()
        raise RuntimeError(f"{name} failed with status {status}: {msg}")
