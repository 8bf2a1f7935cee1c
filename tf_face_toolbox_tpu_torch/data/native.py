"""ctypes binding for the native FaceShard loader (native/faceshard).

The C++ library owns mmap, a persistent decode thread pool, libjpeg
decode, and host-side bilinear resize — the TPU-native equivalent of
the reference's in-runtime C++ input ops (SURVEY.md §2b). Python-side
decode (data/pipeline.py) remains the portable fallback; builds of the
.so are one `make` in native/faceshard (auto-attempted on first use).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Sequence

import numpy as np

_LIB_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "faceshard")
_LIB_PATH = os.path.join(_LIB_DIR, "libfaceshard.so")

_lib = None


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make"], cwd=_LIB_DIR, check=True,
                           capture_output=True)
        except Exception as e:
            raise OSError(f"libfaceshard.so missing and build failed: {e}")
    lib = ctypes.CDLL(_LIB_PATH)
    lib.fs_open.restype = ctypes.c_void_p
    lib.fs_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fs_close.argtypes = [ctypes.c_void_p]
    lib.fs_count.restype = ctypes.c_int64
    lib.fs_count.argtypes = [ctypes.c_void_p]
    lib.fs_payload.restype = ctypes.c_int
    lib.fs_payload.argtypes = [ctypes.c_void_p]
    lib.fs_labels.argtypes = [ctypes.c_void_p,
                              np.ctypeslib.ndpointer(np.int32)]
    lib.fs_decode_batch.restype = ctypes.c_int
    lib.fs_decode_batch.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.int64), ctypes.c_int,
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int, ctypes.c_int]
    lib.fs_prefetch.restype = ctypes.c_int
    lib.fs_prefetch.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.int64), ctypes.c_int]
    lib.fs_dct_batch.restype = ctypes.c_int
    lib.fs_dct_batch.argtypes = [
        ctypes.c_void_p, np.ctypeslib.ndpointer(np.int64), ctypes.c_int,
        np.ctypeslib.ndpointer(np.int16),
        np.ctypeslib.ndpointer(np.uint16), ctypes.c_int, ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load_library()
        return True
    except OSError:
        return False


class NativeShardReader:
    """Batch decoder over one FaceShard, backed by the C++ decoder.

    The library's own pool (``fs_open(path, n > 0)``) is not used: its
    batch dispatch signals completion through a mutex and condition
    variable on the caller's stack after the waiting caller may already
    have returned, so under load a worker locks a dead frame (glibc
    aborts, or a later batch's counter is overwritten and the batch is
    read before its decode has finished). The handle is opened serial
    and ``num_threads`` Python threads each decode a contiguous run of
    the batch's slots through it (ctypes releases the GIL; a serial call
    touches only the read-only mapping and its own slots).
    """

    def __init__(self, path: str, *, num_threads: int = 4):
        lib = _load_library()
        self._lib = lib
        self._h = lib.fs_open(path.encode(), 0)
        if not self._h:
            raise OSError(f"fs_open failed for {path}")
        self._threads = max(1, int(num_threads))
        self._pool = None
        self.count = int(lib.fs_count(self._h))
        self.payload = int(lib.fs_payload(self._h))
        self.labels = np.zeros(self.count, np.int32)
        lib.fs_labels(self._h, self.labels)

    def decode_batch(self, ids: Sequence[int], out_h: int,
                     out_w: int) -> np.ndarray:
        """(len(ids), out_h, out_w, 3) uint8; raises on decode failure."""
        ids = np.ascontiguousarray(ids, np.int64)
        out = np.empty((len(ids), out_h, out_w, 3), np.uint8)
        failures = self._run(len(ids), lambda a, b: self._lib.fs_decode_batch(
            self._h, ids[a:b], b - a, out[a:b], out_h, out_w))
        if failures:
            raise ValueError(f"{failures} records failed to decode")
        return out

    def dct_batch(self, ids: Sequence[int], height: int,
                  width: int) -> tuple[np.ndarray, np.ndarray]:
        """Entropy-decode only: quantized DCT coefficients + quant
        tables for `ids`, leaving dequantize/IDCT/color to the TPU
        (ops/jpeg_tpu.decode_dct). Records must be 4:4:4 JPEGs of
        exactly (height, width) — the geometry `cli.pack
        --recode_size` writes; height/width must be multiples of 8.

        Returns (coef int16 (N, H/8, W/8, 3, 64), qtab uint16 (N, 3, 64)).
        """
        if height % 8 or width % 8:
            raise ValueError("DCT path needs multiple-of-8 geometry")
        bh, bw = height // 8, width // 8
        ids = np.ascontiguousarray(ids, np.int64)
        coef = np.empty((len(ids), bh, bw, 3, 64), np.int16)
        qtab = np.empty((len(ids), 3, 64), np.uint16)
        failures = self._run(len(ids), lambda a, b: self._lib.fs_dct_batch(
            self._h, ids[a:b], b - a, coef[a:b], qtab[a:b], bh, bw))
        if failures:
            raise ValueError(
                f"{failures} records failed DCT extraction (corrupt, "
                f"not 4:4:4, or not {height}x{width} — repack with "
                "cli.pack --recode_size)")
        return coef, qtab

    def _run(self, n: int, call) -> int:
        """``call(lo, hi)`` over ``num_threads`` contiguous runs of slots
        [0, n), on the reader's threads; the summed failure counts."""
        runs = min(self._threads, n)
        if runs <= 1:
            return int(call(0, n)) if n else 0
        if self._pool is None:
            import concurrent.futures

            self._pool = concurrent.futures.ThreadPoolExecutor(
                self._threads, thread_name_prefix="faceshard-decode")
        bounds = [n * i // runs for i in range(runs + 1)]
        return sum(int(f.result()) for f in [
            self._pool.submit(call, a, b)
            for a, b in zip(bounds[:-1], bounds[1:])])

    def prefetch(self, ids: Sequence[int]) -> int:
        """Readahead hint for an upcoming batch: madvise(WILLNEED) the
        records' mmap ranges (coalesced). Returns syscalls issued."""
        ids = np.ascontiguousarray(ids, np.int64)
        return int(self._lib.fs_prefetch(self._h, ids, len(ids)))

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._h:
            self._lib.fs_close(self._h)
            self._h = None

    def __del__(self):  # best-effort
        try:
            self.close()
        except Exception:
            pass
