"""Seeded weights and seeds, made on the card in a few large calls.

``make_variables`` draws every variable of a configuration (``arch``)
from two buffers, one normal and one uniform, made by a generator on
the device, each leaf scaled as its ``arch.Leaf`` says, and copies the
result to the host once: the flat ``.npz`` key space that the program
loads and folds, and that the reference reads too.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from port_bench import arch


def stream_seed(seed: int, stream: str) -> int:
    """An independent 63-bit seed for one use of the run's seed (any
    whole number, of any size)."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


def make_variables(cfg: dict, seed: int, device) -> dict[str, np.ndarray]:
    """Every variable of ``cfg`` as host f32 arrays, keyed as the port's
    ``.npz``; the same ``seed`` gives the same values."""
    _, leaves = arch.layers_of(cfg)
    sizes = [int(np.prod(leaf.shape)) for leaf in leaves]
    n_normal = sum(s for s, leaf in zip(sizes, leaves)
                   if leaf.dist == "normal")
    g = generator(seed, f"weights/{cfg['name']}", device)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(sum(sizes) - n_normal, generator=g, device=device)
    parts, ni, ui = [], 0, 0
    for size, leaf in zip(sizes, leaves):
        if leaf.dist == "normal":
            parts.append(normal[ni:ni + size] * leaf.a)
            ni += size
        else:
            parts.append(uniform[ui:ui + size] * (leaf.b - leaf.a) + leaf.a)
            ui += size
    flat = torch.cat(parts).cpu().numpy()
    out, at = {}, 0
    for size, leaf in zip(sizes, leaves):
        out[leaf.key] = flat[at:at + size].reshape(leaf.shape)
        at += size
    return out


def make_faces(seed: int, n: int, size: int, device,
               chunk: int = 1024) -> np.ndarray:
    """(n, size, size, 3) uint8 faces on the host, made on ``device`` in
    chunks: a smooth field (a 15x15x3 normal grid, bilinearly enlarged)
    plus pixel noise around mid-grey, so that images have the spatial
    correlation of photographs and differ from one another."""
    g = generator(seed, "faces", device)
    out = np.empty((n, size, size, 3), np.uint8)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        coarse = torch.randn((m, 3, 15, 15), generator=g, device=device)
        smooth = torch.nn.functional.interpolate(
            coarse, size=(size, size), mode="bilinear", align_corners=False)
        noise = torch.randn((m, 3, size, size), generator=g, device=device)
        x = (128.0 + 50.0 * smooth + 20.0 * noise).round().clamp(0, 255)
        out[lo:lo + m] = x.permute(0, 2, 3, 1).to(torch.uint8).cpu().numpy()
    return out
