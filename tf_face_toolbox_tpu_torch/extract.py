"""Feature extraction: flip-averaged, L2-normalized face embeddings.

Counterpart of ``tf_face_toolbox_tpu/extract.py`` for pixel inputs:
each face and its mirror go through ONE forward pass as ``[x; flip(x)]``,
the two halves are summed and L2-normalized. Embeddings are f32 under
any compute dtype.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models.layers import l2_normalize


def flip_averaged_embeddings(apply_fn: Callable, images: torch.Tensor
                             ) -> torch.Tensor:
    """l2norm(f(x) + f(flip(x))) for NHWC pixel ``images``.

    ``apply_fn(images) -> (N, D)`` runs the backbone in eval mode. The
    flip is along the width axis (NHWC axis 2), as
    tf.image.flip_left_right.
    """
    n = images.shape[0]
    both = torch.cat([images, images.flip(2)], dim=0)
    emb = apply_fn(both)
    return l2_normalize((emb[:n] + emb[n:]).to(torch.float32))


def make_extract_fn(apply_fn: Callable) -> Callable:
    """``extract(images) -> (N, D) f32 embeddings`` for a backbone's
    eval forward (a module, or ``serving.make_serving_apply``'s apply)."""

    @torch.inference_mode()
    def extract(images: torch.Tensor) -> torch.Tensor:
        return flip_averaged_embeddings(apply_fn, images)

    return extract


def extract_shard(net, variables, source, *, image_size: int,
                  crop_from: int = 0, batch: int = 256,
                  num_threads: int = 4, loader: str = "auto",
                  norm: str = "per_image",
                  extract_fn: Callable | None = None,
                  progress: Callable[[int, int], None] | None = None,
                  rows: tuple[int, int] | None = None,
                  device: str | torch.device = "cuda") -> np.ndarray:
    """Extract embeddings for every record of a FaceShardSource.

    - host: decode + half-pixel bilinear resize to ``crop_from``
      (default image_size + 8, the training scale)
    - device: center crop to ``image_size`` + standardize, then
      flip-averaged extraction, in ``batch``-sized chunks.

    ``extract_fn(images) -> embeddings`` defaults to the module path:
    ``net`` (a port module) with ``variables`` (the JAX key space,
    nested or flat) loaded into it. ``loader``: "auto" (native C++
    pool when it loads, else the Python pool), "native" or "python".
    """
    device = torch.device(device)
    if extract_fn is None:
        from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
        net = load_jax_variables(net, variables).to(device).eval()
        extract_fn = make_extract_fn(net)
    n = (rows[1] - rows[0]) if rows is not None else source.index.count
    outs = []
    done = 0
    for x in _standardized_batches(source, image_size=image_size,
                                   crop_from=crop_from, batch=batch,
                                   num_threads=num_threads, loader=loader,
                                   norm=norm, rows=rows, device=device):
        outs.append(extract_fn(x).cpu().numpy())
        done += x.shape[0]
        if progress is not None:
            progress(done, n)
    if not outs:
        raise ValueError("nothing to extract: empty shard or row range")
    return np.concatenate(outs)


def _standardized_batches(source, *, image_size: int, crop_from: int = 0,
                          batch: int = 256, num_threads: int = 4,
                          loader: str = "auto",
                          norm: str = "per_image",
                          rows: tuple[int, int] | None = None,
                          device: str | torch.device = "cuda"):
    """Yield the eval-chain standardized image batches of a shard
    (decode -> resize to crop_from -> center crop -> standardize), f32
    NHWC on ``device``. ``rows``: half-open [lo, hi) record range."""
    from tf_face_toolbox_tpu_torch.ops.preprocess import preprocess_eval

    crop_from = crop_from or image_size + 8
    if crop_from < image_size:
        raise ValueError(
            f"crop_from ({crop_from}) must be >= image_size "
            f"({image_size}): the eval chain center-crops image_size "
            f"out of the crop_from-sized resize")
    if loader == "auto":
        from tf_face_toolbox_tpu_torch.data.native import native_available
        loader = "native" if native_available() else "python"
    if loader not in ("native", "python"):
        raise NotImplementedError(
            f"loader {loader!r} is not ported yet (ROADMAP.md §1 item 17); "
            "use native or python")
    n = source.index.count
    row_lo, row_hi = rows if rows is not None else (0, n)
    if not 0 <= row_lo <= row_hi <= n:
        raise ValueError(f"rows [{row_lo}, {row_hi}) out of range for "
                         f"a {n}-record shard")
    windows = [list(range(lo, min(lo + batch, row_hi)))
               for lo in range(row_lo, row_hi, batch)]

    def to_device(u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(u8).to(device)

    if loader == "native":
        from tf_face_toolbox_tpu_torch.data.native import NativeShardReader
        reader = NativeShardReader(source.index.path,
                                   num_threads=num_threads)
        try:
            for bi, ids in enumerate(windows):
                if bi + 1 < len(windows):  # readahead next window
                    reader.prefetch(windows[bi + 1])
                u8 = reader.decode_batch(ids, crop_from, crop_from)
                yield preprocess_eval(to_device(u8), image_size, image_size,
                                      norm)
        finally:
            reader.close()
        return

    from tf_face_toolbox_tpu_torch.data.pipeline import _DecodePool, _resize_u8
    transform = lambda im: _resize_u8(im, crop_from, crop_from)  # noqa: E731
    pool = _DecodePool(source, num_threads) if num_threads > 1 else None
    try:
        for ids in windows:
            if pool is not None:
                records = pool.decode(ids, transform)
            else:
                records = [(transform(source.record(i)[0]), 0) for i in ids]
            images = np.stack([r[0] for r in records])
            yield preprocess_eval(to_device(images), image_size, image_size,
                                  norm)
    finally:
        if pool is not None:
            pool.close()


def extract_dataset(extract_fn: Callable, batches: Iterable[np.ndarray],
                    device: str | torch.device = "cuda") -> np.ndarray:
    """Extract embeddings for a stream of standardized image batches."""
    outs = [extract_fn(torch.as_tensor(np.asarray(b)).to(device)).cpu().numpy()
            for b in batches]
    return np.concatenate(outs, axis=0)
