"""Feature extraction: flip-averaged, L2-normalized face embeddings.

Counterpart of ``tf_face_toolbox_tpu/extract.py``: each face and its
mirror go through ONE forward pass as ``[x; flip(x)]``, the two halves
are summed and L2-normalized. A dct-stem net's coefficient input
(``loader="dct_domain"``) flips in the frequency domain. Embeddings
are f32 under any compute dtype. ``with_quality`` also returns each face's
pre-normalization feature magnitude (MagFace's quality signal);
``make_extract_fn(mesh=)`` splits each batch over the data ranks of a
``parallel.mesh.Topology``; ``extract_shard_to_npy`` writes a resumable
``.npy`` in chunks; ``calibrate_on_shard`` takes static-int8 scales
from a shard's first batches.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.models.layers import l2_normalize
from tf_face_toolbox_tpu_torch.ops.dct import flip_coefficients


def flip_averaged_embeddings(apply_fn: Callable, images: torch.Tensor,
                             with_quality: bool = False):
    """l2norm(f(x) + f(flip(x))) for NHWC ``images``.

    ``apply_fn(images) -> (N, D)`` runs the backbone in eval mode. The
    flip is along the width axis (NHWC axis 2), as
    tf.image.flip_left_right; a DCT-coefficient tensor (trailing dim
    C * 64) flips in the frequency domain (``ops/dct.flip_coefficients``,
    exact). ``with_quality``: also return
    ``0.5 * sqrt(sum(s * s) + 1e-12)`` of the f32 sum ``s`` before the
    normalization, the magnitude of (f(x) + f(flip(x))) / 2 -> (embeddings,
    quality (N,) f32).
    """
    n = images.shape[0]
    if images.shape[-1] != 3 and images.shape[-1] % 64 == 0:
        flipped = flip_coefficients(images)
    else:
        flipped = images.flip(2)
    both = torch.cat([images, flipped], dim=0)
    emb = apply_fn(both)
    s = (emb[:n] + emb[n:]).to(torch.float32)
    out = l2_normalize(s)
    if with_quality:
        return out, 0.5 * torch.sqrt(torch.sum(s * s, dim=-1) + 1e-12)
    return out


def make_extract_fn(apply_fn: Callable, *, with_quality: bool = False,
                    mesh=None) -> Callable:
    """``extract(images) -> (N, D) f32 embeddings`` (with ``with_quality``,
    ``(embeddings, quality (N,))``) for a backbone's eval forward (a
    module, or ``serving.make_serving_apply``'s apply).

    ``mesh``: data-parallel over the data ranks of a
    ``parallel.mesh.Topology``. Every rank calls ``extract`` with the
    same whole batch; a batch that does not divide by the data size is
    padded with copies of its first image, each rank forwards its block
    of the padded batch, the blocks are gathered in rank order
    (``collectives.data_all_gather``) and the pad rows cut: every rank
    returns the whole batch's result.
    """
    from tf_face_toolbox_tpu_torch.parallel import collectives

    n_data = mesh.data if mesh is not None else 1

    @torch.inference_mode()
    def extract(images: torch.Tensor):
        if n_data == 1:
            return flip_averaged_embeddings(apply_fn, images, with_quality)
        n = images.shape[0]
        rem = -n % n_data
        if rem:
            images = torch.cat([images, images[:1].expand(
                rem, *images.shape[1:])])
        rows = images.shape[0] // n_data
        i = mesh.data_index
        out = flip_averaged_embeddings(
            apply_fn, images[i * rows:(i + 1) * rows], with_quality)
        out = out if with_quality else (out,)
        out = tuple(collectives.data_all_gather(o.contiguous(), mesh)[:n]
                    for o in out)
        return out if with_quality else out[0]

    return extract


def extract_shard(net, variables, source, *, image_size: int,
                  crop_from: int = 0, batch: int = 256,
                  num_threads: int = 4, loader: str = "auto",
                  norm: str = "per_image",
                  extract_fn: Callable | None = None,
                  progress: Callable[[int, int], None] | None = None,
                  rows: tuple[int, int] | None = None,
                  with_quality: bool = False,
                  device: str | torch.device = "cuda"):
    """Extract embeddings for every record of a FaceShardSource.

    - host: decode + half-pixel bilinear resize to ``crop_from``
      (default image_size + 8, the training scale)
    - device: center crop to ``image_size`` + standardize, then
      flip-averaged extraction, in ``batch``-sized chunks.

    ``extract_fn(images) -> embeddings`` defaults to the module path:
    ``net`` (a port module) with ``variables`` (the JAX key space,
    nested or flat) loaded into it. ``loader``: "auto" (native C++
    pool when it loads, else the Python pool), "native", "python",
    "native_dct" (entropy decode on the host, ``ops/jpeg.decode_dct`` on
    the device; a ``cli.pack --recode_size`` shard of crop_from
    geometry) or "dct_domain" (a dct-stem net's zero-decode input: the
    coefficients through ``ops/dct.prepare_coefficients``, flipped in
    the frequency domain; a shard recoded at image_size, and crop_from
    defaults to it). ``with_quality``: also return per-face
    feature-norm quality scores -> ``(embeddings (N, D), quality
    (N,))``; a given ``extract_fn`` must then return the pair.
    """
    device = torch.device(device)
    crop_from = _dct_domain_crop(net, loader, image_size, crop_from)
    if extract_fn is None:
        extract_fn = make_extract_fn(_module(net, variables, device),
                                     with_quality=with_quality)
    n = (rows[1] - rows[0]) if rows is not None else source.index.count
    outs = []
    done = 0
    for x in _standardized_batches(source, image_size=image_size,
                                   crop_from=crop_from, batch=batch,
                                   num_threads=num_threads, loader=loader,
                                   norm=norm, rows=rows, device=device):
        out = extract_fn(x)
        outs.append(tuple(o.cpu().numpy() for o in out) if with_quality
                    else out.cpu().numpy())
        done += x.shape[0]
        if progress is not None:
            progress(done, n)
    if not outs:
        raise ValueError("nothing to extract: empty shard or row range")
    if with_quality:
        return (np.concatenate([o[0] for o in outs]),
                np.concatenate([o[1] for o in outs]))
    return np.concatenate(outs)


def _dct_domain_crop(net, loader: str, image_size: int,
                     crop_from: int) -> int:
    """``crop_from`` as the loader takes it: ``dct_domain`` feeds a
    dct-stem net only (another would convolve 192 coefficients as
    channels), and no crop exists in the coefficient domain, so its
    source size defaults to ``image_size``."""
    if loader != "dct_domain":
        return crop_from
    if getattr(net, "stem", None) != "dct":
        raise ValueError("loader='dct_domain' requires a stem='dct' "
                         "backbone (e.g. dct_resnet_50)")
    return crop_from or image_size


def calibrate_on_shard(network: str, variables, source, *, image_size: int,
                       crop_from: int = 0, batch: int = 128,
                       num_batches: int = 4, loader: str = "auto",
                       norm: str = "per_image",
                       device: str | torch.device = "cuda",
                       **net_kwargs) -> dict:
    """Static-int8 calibration over the first ``num_batches`` batches of
    an eval shard (the serving distribution), through the eval chain
    ``extract_shard`` uses. Returns ``variables`` with the frozen
    ``quant_stats`` for ``quantized="static"`` serving
    (``models.calibrate_quant_stats``; ``net_kwargs``: its network
    fields, ``embedding_dim`` and ``dtype`` among them)."""
    from tf_face_toolbox_tpu_torch.models import calibrate_quant_stats

    if loader == "dct_domain":      # no crop in the coefficient domain
        crop_from = crop_from or image_size
    n = source.index.count
    batches = _standardized_batches(
        source, image_size=image_size, crop_from=crop_from, batch=batch,
        loader=loader, norm=norm, rows=(0, min(n, batch * num_batches)),
        device=device)
    return calibrate_quant_stats(network, variables, batches, device=device,
                                 **net_kwargs)


def _module(net, variables, device) -> torch.nn.Module:
    """``net`` holding ``variables`` (the JAX key space), on ``device``,
    in eval mode."""
    from tf_face_toolbox_tpu_torch.interop.port import load_jax_variables
    return load_jax_variables(net, variables).to(device).eval()


def extract_shard_to_npy(net, variables, source, output_path: str, *,
                         image_size: int, crop_from: int = 0,
                         batch: int = 256, chunk_rows: int = 0,
                         num_threads: int = 4, loader: str = "auto",
                         norm: str = "per_image",
                         extract_fn: Callable | None = None,
                         progress: Callable[[int, int], None] | None = None,
                         rows: tuple[int, int] | None = None,
                         fingerprint: str = "", mesh=None,
                         device: str | torch.device = "cuda"):
    """Resumable bulk extraction with O(chunk) host memory.

    Writes straight into a disk-backed ``.npy`` (an ``np.lib.format``
    memmap, so the finished file is an ordinary numpy array) in
    ``chunk_rows``-sized chunks (default 64 * batch, rounded down to the
    batch grid), recording the finished chunks in a sidecar after each
    flush: ``<output>.progress.json``, or
    ``<output>.rows<lo>-<hi>.progress.json`` for a ``rows`` range, so that range jobs never clobber each other's
    state. The sidecar holds the JAX package's ``meta`` fields (total
    rows, rows, chunk_rows, batch, image_size, crop_from, loader, norm,
    fingerprint) and a sorted ``done`` list of chunk starts, is written
    through a ``.tmp`` and ``os.replace``, and is kept on completion, so
    a retry of a finished job recomputes nothing. A re-run after a crash
    skips the finished chunks (at most one chunk is recomputed); progress
    is reused only when every meta field matches (``fingerprint``: the
    caller's model and config identity, so a resumed run under other
    weights recomputes its range instead of mixing two models). An
    existing output of the wrong shape or dtype raises; ``rows`` land at
    their true offsets of a full-length output, so disjoint ranges run
    one after another fill one file. Creating the output removes every
    sidecar of its path first (any range's): they describe the rows of a
    file that is gone, and would mark chunks done in the new one.

    ``mesh``: a data-parallel ``extract_fn`` runs on every rank of it;
    every rank reads the same progress (before a barrier, ahead of any
    write) and computes every chunk, and only the main rank writes the
    output and the sidecar. Returns the finished array (a read-mode
    memmap; None on the other ranks).
    """
    import json
    import os

    from tf_face_toolbox_tpu_torch.parallel import collectives

    device = torch.device(device)
    main = mesh is None or mesh.is_main
    n_total = source.index.count
    row_lo, row_hi = rows if rows is not None else (0, n_total)
    if not 0 <= row_lo < row_hi <= n_total:
        raise ValueError(f"rows [{row_lo}, {row_hi}) out of range for "
                         f"a {n_total}-record shard")
    if not output_path.endswith(".npy"):
        raise ValueError("resumable extraction writes .npy (the memmap "
                         f"format); got {output_path!r}")
    chunk_rows = chunk_rows or 64 * batch
    # chunks on the batch grid: a resumed chunk batches as the first run
    chunk_rows = max(batch, chunk_rows - chunk_rows % batch)
    crop_from = _dct_domain_crop(net, loader, image_size, crop_from)
    full_range = (row_lo, row_hi) == (0, n_total)
    sidecar = output_path + ("" if full_range
                             else f".rows{row_lo}-{row_hi}") \
        + ".progress.json"
    meta = {"total_rows": n_total, "rows": [row_lo, row_hi],
            "chunk_rows": chunk_rows, "batch": batch,
            "image_size": image_size, "crop_from": crop_from,
            "loader": loader, "norm": norm, "fingerprint": fingerprint}
    done_chunks: set[int] = set()
    out = None
    if os.path.exists(output_path):
        # an earlier run's output (perhaps of another range) or the wrong
        # file, which the caller must delete: never silently recreated
        out = np.lib.format.open_memmap(output_path,
                                        mode="r+" if main else "r")
        if (out.ndim != 2 or out.shape[0] != n_total
                or out.dtype != np.float32):
            raise ValueError(
                f"{output_path} exists with shape {out.shape} "
                f"{out.dtype}, incompatible with this {n_total}-row "
                "extraction; delete it to start over")
        if os.path.exists(sidecar):
            try:
                with open(sidecar) as f:
                    prev = json.load(f)
            except (OSError, json.JSONDecodeError):
                prev = None
            if prev and all(prev.get(k) == v for k, v in meta.items()):
                done_chunks = set(prev.get("done", []))
    # every rank has read the progress before the main rank writes any
    collectives.barrier(mesh)
    if extract_fn is None:
        extract_fn = make_extract_fn(_module(net, variables, device))
    chunks = list(range(row_lo, row_hi, chunk_rows))
    done_rows = sum(min(c + chunk_rows, row_hi) - c
                    for c in chunks if c in done_chunks)
    for clo in chunks:
        chi = min(clo + chunk_rows, row_hi)
        if clo in done_chunks:
            continue
        chunk = np.concatenate([
            extract_fn(x).cpu().numpy().astype(np.float32, copy=False)
            for x in _standardized_batches(
                source, image_size=image_size, crop_from=crop_from,
                batch=batch, num_threads=num_threads, loader=loader,
                norm=norm, rows=(clo, chi), device=device)])
        done_chunks.add(clo)
        done_rows += chi - clo
        if main:
            if out is None:
                _drop_sidecars(output_path)
                out = np.lib.format.open_memmap(
                    output_path, mode="w+", dtype=np.float32,
                    shape=(n_total, chunk.shape[1]))
            if chunk.shape[1] != out.shape[1]:
                raise ValueError(
                    f"embedding dim {chunk.shape[1]} vs existing "
                    f"{output_path} dim {out.shape[1]}; delete the file "
                    "if the model changed")
            out[clo:chi] = chunk
            out.flush()
            with open(sidecar + ".tmp", "w") as f:
                json.dump({**meta, "done": sorted(done_chunks)}, f)
            os.replace(sidecar + ".tmp", sidecar)
        if progress is not None:
            progress(done_rows, row_hi - row_lo)
    if not main:
        return None
    if out is None:      # every chunk was done already: validated above
        out = np.lib.format.open_memmap(output_path, mode="r+")
    del out
    return np.lib.format.open_memmap(output_path, mode="r")


def _drop_sidecars(output_path: str) -> None:
    """Remove ``output_path``'s sidecars, the whole file's and every
    range's (``extract_shard_to_npy``), with their ``.tmp`` files."""
    import os
    import re

    folder, name = os.path.split(os.path.abspath(output_path))
    own = re.compile(re.escape(name)
                     + r"(\.rows\d+-\d+)?\.progress\.json(\.tmp)?")
    for f in os.listdir(folder):
        if own.fullmatch(f):
            os.remove(os.path.join(folder, f))


def _standardized_batches(source, *, image_size: int, crop_from: int = 0,
                          batch: int = 256, num_threads: int = 4,
                          loader: str = "auto",
                          norm: str = "per_image",
                          rows: tuple[int, int] | None = None,
                          device: str | torch.device = "cuda"):
    """Yield the eval-chain standardized image batches of a shard
    (decode -> resize to crop_from -> center crop -> standardize), f32
    NHWC on ``device``; with ``loader="dct_domain"``, the standardized
    coefficients (N, image_size / 8, image_size / 8, 192) instead.
    ``rows``: half-open [lo, hi) record range."""
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
    if loader not in ("native", "python", "native_dct", "dct_domain"):
        raise ValueError(f"unknown loader {loader!r}; have auto|native|"
                         "python|native_dct|dct_domain")
    n = source.index.count
    row_lo, row_hi = rows if rows is not None else (0, n)
    if not 0 <= row_lo <= row_hi <= n:
        raise ValueError(f"rows [{row_lo}, {row_hi}) out of range for "
                         f"a {n}-record shard")
    windows = [list(range(lo, min(lo + batch, row_hi)))
               for lo in range(row_lo, row_hi, batch)]

    def to_device(u8: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(u8).to(device)

    if loader == "dct_domain":
        if norm != "per_image":
            raise ValueError(
                "loader='dct_domain' standardizes in the frequency "
                "domain (per-image only); fixed-norm imported models "
                "use a pixel loader")
        if crop_from != image_size:
            raise ValueError(
                f"loader='dct_domain' needs crop_from == image_size "
                f"(got {crop_from} vs {image_size}): center-cropping "
                f"coefficients would need a block-aligned offset; pack "
                f"the shard with --recode_size={image_size}")
        if image_size % 8:
            raise ValueError("image_size must be a multiple of 8 for "
                             "the dct domain")

    if loader in ("native", "native_dct", "dct_domain"):
        from tf_face_toolbox_tpu_torch.data.native import NativeShardReader
        from tf_face_toolbox_tpu_torch.ops.dct import prepare_coefficients
        from tf_face_toolbox_tpu_torch.ops.jpeg import decode_dct
        reader = NativeShardReader(source.index.path,
                                   num_threads=num_threads)
        try:
            for bi, ids in enumerate(windows):
                if bi + 1 < len(windows):  # readahead next window
                    reader.prefetch(windows[bi + 1])
                if loader == "native":
                    u8 = to_device(reader.decode_batch(ids, crop_from,
                                                       crop_from))
                else:
                    coef, qtab = (to_device(a) for a in reader.dct_batch(
                        ids, crop_from, crop_from))
                    if loader == "dct_domain":
                        yield prepare_coefficients(coef, qtab)
                        continue
                    u8 = decode_dct(coef, qtab)
                yield preprocess_eval(u8, image_size, image_size, norm)
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
