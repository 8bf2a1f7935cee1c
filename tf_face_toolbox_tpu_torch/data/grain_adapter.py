"""FaceShard as a ``torch.utils.data`` dataset.

Counterpart of ``tf_face_toolbox_tpu/data/grain_adapter.py`` (kept under
that name so a reader finds it): where the JAX package plugs FaceShard
files into grain's loader, the port plugs them into PyTorch's
``DataLoader``, the multi-worker prefetch machinery PyTorch code
standardizes on. The port's own iterators (``data/pipeline.py``, the
native loader) remain the default training path.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from tf_face_toolbox_tpu_torch.data.pipeline import FaceShardSource


class FaceShardDataSource(torch.utils.data.Dataset):
    """Map-style dataset over one FaceShard file.

    Records are ``{'image': (H, W, 3) u8, 'label': int32}``, as the JAX
    adapter's grain records are.
    """

    def __init__(self, path: str):
        self._source = FaceShardSource(path)

    def __len__(self) -> int:
        return self._source.index.count

    def __getitem__(self, record_key: int) -> dict[str, Any]:
        image, label = self._source.record(int(record_key))
        if not image.flags.writeable:   # PIL's decode: torch wants a copy
            image = image.copy()
        return {"image": image, "label": np.int32(label)}


def make_grain_dataset(path: str, *, batch_size: int, seed: int = 0,
                       worker_count: int = 0) -> torch.utils.data.DataLoader:
    """A shuffled ``DataLoader`` over a FaceShard: drop-remainder batches
    of ``{'image': (B, H, W, 3) uint8, 'label': (B,) int32}`` tensors,
    the order drawn from a ``torch.Generator`` seeded with ``seed`` (the
    same seed gives the same order). ``worker_count`` decode processes
    (0 = in the caller's process)."""
    return torch.utils.data.DataLoader(
        FaceShardDataSource(path), batch_size=batch_size, shuffle=True,
        drop_last=True, num_workers=worker_count,
        generator=torch.Generator().manual_seed(seed))
