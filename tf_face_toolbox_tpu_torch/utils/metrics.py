"""Metric logging: console lines with the step rate (faces/sec), and a
scalar writer where one imports.

Counterpart of ``tf_face_toolbox_tpu/utils/metrics.py``. The writer is
``torch.utils.tensorboard.SummaryWriter`` when that imports (it needs
the ``tensorboard`` package); otherwise the logger is console only.
"""

from __future__ import annotations

import logging
import time
from typing import Mapping

log = logging.getLogger(__name__)


class MetricLogger:
    """Scalar logger with step-rate (faces/sec) tracking."""

    def __init__(self, logdir: str | None = None, *,
                 batch_size: int | None = None):
        self.batch_size = batch_size
        self._writer = None
        if logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(logdir)
            except ImportError as e:
                log.warning("no scalar writer (%s); console only", e)
        self._last_time: float | None = None
        self._last_step: int | None = None

    def log(self, step: int, scalars: Mapping[str, float]) -> dict:
        """Log ``scalars`` at ``step``, adding steps_per_sec and
        faces_per_sec since the previous call; returns what it logged."""
        scalars = {k: float(v) for k, v in scalars.items()}
        now = time.perf_counter()
        if self._last_time is not None and step > self._last_step:
            steps_per_sec = (step - self._last_step) / (now - self._last_time)
            scalars["steps_per_sec"] = steps_per_sec
            if self.batch_size:
                scalars["faces_per_sec"] = steps_per_sec * self.batch_size
        self._last_time, self._last_step = now, step
        if self._writer is not None:
            for k, v in scalars.items():
                self._writer.add_scalar(k, v, step)
        log.info("step %d: %s", step,
                 " ".join(f"{k}={v:.5g}" for k, v in scalars.items()))
        return scalars

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
