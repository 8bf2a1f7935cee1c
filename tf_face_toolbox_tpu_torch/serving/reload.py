"""Checkpoint watcher: TF-Serving-style model version polling.

Counterpart of ``tf_face_toolbox_tpu/serving/reload.py``:
:class:`CheckpointWatcher` polls a port train dir
(``train.checkpoint.CheckpointManager``) and hot-swaps the resident
:class:`~tf_face_toolbox_tpu_torch.serving.server.EmbeddingService`
onto the newest step via :meth:`EmbeddingService.reload`; requests keep
flowing through the old weights until the swap, which is atomic.

The expensive half of a reload (checkpoint restore, a static-int8
daemon's calibration pass, BN re-fold and the warm-up of the rebuilt
forward) runs on the watcher thread, never on
the request path. A reload that fails for any reason (a checkpoint
still being written, a build error) is logged and retried next poll;
the daemon keeps serving the previous weights.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable

logger = logging.getLogger(__name__)


class CheckpointWatcher:
    """Poll ``checkpoint_dir`` and hot-reload the service on new steps.

    ``rebuild()`` is the boot-time model-build chain packaged as a
    closure (cli.serve owns it: restore -> static-int8 calibration where
    asked -> optional fold). It returns
    ``(variables, apply_fn_or_None, step)``; ``apply_fn=None`` means
    the module path's bare variable swap.
    """

    def __init__(self, service, checkpoint_dir: str,
                 rebuild: Callable[[], tuple], *,
                 interval: float = 30.0):
        from tf_face_toolbox_tpu_torch.train.checkpoint import (
            CheckpointManager)

        self.service = service
        self.interval = float(interval)
        self._mgr = CheckpointManager(checkpoint_dir)
        self._rebuild = rebuild
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self) -> bool:
        """One poll: reload if a newer step exists. Returns True on a
        completed swap; False (never raises) otherwise."""
        try:
            self._mgr.refresh()      # see checkpoints OTHER processes wrote
            latest = self._mgr.latest_step()
        except Exception as e:       # unreadable dir: keep serving
            logger.warning("checkpoint poll failed: %s", e)
            return False
        if latest is None or latest == self.service.step:
            return False
        old = self.service.step
        try:
            variables, apply_fn, step = self._rebuild()
            if apply_fn is None:
                self.service.reload(variables, step=step)
            else:
                self.service.reload(variables, apply_fn=apply_fn,
                                    step=step)
        # SystemExit too: it is a BaseException, and a rebuild closure
        # that reuses boot-path helpers could leak one; in a non-main
        # thread Python swallows it and the watcher would die silently
        except (Exception, SystemExit) as e:
            logger.warning("reload to step %s failed (still serving "
                           "step %s): %s", latest, old, e)
            return False
        logger.info("hot-reloaded serving weights: step %s -> %s",
                    old, step)
        return True

    def start(self) -> "CheckpointWatcher":
        def loop():
            while not self._stop.wait(self.interval):
                self.poll_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="ckpt-watcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
