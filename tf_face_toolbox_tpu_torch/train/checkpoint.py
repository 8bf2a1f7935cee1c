"""Checkpoint save / restore / resume.

Counterpart of ``tf_face_toolbox_tpu/train/checkpoint.py``'s
``CheckpointManager``, in the port's own on-disk format (Orbax cannot be
read without jax; weights cross between the packages through the
``.npz`` hand-off instead). One directory per step:

    <dir>/<step>/state.pt    torch.save of host copies of the state's
                             tensors: params and BN buffers by
                             state_dict name, the classifier in its
                             global (C*K, D) shape, the optimizer's
                             state by parameter name ("classifier" for
                             the classifier's, global too): SGD's
                             momentum buffers as "momentum", the
                             others' slots as "optimizer_state"/<slot>
                             (Adam's and AdamW's step, exp_avg and
                             exp_avg_sq, LARS's trace), the EMA of
                             params, the loss heads' state (the center
                             table in its global (C_pad, D) shape)
    <dir>/<step>/meta.json   step, the optimizer and its count (apart
                             from the step: a skipped step holds it),
                             rng, has_ema, the head-state children and
                             the global shape of every saved tensor

A step is written to ``<dir>/.<step>.tmp`` and renamed into place with
``os.replace``, so a crash never leaves a half-written step that
``latest_step`` would pick. Saves are synchronous: ``wait`` and
``close`` exist for the JAX API and have nothing to wait for.

Runs over several ranks (``mesh``, a ``parallel.mesh.Topology``): every
rank calls the same methods; the ranks of each model row gather their
classifier shards and the shards' optimizer state into the global
(C_pad * K, D) shape, and their center shards into (C_pad, D), then
rank 0 writes,
after a barrier, and a second barrier follows, so that no rank lists a
step still in its temporary directory. Every rank restores onto its own
device, the classifier, its optimizer state and the centers re-sliced by
its model index; a saved global row count other than this run's raises,
as does a resume under another optimizer.
``save_best`` acts on rank 0's reading of the bar.
"""

from __future__ import annotations

import json
import os
import shutil

import torch

from tf_face_toolbox_tpu_torch.parallel import collectives
from tf_face_toolbox_tpu_torch.train.state import TrainState

_STATE, _META = "state.pt", "meta.json"


def _host(tree):
    """Host copies of a (nested) dict of tensors."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _shapes(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _shapes(v, f"{prefix}/{k}" if prefix else k, out)
    else:
        out[prefix] = list(tree.shape)
    return out


def _shard_rows(mesh) -> tuple[int, int]:
    """(model size, model index) of ``mesh`` (one shard without one)."""
    return (mesh.model, mesh.model_index) if mesh is not None else (1, 0)


def _slots(state: TrainState) -> dict[str, dict[str, torch.Tensor]]:
    """The optimizer's state by slot, then parameter name; none before
    the first applied update (torch creates it then)."""
    opt = state.opt_state["optimizer"]
    out: dict = {}
    for name, p in _trained(state).items():
        for slot, t in opt.state.get(p, {}).items():
            out.setdefault(slot, {})[name] = t
    return out


def _trained(state: TrainState) -> dict[str, torch.Tensor]:
    return {**state.params, "classifier": state.classifier}


def _fill(dst: dict, src: dict, what: str) -> None:
    """Copy ``src``'s tensors into ``dst``'s in place; the names, shapes
    and dtypes must match."""
    if dst.keys() != src.keys():
        missing, extra = sorted(dst.keys() - src.keys()), sorted(
            src.keys() - dst.keys())
        raise ValueError(f"checkpoint {what} do not match the state: "
                         f"{len(missing)} missing (e.g. {missing[:3]}), "
                         f"{len(extra)} extra (e.g. {extra[:3]})")
    with torch.no_grad():
        for k, t in dst.items():
            s = src[k]
            if s.shape != t.shape or s.dtype != t.dtype:
                raise ValueError(f"checkpoint {what}/{k}: {tuple(s.shape)} "
                                 f"{s.dtype}, the state has "
                                 f"{tuple(t.shape)} {t.dtype}")
            t.copy_(s)


class CheckpointManager:
    """Periodic save, latest-checkpoint resume, GC of the oldest steps,
    and the best-eval checkpoint in ``<dir>/best``."""

    _BEST_JSON = "best_step.json"

    def __init__(self, directory: str, *, save_every: int = 1000,
                 keep: int = 5, mesh=None):
        self._dir = os.path.abspath(directory)
        self.save_every = save_every
        self.keep = keep
        self.mesh = mesh
        self._main = mesh is None or mesh.is_main
        self._best_mgr: CheckpointManager | None = None

    @property
    def directory(self) -> str:
        return self._dir

    # ---- saving -------------------------------------------------------

    def maybe_save(self, state: TrainState, *, step: int | None = None,
                   force: bool = False) -> bool:
        """Save if ``step`` (default ``state.step``) hits the cadence, or
        when ``force``. A step already on disk is kept as it is (the
        state at a step is that step's), as Orbax skips it."""
        step = state.step if step is None else step
        if not force and (self.save_every <= 0 or step % self.save_every):
            return False
        collectives.barrier(self.mesh)
        # every rank of a model row gathers its shards (a collective)
        slots = _slots(state)
        for slot in sorted(slots):
            buf = slots[slot].get("classifier")
            if buf is not None and buf.dim():
                slots[slot]["classifier"] = collectives.model_all_gather(
                    buf, self.mesh)
        classifier = collectives.model_all_gather(
            state.classifier.detach(), self.mesh)
        head = dict(state.head_state or {})
        if "centers" in head:
            head["centers"] = collectives.model_all_gather(
                head["centers"].detach(), self.mesh)
        if self._main:
            self._write(state, step, classifier, slots, head)
        collectives.barrier(self.mesh)
        return True

    def _write(self, state: TrainState, step: int, classifier: torch.Tensor,
               slots: dict, head: dict) -> bool:
        final = os.path.join(self._dir, str(step))
        if os.path.isdir(final):
            return False
        tensors = {"params": _host(state.params),
                   "batch_stats": _host(state.batch_stats),
                   "classifier": _host(classifier)}
        if state.opt_state["name"] == "sgd":
            tensors["momentum"] = _host(slots.get("momentum_buffer", {}))
        else:
            tensors["optimizer_state"] = _host(slots)
        if state.ema_params is not None:
            tensors["ema_params"] = _host(state.ema_params)
        if head:
            tensors["head_state"] = _host(head)
        meta = {"step": int(step), "optimizer": state.opt_state["name"],
                "count": int(state.opt_state["count"]),
                "rng": int(state.rng),
                "has_ema": state.ema_params is not None,
                "head_state": sorted(state.head_state or {}),
                "shapes": _shapes(tensors, "", {})}
        tmp = os.path.join(self._dir, f".{step}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _STATE), "wb") as f:
            torch.save(tensors, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        if self.keep > 0:
            for old in self.all_steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)
        return True

    # ---- the steps on disk ----------------------------------------------

    def all_steps(self) -> list[int]:
        """Every retained checkpoint step, ascending."""
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def refresh(self) -> None:
        """Nothing to drop: the steps are listed from the directory on
        every call, so a watcher sees another process's saves at once."""

    def _step(self, step: int | None) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self._dir}")
        return step

    def metadata(self, step: int | None = None) -> dict | None:
        """The step's meta.json (None when there is no checkpoint)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        with open(os.path.join(self._dir, str(step), _META)) as f:
            return json.load(f)

    def global_shapes(self, step: int | None = None) -> dict:
        """Shape of every saved tensor, keyed by its path:
        ``"classifier"`` -> (C*K, D), ``"params/<name>"``, ..."""
        meta = self.metadata(self._step(step))
        return {k: tuple(v) for k, v in meta["shapes"].items()}

    def has_ema(self, meta: dict | None = None) -> bool:
        meta = self.metadata() if meta is None else meta
        return bool(meta and meta["has_ema"])

    def head_state_children(self, meta: dict | None = None) -> set[str]:
        """Names of the checkpoint's ``TrainState.head_state`` entries
        (empty when it was None)."""
        meta = self.metadata() if meta is None else meta
        return set(meta["head_state"]) if meta else set()

    # ---- restoring ----------------------------------------------------

    def _load(self, step: int, device) -> dict:
        return torch.load(os.path.join(self._dir, str(step), _STATE),
                          weights_only=True, map_location=device)

    def restore(self, template_state: TrainState,
                step: int | None = None) -> TrainState:
        """Restore into ``template_state`` (a fresh ``create_train_state``)
        in place and return it: its tensors are filled where they are
        (the optimizer keeps its parameter references), the optimizer's
        state is set explicitly (none where the checkpoint has none),
        and the step, count and rng are the checkpoint's."""
        step = self._step(step)
        meta = self.metadata(step)
        st = template_state
        saved_opt, mine = meta.get("optimizer", "sgd"), st.opt_state["name"]
        if saved_opt != mine:
            raise ValueError(
                f"checkpoint optimizer {saved_opt!r} does not match this "
                f"run's {mine!r}: resume with --optimizer={saved_opt} (the "
                "optimizer the run was started with)")
        if meta["has_ema"] != (st.ema_params is not None):
            want = "--ema_decay>0" if meta["has_ema"] else "--ema_decay=0"
            raise ValueError(
                "checkpoint EMA state does not match config: resume "
                f"with {want} (the same setting the run was started with)")
        ck_heads, st_heads = set(meta["head_state"]), set(st.head_state or {})
        if ck_heads != st_heads:
            raise ValueError(
                "checkpoint loss-head state does not match config: "
                f"checkpoint has {sorted(ck_heads) or 'none'}, config "
                f"builds {sorted(st_heads) or 'none'}: resume with the "
                "same --margin/--center_loss settings the run was started "
                "with")
        device = st.classifier.device
        saved = self._load(step, device)
        model, index = _shard_rows(self.mesh)
        shard = st.classifier.shape[0]
        rows = saved["classifier"].shape[0]
        if rows != shard * model:
            raise ValueError(
                f"checkpoint classifier has {rows} rows, this run's "
                f"{shard * model} (classes padded to the model axis of "
                f"{model}, times the sub-centers): restore with the "
                "--num_classes and --subcenters the run was started with")

        def own(t, shard=shard):    # this rank's rows of a global tensor
            return t[index * shard:(index + 1) * shard]

        _fill(st.params, saved["params"], "params")
        _fill(st.batch_stats, saved["batch_stats"], "batch_stats")
        _fill({"classifier": st.classifier},
              {"classifier": own(saved["classifier"])}, "classifier")
        slots = (saved["optimizer_state"] if "optimizer_state" in saved
                 else {"momentum_buffer": saved["momentum"]})
        for by_name in slots.values():
            buf = by_name.get("classifier")
            if buf is not None and buf.dim():
                by_name["classifier"] = own(buf).clone()
        if st.ema_params is not None:
            _fill(st.ema_params, saved["ema_params"], "ema_params")
        for child, tree in (st.head_state or {}).items():
            src = saved["head_state"][child]
            if child != "centers":
                _fill(tree, src, f"head_state/{child}")
                continue
            # the center table: global in the file, a shard in the state
            c_shard = tree.shape[0]
            if src.shape[0] != c_shard * model:
                raise ValueError(
                    f"checkpoint centers have {src.shape[0]} rows, this "
                    f"run's {c_shard * model} (classes padded to the model "
                    f"axis of {model}): restore with the --num_classes the "
                    "run was started with")
            _fill({child: tree}, {child: own(src, c_shard)}, "head_state")
        opt = st.opt_state["optimizer"]
        trained = _trained(st)
        for slot, by_name in slots.items():
            extra = sorted(by_name.keys() - trained.keys())
            if extra:
                raise ValueError(f"checkpoint {slot} for unknown parameters "
                                 f"{extra[:3]}")
        for name, p in trained.items():
            entry = {}
            for slot, by_name in slots.items():
                buf = by_name.get(name)
                if buf is None:
                    continue
                if slot == "step":
                    # torch keeps Adam's count as a host f32 scalar
                    entry[slot] = buf.to("cpu", torch.float32)
                    continue
                if buf.shape != p.shape or buf.dtype != p.dtype:
                    raise ValueError(f"checkpoint {slot}/{name}: "
                                     f"{tuple(buf.shape)}, the parameter "
                                     f"{tuple(p.shape)}")
                entry[slot] = buf
            if entry:
                opt.state[p] = entry
            else:
                opt.state.pop(p, None)
        st.step = meta["step"]
        st.opt_state["count"] = meta["count"]
        st.rng = meta["rng"]
        return st

    def restore_raw(self, step: int | None = None) -> dict:
        """The checkpoint as saved, on the host, with no template: the
        tensors with their own shapes (``params``, ``batch_stats``,
        ``classifier``, ``momentum`` or ``optimizer_state``, ``ema_params``
        and ``head_state`` when saved) and the ``step``, ``count`` and
        ``rng``. The warm-start loader
        (``train.finetune``) needs exactly this: a shape that differs
        from the new run's is a graft-time skip, not a restore error."""
        step = self._step(step)
        meta = self.metadata(step)
        raw = self._load(step, "cpu")
        raw.update(step=meta["step"], count=meta["count"], rng=meta["rng"])
        return raw

    # ---- the best-eval checkpoint (--keep_best) -----------------------
    # The periodic ring keeps ``keep`` steps; ``save_best`` keeps the
    # best eval's state alive in ``<dir>/best``, itself a checkpoint
    # directory (``--checkpoint_dir=<run>/best`` serves it), with the bar
    # in ``<dir>/best_step.json``, read again on resume so a restarted
    # run never demotes an earlier, better checkpoint. Higher is better.

    def best_info(self) -> dict | None:
        """{"step", "metric", "name"} of the best save, or None."""
        path = os.path.join(self._dir, self._BEST_JSON)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save_best(self, state: TrainState, *, step: int, metric: float,
                  name: str = "metric") -> bool:
        """Save to ``<dir>/best`` iff ``metric`` beats the stored bar.
        The bar is written after the checkpoint is in place, so a crash
        between the two never leaves a bar without its checkpoint. With
        several ranks, rank 0's decision (its ``metric`` against the bar
        it reads) is every rank's."""
        improved = 0.0
        if self._main:
            best = self.best_info()
            improved = float(best is None or metric > best["metric"])
        if not collectives.broadcast_value(improved, self.mesh):
            return False
        if self._best_mgr is None:
            self._best_mgr = CheckpointManager(
                os.path.join(self._dir, "best"), save_every=0, keep=1,
                mesh=self.mesh)
        self._best_mgr.maybe_save(state, step=step, force=True)
        if self._main:
            path = os.path.join(self._dir, self._BEST_JSON)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"step": int(step), "metric": float(metric),
                           "name": name}, f)
            os.replace(tmp, path)
        return True

    def wait(self) -> None:
        """Saves are synchronous: each is on disk when ``maybe_save``
        returns."""

    def close(self) -> None:
        """Nothing is held open between saves."""
