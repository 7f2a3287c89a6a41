"""Weight files, their provenance, publish directories and step checkpoints.

Counterpart of ``distkeras_tpu/checkpoint.py``. The weight-file helpers
write and read the reference's format byte for byte: the
:func:`~distkeras_tpu_torch.utils.pytree.serialize_pytree` npz, saved
atomically (a same-directory temp file, then ``os.replace``) and stamped
with a ``__weights_meta__.json`` zip member holding a monotonic ``version``,
the content ``digest`` (sha256 of the serialized bytes, 16 hex characters)
and ``saved_at``. So a file either package writes loads in the other, and
each package's :func:`weights_provenance` reads the other's stamp.

:class:`CheckpointManager` keeps the reference's surface (``save(step,
state=, ps_center=, ps_num_updates=, meta=, wait=)``, ``restore``,
``latest_step``, ``all_steps``, ``max_to_keep``) on a layout of its own, as
the reference's orbax is not available to the port: one directory per step,
written under a temporary name and renamed, holding ``state.npz`` and
``ps.npz`` (weight files) and ``meta.json``. It does not read orbax
directories.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time
import uuid
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from distkeras_tpu_torch.utils.pytree import deserialize_pytree, serialize_pytree

__all__ = [
    "CheckpointManager",
    "save_weights_file",
    "load_weights_file",
    "load_weights_file_with_provenance",
    "load_weights_meta",
    "weights_provenance",
    "weights_digest",
    "publish_weights",
    "read_manifest",
    "MANIFEST_NAME",
]

# Zip member carrying the provenance stamp; the npz readers touch only the
# ``leaf_*`` and ``__treedef__`` members.
_META_MEMBER = "__weights_meta__.json"


def weights_digest(data: bytes) -> str:
    """sha256 over the serialized-tree bytes (before the stamp member is
    appended), truncated to 16 hex characters."""
    return hashlib.sha256(data).hexdigest()[:16]


def save_weights_file(path: str, variables: Any, version: int | None = None,
                      meta: dict | None = None) -> str:
    """Write ``variables`` (a tree of tensors or arrays, typically the
    reference layout ``{"params": ...}``) to ``path`` atomically, stamped
    with ``version`` (default: the stamped version at ``path`` plus one, 1
    for a new path), the content digest, ``saved_at`` and ``meta``'s fields.
    Returns ``path``."""
    data = serialize_pytree(variables)
    if version is None:
        prev = load_weights_meta(path)
        version = int(prev.get("version", 0)) + 1 if prev else 1
    stamp = {
        "version": int(version),
        "digest": weights_digest(data),
        "saved_at": time.time(),
        **(meta or {}),
    }
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
        del data
        with zipfile.ZipFile(tmp, "a") as z:
            z.writestr(_META_MEMBER, json.dumps(stamp))
        with open(tmp, "rb") as f:
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def load_weights_file(path: str, like: Any | None = None) -> Any:
    """Read a weight file of either package into CPU tensors of the
    recorded dtypes: nested dicts (lists for sequence nodes) rebuilt from
    the key paths, or ``like``'s structure."""
    with open(path, "rb") as f:
        return deserialize_pytree(f.read(), like=like)


def load_weights_file_with_provenance(path: str, like: Any | None = None) -> tuple[Any, dict]:
    """The arrays and the provenance from one read of the file, so that a
    concurrent re-publish cannot pair one version's arrays with another's
    stamp."""
    with open(path, "rb") as f:
        data = f.read()
    provenance = _provenance_from_bytes(data)
    provenance["path"] = os.path.abspath(path)
    return deserialize_pytree(data, like=like), provenance


def _provenance_from_bytes(data: bytes) -> dict:
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            if _META_MEMBER in z.namelist():
                meta = json.loads(z.read(_META_MEMBER).decode("utf-8"))
                if isinstance(meta, dict) and meta.get("digest"):
                    return {"version": int(meta.get("version", 0)),
                            "digest": str(meta["digest"])}
    except (ValueError, KeyError, zipfile.BadZipFile):
        pass
    return {"version": 0, "digest": weights_digest(data)}


def load_weights_meta(path: str) -> dict | None:
    """The stamp of a weight file without reading its arrays; None when the
    file is missing, unreadable or unstamped."""
    try:
        with zipfile.ZipFile(path) as z:
            if _META_MEMBER not in z.namelist():
                return None
            meta = json.loads(z.read(_META_MEMBER).decode("utf-8"))
            return meta if isinstance(meta, dict) else None
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def weights_provenance(path: str) -> dict:
    """``{"version", "digest", "path"}`` of a weight file: the stamp, or for
    an unstamped file version 0 and the digest of its bytes (what the
    stamper would have recorded, since such a file is the bare tree)."""
    meta = load_weights_meta(path)
    if meta and meta.get("digest"):
        out = {"version": int(meta.get("version", 0)), "digest": str(meta["digest"])}
    else:
        with open(path, "rb") as f:
            out = _provenance_from_bytes(f.read())
    out["path"] = os.path.abspath(path)
    return out


# -- publish directory: the train -> serve handoff ---------------------------
#
# Versioned, stamped weight files (``weights-v<N>.npz``, immutable once
# published) plus one atomic ``MANIFEST.json`` naming the newest. The weight
# file lands first and the manifest is replaced after, so a reader of the
# manifest never finds a torn or missing file.

MANIFEST_NAME = "MANIFEST.json"


def publish_weights(directory: str, variables: Any, meta: dict | None = None,
                    keep: int = 5) -> dict:
    """Publish ``variables`` as the next ``weights-v<N>.npz`` of
    ``directory`` and point the manifest at it; keep the newest ``keep``
    versions. Returns the manifest with ``path`` absolute."""
    if keep < 2:
        raise ValueError(f"keep must be >= 2 (current + last-good), got {keep}")
    os.makedirs(directory, exist_ok=True)
    prev = read_manifest(directory)
    version = int(prev.get("version", 0)) + 1 if prev else 1
    fname = f"weights-v{version:08d}.npz"
    path = os.path.join(directory, fname)
    save_weights_file(path, variables, version=version, meta=meta)
    manifest = {
        "version": version,
        "digest": (load_weights_meta(path) or {}).get("digest"),
        "path": fname,
        "saved_at": time.time(),
        **(meta or {}),
    }
    tmp = os.path.join(directory, f".{MANIFEST_NAME}.tmp.{os.getpid()}")
    try:
        with open(tmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, MANIFEST_NAME))
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    _prune_published(directory, keep, protect=fname)
    return {**manifest, "path": path}


def _prune_published(directory: str, keep: int, protect: str) -> None:
    """Delete all but the newest ``keep`` published versions, never
    ``protect``; best effort."""
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("weights-v") and n.endswith(".npz"))
    except OSError:
        return
    for name in names[:-keep]:
        if name == protect:
            continue
        try:
            os.unlink(os.path.join(directory, name))
        except OSError:
            pass


def read_manifest(directory: str) -> dict | None:
    """The directory's manifest with ``path`` made absolute, or None when it
    has none or it is unreadable."""
    try:
        with open(os.path.join(directory, MANIFEST_NAME)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(manifest, dict) or "version" not in manifest:
        return None
    path = manifest.get("path")
    if path and not os.path.isabs(path):
        manifest["path"] = os.path.join(os.path.abspath(directory), path)
    return manifest


# -- step checkpoints ---------------------------------------------------------


def _host_copy(tree: Any, copy: bool = True) -> Any:
    """A CPU copy of every tensor of ``tree``, taken now: the live tensors
    go on changing in place while a background write runs. With ``copy=False``
    a tensor already on the CPU is taken as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=copy)
    if isinstance(tree, dict):
        return {k: _host_copy(v, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v, copy) for v in tree)
    return tree


def _optimizer_params(optimizer: torch.optim.Optimizer) -> list[torch.Tensor]:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _saved_states(optimizer: torch.optim.Optimizer) -> dict:
    """Each parameter's optimizer state by the parameter's index in the
    optimizer. A ``ZeroRedundancyOptimizer`` (zero1) keeps each rank's
    shard: its whole state comes from the state dict that
    ``consolidate_state_dict(to=this rank)``, called on every rank, gathered."""
    if hasattr(optimizer, "consolidate_state_dict"):
        return dict(optimizer.state_dict()["state"])
    return {i: optimizer.state.get(p) for i, p in enumerate(_optimizer_params(optimizer))}


def _live_states(optimizer: torch.optim.Optimizer):
    """``(index, parameter, its live state)`` for each parameter whose
    optimizer state this process keeps: all of them, or a
    ``ZeroRedundancyOptimizer``'s shard (its local optimizer's)."""
    local = getattr(optimizer, "optim", None) if hasattr(
        optimizer, "consolidate_state_dict") else None
    owned = None if local is None else {id(p) for p in _optimizer_params(local)}
    for i, p in enumerate(_optimizer_params(optimizer)):
        if owned is None:
            yield i, p, optimizer.state[p]
        elif id(p) in owned:
            yield i, p, local.state[p]


def _state_tree(state) -> dict:
    """A :class:`~distkeras_tpu_torch.training.step.TrainState` as a tree:
    ``params``, ``model_state``, ``opt_state`` (each parameter's optimizer
    tensors, keyed by its index in the optimizer, so that a zero1 file and
    a plain one have the same layout) and ``step``/``seed``. The
    optimizer's hyperparameters come from its construction, not the file."""
    opt_state = {}
    for i, entry in _saved_states(state.optimizer).items():
        if not entry:
            continue
        for k, v in entry.items():
            if v is not None and not isinstance(v, torch.Tensor):
                raise TypeError(f"optimizer state {k!r} is a {type(v).__name__}, not a tensor")
        opt_state[str(i)] = {k: v for k, v in entry.items() if v is not None}
    return {"params": dict(state.params), "model_state": dict(state.model_state),
            "opt_state": opt_state, "step": np.asarray(state.step, np.int64),
            "seed": np.asarray(state.seed, np.int64)}


def _restore_state(state, tree: dict):
    """Write a saved :func:`_state_tree` into ``state``'s own tensors: the
    parameters and the optimizer's moments (of a zero1 optimizer, this
    rank's shard of them) are copied in place (an
    optimizer state not made yet is created on its parameter's device, a
    0-dim ``step`` on the CPU as torch keeps it), so the optimizer stays
    attached to the trainer's parameters. Returns ``state``."""
    # An empty subtree has no leaves, so it is not in the file.
    saved_model_state, opt_state = tree.get("model_state", {}), tree.get("opt_state", {})
    with torch.no_grad():
        for k, p in state.params.items():
            p.copy_(tree["params"][k])
        state.model_state = {k: saved_model_state[k].to(v.device, v.dtype)
                             for k, v in state.model_state.items()}
        for i, p, live in _live_states(state.optimizer):
            saved = opt_state.get(str(i))
            if saved is None:
                continue
            for k, v in saved.items():
                if isinstance(live.get(k), torch.Tensor):
                    live[k].copy_(v)
                else:
                    live[k] = v.clone() if v.ndim == 0 else v.to(p.device)
    state.step = int(tree["step"])
    state.seed = int(tree["seed"])
    return state


class CheckpointManager:
    """Step checkpoints in ``directory``: ``<step>/`` holds ``state.npz``,
    ``ps.npz`` (``center``, ``num_updates``) and ``meta.json``, any of them
    absent. A step is written under a temporary name and renamed, so a
    listed step is always whole. ``save(..., wait=False)`` copies the
    tensors to the host at once and writes on one background thread;
    :meth:`latest_step` counts such a step from the moment it is saved.
    The newest ``max_to_keep`` steps are kept."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._in_flight: set[int] = set()
        self._pending = []
        self._writer = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint-writer")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Any = None, ps_center: Any = None,
             ps_num_updates: int | None = None, meta: dict | None = None,
             wait: bool = True, copy: bool = True) -> bool:
        """Checkpoint ``step``: ``state`` (a ``TrainState`` or any tree),
        the PS center and update count, and JSON ``meta``. As orbax's
        manager does, a step at or below the latest is skipped: returns
        whether it was saved. ``copy=False`` writes CPU tensors that the
        caller owns and no longer changes without copying them first."""
        step = int(step)
        with self._lock:
            latest = max([*self._on_disk(), *self._in_flight], default=None)
            if latest is not None and step <= latest:
                return False
            self._in_flight.add(step)
        try:
            items: dict[str, Any] = {}
            if state is not None:
                tree = _state_tree(state) if hasattr(state, "optimizer") else state
                items["state"] = _host_copy(tree, copy)
            if ps_center is not None:
                items["ps"] = {"center": _host_copy(ps_center, copy),
                               "num_updates": np.asarray(ps_num_updates or 0, np.int64)}
            meta = dict(meta or {})
        except BaseException:
            with self._lock:
                self._in_flight.discard(step)
            raise
        future = self._writer.submit(self._write, step, items, meta)
        if wait:
            future.result()
        else:
            self._pending.append(future)
        return True

    def _write(self, step: int, items: dict, meta: dict) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{uuid.uuid4().hex}")
        try:
            os.makedirs(tmp)
            for name, tree in items.items():
                save_weights_file(os.path.join(tmp, f"{name}.npz"), tree, version=step)
            if meta:
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
            os.rename(tmp, self._step_dir(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            with self._lock:
                self._in_flight.discard(step)
        self._prune()

    def _prune(self) -> None:
        if self.max_to_keep <= 0:
            return
        for step in self._on_disk()[:-self.max_to_keep]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def _on_disk(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    def all_steps(self) -> list[int]:
        with self._lock:
            return sorted(set(self._on_disk()) | self._in_flight)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        """Wait for every background write; re-raise the first failure."""
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def restore(self, step: int | None = None, like: Any = None) -> dict:
        """``{"state", "ps", "meta"}`` of ``step`` (default: the latest),
        each present when saved. ``like`` mirrors the layout: a
        ``TrainState`` under ``"state"`` is restored into in place (see
        :func:`_restore_state`) and returned; another tree gives the
        structure the leaves fill; without, nested dicts of CPU tensors.
        ``ps["num_updates"]`` is an int."""
        self.wait_until_finished()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        like = like or {}
        out: dict[str, Any] = {}
        state_path = os.path.join(path, "state.npz")
        if os.path.exists(state_path):
            template = like.get("state")
            if hasattr(template, "optimizer"):
                out["state"] = _restore_state(template, load_weights_file(state_path))
            else:
                out["state"] = load_weights_file(state_path, like=template)
        ps_path = os.path.join(path, "ps.npz")
        if os.path.exists(ps_path):
            ps = load_weights_file(ps_path, like=like.get("ps"))
            ps["num_updates"] = int(ps["num_updates"])
            out["ps"] = ps
        meta_path = os.path.join(path, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                out["meta"] = json.load(f)
        return out

    def close(self) -> None:
        """Finish every background write and stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            self._writer.shutdown(wait=True)
