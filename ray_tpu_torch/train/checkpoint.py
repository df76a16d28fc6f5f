"""Checkpoint: a directory handle, plus tree-of-tensors (de)serialization
helpers (twin of ``ray_tpu/train/checkpoint.py``).

Role analog: ``ray.train.Checkpoint`` (``python/ray/train/_checkpoint.py:56``)
— a checkpoint IS a directory on a filesystem; frameworks decide what's
inside. The pytree helpers save and restore trees (dicts, lists, tuples) of
torch tensors: a train state ``{"step", "params", "opt_state"}`` with the
optimizer's ``state_dict()``. Tensors go to one ``.npz`` (a dtype numpy
lacks, bfloat16, as its raw bit pattern with a dtype tag), everything else
stays in the structure's pickle. The file names and the crash-atomic
protocol are the reference's, so ``trainer._is_torn_save_dir`` reads both.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_METADATA_FILE = ".metadata.json"
_TREE_FILE = "pytree.npz"
_STRUCT_FILE = "pytree_struct.pkl"



class Checkpoint:
    """A handle to a checkpoint directory."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        with open(os.path.join(d, "dict_checkpoint.pkl"), "wb") as f:
            pickle.dump(data, f)
        return cls(d)

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "dict_checkpoint.pkl"), "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        if path is None:
            path = tempfile.mkdtemp(prefix="ray_tpu_ckpt_")
        if os.path.abspath(path) != self.path:
            shutil.copytree(self.path, path, dirs_exist_ok=True)
        return path

    @contextlib.contextmanager
    def as_directory(self) -> Iterator[str]:
        yield self.path

    def get_metadata(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _METADATA_FILE)
        if os.path.exists(p):
            with open(p) as f:
                return json.load(f)
        return {}

    def set_metadata(self, meta: Dict[str, Any]) -> None:
        with open(os.path.join(self.path, _METADATA_FILE), "w") as f:
            json.dump(meta, f)

    def update_metadata(self, meta: Dict[str, Any]) -> None:
        m = self.get_metadata()
        m.update(meta)
        self.set_metadata(m)

    def __repr__(self):
        return f"Checkpoint(path={self.path!r})"


# ---------------------------------------------------------------------------
# Tree flattening: tensors are the leaves, everything else is structure
# ---------------------------------------------------------------------------

class _Leaf:
    """Where leaf ``index`` sits in the structure, with its dtype."""

    __slots__ = ("index", "dtype")

    def __init__(self, index: int, dtype: str):
        self.index = index
        self.dtype = dtype

    def __getstate__(self):
        return (self.index, self.dtype)

    def __setstate__(self, state):
        self.index, self.dtype = state


def _flatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Leaf(len(leaves) - 1, str(tree.dtype).replace("torch.", ""))
    if isinstance(tree, dict):
        return type(tree)((k, _flatten(v, leaves)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(v, leaves) for v in tree)
    return tree


def _unflatten(struct: Any, leaf: Callable[[_Leaf], torch.Tensor]) -> Any:
    if isinstance(struct, _Leaf):
        return leaf(struct)
    if isinstance(struct, dict):
        return type(struct)((k, _unflatten(v, leaf))
                            for k, v in struct.items())
    if isinstance(struct, (list, tuple)):
        return type(struct)(_unflatten(v, leaf) for v in struct)
    return struct


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's numpy array; bfloat16, which numpy lacks, as its
    16-bit pattern (the dtype tag in the structure restores it)."""
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _host_snapshot(tree: Any) -> Tuple[Any, List[torch.Tensor]]:
    """(structure, host copies of the leaves) that no later in-place update
    of the tree can reach: ``.cpu()`` of a card's tensor is a fresh host
    copy already; a host tensor is cloned, since ``.cpu()`` of it is the
    same storage (AdamW updates parameters and moments in place)."""
    leaves: List[torch.Tensor] = []
    struct = _flatten(tree, leaves)
    host = [t.detach().cpu() if t.device.type != "cpu"
            else t.detach().clone() for t in leaves]
    return struct, host


# ---------------------------------------------------------------------------
# Pytree save/restore
# ---------------------------------------------------------------------------

def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(struct: Any, host: List[torch.Tensor], path: str,
           name: str) -> None:
    """The crash-atomic write of :func:`save_pytree`."""
    os.makedirs(path, exist_ok=True)
    final_tree = os.path.join(path, f"{name}_{_TREE_FILE}")
    final_struct = os.path.join(path, f"{name}_{_STRUCT_FILE}")
    tmp_tree = os.path.join(path, f".tmp-{name}_{_TREE_FILE}")
    tmp_struct = os.path.join(path, f".tmp-{name}_{_STRUCT_FILE}")
    with open(tmp_tree, "wb") as f:
        np.savez(f, **{str(i): _to_numpy(t) for i, t in enumerate(host)})
        f.flush()
        os.fsync(f.fileno())
    with open(tmp_struct, "wb") as f:
        pickle.dump(struct, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_tree, final_tree)
    os.replace(tmp_struct, final_struct)
    meta_path = os.path.join(path, _METADATA_FILE)
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            meta = {}
    meta.setdefault("pytrees", {})[name] = {"leaves": len(host)}
    tmp_meta = os.path.join(path, f".tmp-{_METADATA_FILE.lstrip('.')}")
    with open(tmp_meta, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_meta, meta_path)
    _fsync_dir(path)


def save_pytree(tree: Any, path: str, *, name: str = "state") -> None:
    """Save a tree of tensors under ``path``. Tensors on a card are pulled
    to the host; structure goes to a pickle next to the flat arrays.

    Crash-atomic: payloads are written as ``.tmp-*`` siblings in the
    target dir (same filesystem, so ``os.replace`` is atomic), fsynced,
    renamed into place, and only then is the ``.metadata.json``
    completeness marker landed (merge-updating any user-set metadata) and
    the directory fsynced. A worker killed mid-save leaves either temp
    litter or the previous files — never a readable-but-torn save that
    ``trainer._latest_checkpoint`` could resume from.
    """
    leaves: List[torch.Tensor] = []
    struct = _flatten(tree, leaves)
    _write(struct, [t.detach().cpu() for t in leaves], path, name)


class AsyncSave:
    """Handle for an in-flight background checkpoint write."""

    def __init__(self, thread, errbox):
        self._thread = thread
        self._errbox = errbox

    def wait(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint write still in flight")
        if self._errbox:
            raise self._errbox[0]

    def done(self) -> bool:
        return not self._thread.is_alive()


def save_pytree_async(tree: Any, path: str, *,
                      name: str = "state") -> AsyncSave:
    """Non-blocking :func:`save_pytree` (orbax async-checkpoint role): the
    device->host pull happens NOW (a consistent snapshot — the train loop
    updates its tensors in place right after this returns), and the disk
    write runs on a background thread. The caller owns the handle: call
    ``.wait()`` before relying on the files (e.g.
    ``TrainLoopHelper.save_checkpoint_async`` returns it so a train loop
    waits before reporting the checkpoint)."""
    import threading

    struct, host = _host_snapshot(tree)
    errbox: list = []

    def write():
        try:
            _write(struct, host, path, name)
        except BaseException as e:  # surfaced at wait()
            errbox.append(e)

    t = threading.Thread(target=write, daemon=True,
                         name="ckpt-async-write")
    t.start()
    return AsyncSave(t, errbox)


def load_pytree(path: str, *, name: str = "state",
                device: Optional[Any] = None) -> Any:
    """Load a tree saved by :func:`save_pytree`. Its tensors are on the
    host, as the reference's arrays are without ``shardings``, or on
    ``device`` when one is given."""
    with open(os.path.join(path, f"{name}_{_STRUCT_FILE}"), "rb") as f:
        struct = pickle.load(f)
    with np.load(os.path.join(path, f"{name}_{_TREE_FILE}")) as z:
        def leaf(lf: _Leaf) -> torch.Tensor:
            t = _from_numpy(z[str(lf.index)], lf.dtype)
            return t if device is None else t.to(device)

        return _unflatten(struct, leaf)
