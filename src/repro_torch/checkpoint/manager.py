"""Atomic, optionally asynchronous checkpoint store.

Port of the JAX package's ``checkpoint/manager.py`` for nested dicts (and
lists or tuples) of tensors or arrays. The layout on disk is the
reference's, so each package reads the other's checkpoints::

    <dir>/step_000000123.tmp/         # written here first
        META.json                     # leaf paths, files, shapes, dtypes, step
        <leaf-path>.npy               # one file per leaf
        extras.json                   # user metadata
    <dir>/step_000000123/             # atomic rename on commit

  * **atomic commit** — a crash mid-write leaves only ``*.tmp``
    directories, which every restore path ignores; the newest committed
    step wins;
  * **async** — ``save()`` copies the state to host memory, then hands
    the file I/O to a writer thread (``wait()`` joins it);
  * ``keep`` bounds the committed steps on disk (oldest removed first).

A leaf's path is its dict keys (in sorted order, as the reference's tree
flattening visits them) and sequence indices.

  * **elastic restore** — arrays are saved with their global shape;
    ``restore(state_like, shardings=...)`` lays each out for the
    restoring job: whole on a device, or this rank's slice of a
    ``DeviceMesh`` (``launch/mesh.py``), whatever the number of ranks
    that wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh


def _path_names(tree: Any, prefix: Tuple[str, ...] = ()
                ) -> List[Tuple[Tuple[str, ...], Any]]:
    """``[(path, leaf), ...]`` of a nested dict / list / tuple, in the
    reference's flattening order (dict keys sorted) and with its path
    names (``str`` of each dict key and sequence index). ``None`` is an
    empty subtree, as in the reference."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _path_names(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in _path_names(v, prefix + (str(i),))]
    return [(prefix, tree)]


def _is_placement(x) -> bool:
    return isinstance(x, torch.device) or (
        isinstance(x, tuple) and len(x) == 2
        and isinstance(x[0], DeviceMesh))


def _placements(tree: Any) -> List[Any]:
    """The leaves of a ``shardings`` tree in ``_path_names`` order: a
    ``torch.device`` or a ``(DeviceMesh, dim-spec)`` pair is a leaf."""
    if _is_placement(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _placements(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _placements(v)]
    return [tree]


def _mesh_slice(arr: np.ndarray, mesh: DeviceMesh, spec) -> np.ndarray:
    """This rank's slice of ``arr`` under a dim-spec (one entry per
    leading dim: None, an axis name or a tuple of axis names, as a
    ``PartitionSpec``): each sharded dim is cut into as many pieces as
    its axes hold ranks (``np.array_split``, even when divisible, as a
    ``NamedSharding`` cuts it) and this rank keeps the piece of its
    coordinates, data-major."""
    dims = tuple(mesh.mesh_dim_names)
    for dim, axes in enumerate(tuple(spec)):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        index, count = 0, 1
        for a in axes:
            size = mesh.size(dims.index(a))
            index = index * size + mesh.get_local_rank(a)
            count *= size
        arr = np.array_split(arr, count, axis=dim)[index]
    return np.require(arr, requirements="C")


def _as_template(arr: np.ndarray, like, device=None):
    """``arr`` in the form of the template leaf ``like``: a tensor of its
    dtype (on ``device``, else on ``like``'s device), or an array of its
    dtype; a tensor on ``device`` when a placement was given."""
    if torch.is_tensor(like):
        t = torch.from_numpy(np.require(arr, requirements="C")).to(like.dtype)
        return t.to(like.device if device is None else device)
    if hasattr(like, "dtype"):
        arr = arr.astype(like.dtype)
    if device is not None:
        return torch.from_numpy(np.require(arr, requirements="C")).to(device)
    return arr


def _unflatten(tree: Any, leaves) -> Any:
    """``tree`` with its leaves replaced, in ``_path_names`` order, by
    the next values of the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _leaf_file(path_names) -> str:
    return "__".join(path_names) + ".npy"


def _to_numpy(x) -> np.ndarray:
    """A leaf on the host. A bfloat16 tensor (numpy has no bfloat16) is
    saved as float32, which holds it exactly; a restore casts it back to
    its template's dtype, as the reference's restore casts."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.detach().cpu().numpy()
    return np.asarray(x)


class CheckpointManager:
    """Atomic, optionally asynchronous checkpoint store rooted at
    ``directory``: training-style state (nested dicts of tensors or
    arrays) through ``save``, and the matcher service's warm-restart
    snapshots (flat ``{name: array}`` dicts) through ``save`` /
    ``restore_flat``, which needs no template since ``META.json``
    describes a flat dict fully. ``keep`` bounds the committed steps
    retained on disk."""

    def __init__(self, directory: str, async_save: bool = True,
                 keep: int = 3):
        self.dir = directory
        self.async_save = async_save
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, state: Any,
             extras: Optional[Dict] = None) -> None:
        """Commit ``state`` as step ``step``. Leaves are copied to host
        memory now; file I/O runs on a writer thread when ``async_save``
        (``wait()`` joins it). ``extras`` must be JSON-serializable."""
        self.wait()                      # one in-flight save at a time
        host = [(p, _to_numpy(v)) for p, v in _path_names(state)]
        meta = {
            "step": int(step),
            "leaves": [{"file": _leaf_file(p), "path": list(p),
                        "shape": list(v.shape), "dtype": str(v.dtype)}
                       for p, v in host],
        }

        def write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            for p, v in host:
                np.save(os.path.join(tmp, _leaf_file(p)), v)
            with open(os.path.join(tmp, "META.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "extras.json"), "w") as f:
                json.dump(extras or {}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)        # atomic commit
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join the in-flight asynchronous save, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def all_steps(self) -> List[int]:
        """Sorted steps of every committed checkpoint (``*.tmp`` partial
        writes are invisible here)."""
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """Newest committed step, or None when the store is empty."""
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_flat(self, step: Optional[int] = None):
        """Restore a checkpoint saved from a flat ``{name: array}`` dict
        (the newest, or ``step``). Returns ``(arrays, extras)`` with
        ``arrays`` a ``{name: np.ndarray}`` dict, or ``(None, None)`` when
        no committed step exists. Raises ``ValueError`` on a nested
        checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "META.json")) as f:
            meta = json.load(f)
        arrays: Dict[str, np.ndarray] = {}
        for leaf in meta["leaves"]:
            path = leaf["path"]
            if len(path) != 1:
                raise ValueError(
                    f"restore_flat on a nested checkpoint (leaf {path})")
            arrays[path[0]] = np.load(os.path.join(d, leaf["file"]))
        with open(os.path.join(d, "extras.json")) as f:
            extras = json.load(f)
        return arrays, extras

    def restore(self, state_like: Any, step: Optional[int] = None,
                shardings: Any = None):
        """Restore the newest (or ``step``-th) checkpoint into the
        structure of ``state_like``. Returns ``(state, extras)``; each
        leaf takes its template leaf's form (a tensor of its dtype and
        device, or an array of its dtype).

        ``shardings`` (a tree matching ``state_like``) re-lays-out each
        array for the current job, elastic across rank counts: a
        ``torch.device`` leaf places the whole array there; a
        ``(DeviceMesh, dim-spec)`` leaf keeps this rank's slice
        (``_mesh_slice``) on the mesh's device type. Raises
        ``FileNotFoundError`` when no committed step exists."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        leaves = _path_names(state_like)
        places = (None if shardings is None else _placements(shardings))
        if places is not None and len(places) != len(leaves):
            raise ValueError(f"{len(places)} shardings for {len(leaves)} "
                             f"leaves")
        out = []
        for i, (p, like) in enumerate(leaves):
            arr = np.load(os.path.join(d, _leaf_file(p)))
            place = None if places is None else places[i]
            device = None
            if isinstance(place, tuple):
                mesh, spec = place
                arr = _mesh_slice(arr, mesh, spec)
                device = (torch.device("cuda", torch.cuda.current_device())
                          if mesh.device_type == "cuda" else
                          torch.device(mesh.device_type))
            elif place is not None:
                device = torch.device(place)
            out.append(_as_template(arr, like, device))
        with open(os.path.join(d, "extras.json")) as f:
            extras = json.load(f)
        return _unflatten(state_like, iter(out)), extras
