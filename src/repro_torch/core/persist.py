"""Warm-restart persistence: the snapshot codecs.

Port of the JAX package's ``core/persist.py``. A restarted
``MatcherService`` process pays the cold path on its first arrival: an
empty :class:`~repro_torch.core.service.CarryStore`, so every repeat
request swarms again. ``MatcherService.save_snapshot`` /
``restore_snapshot`` carry the store across the restart through
:class:`repro_torch.checkpoint.manager.CheckpointManager` (atomic commit,
versioned, digest-validated); these helpers round-trip the store keys
(tuples holding str/int/float/bool/None/bytes) through JSON and the
carries through flat ``{leaf name: array}`` dicts.

The reference's other half, its on-disk cache of ``jax.export``-ed
executables (``AOTCache``, ``aot_cache_enabled``) and its switch to
JAX's persistent compilation cache (``enable_jax_compilation_cache``),
has no counterpart: the port traces and compiles nothing per shape. Its
kernel libraries are built once per source hash (``kernels/_build.py``)
and the service's callable LRU binds Python callables, so a restarted
process has nothing to reload. The service's ``aot_*`` counters stay 0
for the reference's key set.

Environment: ``REPRO_PERSIST_DIR`` is the persistence root of services
built without an explicit ``persist_dir``, as in the reference.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

#: Bump when the snapshot layout changes incompatibly; restores of any
#: other version are skipped (``snapshot_stale_skipped``).
SNAPSHOT_VERSION = 1

ENV_PERSIST_DIR = "REPRO_PERSIST_DIR"


def default_persist_dir() -> Optional[str]:
    """Persistence root from the environment (None: persistence off)."""
    d = os.environ.get(ENV_PERSIST_DIR, "").strip()
    return d or None


def encode_key(key: Any) -> Any:
    """JSON-safe encoding of a warm-store key: bytes become
    ``{"__b": hex}``, tuples ``{"__t": [...]}``, so that
    :func:`decode_key` rebuilds the exact (hashable) original. Raises
    ``TypeError`` for anything else; the snapshot writer skips and
    counts such entries."""
    if key is None or isinstance(key, (str, int, float, bool)):
        return key
    if isinstance(key, bytes):
        return {"__b": key.hex()}
    if isinstance(key, tuple):
        return {"__t": [encode_key(k) for k in key]}
    raise TypeError(f"unsnapshotable key component: {type(key)!r}")


def decode_key(obj: Any) -> Any:
    """Inverse of :func:`encode_key`."""
    if isinstance(obj, dict):
        if "__b" in obj:
            return bytes.fromhex(obj["__b"])
        if "__t" in obj:
            return tuple(decode_key(k) for k in obj["__t"])
        raise ValueError(f"unknown key encoding: {sorted(obj)}")
    return obj


def named_leaves(prefix: str, carries: Sequence[tuple]) -> Dict[str, Any]:
    """``{prefix}.{i:05d}.{S,f,C}`` names for a list of ``(S*, f*, S̄)``
    carries, the parts as they are (tensors or arrays), in list order
    (restores replay it, which keeps LRU recency)."""
    out: Dict[str, Any] = {}
    for i, (s, f, c) in enumerate(carries):
        out[f"{prefix}.{i:05d}.S"] = s
        out[f"{prefix}.{i:05d}.f"] = f
        out[f"{prefix}.{i:05d}.C"] = c
    return out


def to_host(leaves: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Every leaf as a numpy array, in sorted name order (the reference's
    ``device_get`` of a dict), with ONE blocking transfer for all the
    CUDA tensors among them: each is copied into pinned host memory with
    a ``non_blocking`` copy, then one event is recorded and waited on.
    That wait lifts a ``torch.cuda`` sync-debug mode, as the service's
    ``_sync_fetch`` does; nothing else here synchronizes."""
    staged: Dict[str, Any] = {}
    cuda = False
    for k, x in leaves.items():
        if torch.is_tensor(x) and x.is_cuda:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x.detach(), non_blocking=True)
            staged[k] = h
            cuda = True
        else:
            staged[k] = x
    if cuda:
        ev = torch.cuda.Event()
        ev.record()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            ev.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return {k: (staged[k].detach().numpy().copy()
                if torch.is_tensor(staged[k]) else np.asarray(staged[k]))
            for k in sorted(staged)}


def carry_leaves(prefix: str, carries: Sequence[tuple]
                 ) -> Dict[str, np.ndarray]:
    """Flatten ``(S*, f*, S̄)`` carries to a flat ``{leaf name: array}``
    dict (the per-leaf ``.npy`` layout of ``CheckpointManager``), leaf
    names ``{prefix}.{i:05d}.{S,f,C}``, whose order is the list's. Carries on the card
    (the service keeps them in its device pool) come to the host with one
    blocking transfer for the whole list (:func:`to_host`), not one per
    leaf."""
    return to_host(named_leaves(prefix, carries))


def carries_from_leaves(prefix: str, leaves: Dict[str, np.ndarray],
                        count: int) -> List[tuple]:
    """Inverse of :func:`carry_leaves` for ``count`` entries."""
    return [(leaves[f"{prefix}.{i:05d}.S"],
             leaves[f"{prefix}.{i:05d}.f"],
             leaves[f"{prefix}.{i:05d}.C"])
            for i in range(count)]
