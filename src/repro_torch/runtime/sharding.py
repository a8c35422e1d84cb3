"""Sharding rules: parameter, batch and cache dim-specs for any mesh.

Port of the JAX package's ``runtime/sharding.py``, rule for rule.
Strategy (MaxText-style 2-D/3-D sharding):

  * **fsdp** = ("pod", "data") when the pod axis exists, else ("data",):
    parameters, gradients and optimizer state shard their *d_model-like*
    dimension here (ZeRO-3), activations shard batch here;
  * **tensor** = "model": head/ffn/expert/vocab dimensions shard here
    (Megatron-style), contracting through all-reduces;
  * any dimension not divisible by its axis size falls back to
    replication (e.g. kv_heads=8 on a 16-way tensor axis → shard
    head_dim instead).

Rules are keyed by parameter *leaf name* with symbols per trailing dim:
D → fsdp, V/F/H/E → tensor, h/None → replicated. Leading (stacked-layer)
dims are always None. Optimizer-state leaves (m/v/vr/vc) inherit the
parent parameter's rule.

The functions read only axis names and sizes: ``mesh`` is a
``DeviceMesh``, a mapping of axis name to size in the mesh's order
(``{"pod": 2, "data": 16, "model": 16}``), or anything with
``axis_names`` and a ``shape`` mapping, so that a production shape needs
no process group. A spec is a tuple with one entry per dim: ``None``, an
axis name or a tuple of names (a ``PartitionSpec``'s entries), the
dim-spec that ``checkpoint.manager._mesh_slice`` cuts by; a leaf with no
rule gets ``()`` (replicated), as the reference's ``P()``.

Rules resolve on the *reference's* leaf shapes (``models.model.RefLeaf``:
stacks with their leading layer axes, ``wq`` as (d, H, Dh)); the port
stores some parameters flattened, and ``runtime/shard.py`` maps a
resolved spec onto that layout. ``placements`` takes the reference's
``named``: ``(DeviceMesh, spec)`` pairs, which
``CheckpointManager.restore(shardings=)`` takes. The reference's
``get_shard_map`` (a JAX version shim) has no counterpart.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Tuple

Spec = Tuple


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of ``mesh``, in the mesh's axis order."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                    # a DeviceMesh
        return {n: int(s) for n, s in zip(names, mesh.mesh.shape)}
    shape = mesh.shape
    return {n: int(shape[n]) for n in mesh.axis_names}


def mesh_axes(mesh, profile: str = "2d"):
    """profile "2d": fsdp over (pod, data) + tensor over "model".
    profile "fsdp_only": every axis joins the FSDP/batch group and tensor
    parallelism is disabled — the right shape for ≤10B-dense training,
    where TP's per-layer activation all-reduces dominate."""
    names = tuple(mesh_shape(mesh))
    if profile == "fsdp_only":
        return names, None
    if profile != "2d":
        raise ValueError(f"profile {profile!r}: '2d' or 'fsdp_only'")
    fsdp = tuple(n for n in ("pod", "data") if n in names)
    tensor = "model" if "model" in names else None
    return fsdp, tensor


# symbol table: trailing-dim symbols per param leaf name
_RULES: Dict[str, Tuple] = {
    # embeddings / head
    "embed": ("V", "D"),
    "lm_head": ("D", "V"),
    "patch_proj": ("D", "F"),
    "frame_proj": ("D", "F"),
    # attention (GQA)
    "wq": ("D", "H", None),
    "wk": ("D", "H", None),
    "wv": ("D", "H", None),
    "wo": ("H", None, "D"),
    "bq": ("H", None),
    "bk": ("H", None),
    "bv": ("H", None),
    # attention (MLA)
    "wq_a": ("D", None),
    "wq_b": (None, "H", None),
    "wkv_a": ("D", None),
    "wk_rope": ("D", None),
    "wk_b": (None, "H", None),
    "wv_b": (None, "H", None),
    # mlp
    "gate": ("D", "F"),
    "up": ("D", "F"),
    "down": ("F", "D"),
    "router": ("D", None),
    # ssm / xlstm
    "in_proj": ("D", "F"),
    "out_proj": ("F", "D"),
    "up_proj": ("D", "F"),
    "down_proj": ("F", "D"),
    "conv_w": (None, "F"),
    "conv_b": ("F",),
    "wqkv": ("F", None, "H", None),
    "wif": ("F", None),
    "w_in": ("D", None, "H", None),
    "r": ("H", None, None, None),
    # scalars / vectors → replicated
    "scale": (None,),
    "A_log": (None,),
    "D": (None,),
    "dt_bias": (None,),
    "if_bias": (None,),
    "bias": (None, None, None),
}

# inside an "experts" subtree the leading expert dim shards on tensor and
# the ffn dim stays local (tensor axis already used by E)
_EXPERT_RULES = {
    "gate": ("E", "D", None),
    "up": ("E", "D", None),
    "down": ("E", None, "D"),
}

_SYMBOL_TO_AXIS = {"D": "fsdp", "V": "tensor", "F": "tensor", "H": "tensor",
                   "E": "tensor", None: None}


def axes_size(shape: Dict[str, int], axes) -> int:
    """The ranks a spec entry spans (1 for None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        return shape[axes]
    return math.prod(shape[a] for a in axes)


def batch_entry(fsdp):
    """The batch axes as a spec entry: one name, or a tuple of several."""
    return fsdp if len(fsdp) > 1 else (fsdp[0] if fsdp else None)


def _resolve(rule: Tuple, shape: Tuple[int, ...], mesh, fsdp,
             tensor) -> Spec:
    """Trailing-dim rule → dim-spec with divisibility fallbacks."""
    sizes = mesh_shape(mesh)
    ndim = len(shape)
    spec: list = [None] * ndim
    offset = ndim - len(rule)
    if offset < 0:           # rule longer than shape (e.g. squeezed bias)
        rule = rule[-ndim:]
        offset = 0
    used_tensor = False
    for i, sym in enumerate(rule):
        dim = offset + i
        kind = _SYMBOL_TO_AXIS.get(sym)
        if kind == "fsdp" and fsdp:
            if shape[dim] % axes_size(sizes, fsdp) == 0:
                spec[dim] = batch_entry(fsdp)
        elif kind == "tensor" and tensor and not used_tensor:
            if shape[dim] % axes_size(sizes, tensor) == 0:
                spec[dim] = tensor
                used_tensor = True
    return tuple(spec)


def spec_for_param(path_names: Tuple[str, ...], shape, mesh,
                   profile: str = "2d") -> Spec:
    fsdp, tensor = mesh_axes(mesh, profile)
    names = [n for n in path_names if n not in ("m", "v", "f")]
    # optimizer-state leaves inherit the parent param rule
    leaf = names[-1] if names else ""
    if leaf in ("vr", "vc", "v", "error") and len(names) >= 2:
        parent = names[-2]
        rule = (_EXPERT_RULES.get(parent) if "experts" in names
                else None) or _RULES.get(parent)
        if rule is None:
            return ()
        if leaf == "vr":      # param minus last dim
            rule = rule[:-1]
        elif leaf == "vc":    # param minus second-to-last dim
            rule = rule[:-2] + rule[-1:]
        return _resolve(rule, tuple(shape), mesh, fsdp, tensor)
    if "experts" in names and leaf in _EXPERT_RULES:
        return _resolve(_EXPERT_RULES[leaf], tuple(shape), mesh, fsdp,
                        tensor)
    rule = _RULES.get(leaf)
    if rule is None:
        return ()
    return _resolve(rule, tuple(shape), mesh, fsdp, tensor)


def _is_leaf(x) -> bool:
    return hasattr(x, "shape") and not isinstance(x, Mapping)


def _map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    """``tree`` (nested dicts, lists and tuples; a leaf is anything with a
    ``shape``) with each leaf replaced by ``fn(path names, leaf)``; a
    path name is a dict key or ``str`` of a sequence index."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    raise TypeError(f"{'/'.join(path)}: not a tree of arrays ({tree!r})")


def infer_param_specs(params, mesh, profile: str = "2d"):
    return _map_with_path(
        lambda p, v: spec_for_param(p, tuple(v.shape), mesh, profile),
        params)


# ---------------------------------------------------------------------------
# Batch / cache specs
# ---------------------------------------------------------------------------

def spec_for_batch_leaf(name: str, shape, mesh, profile: str = "2d") -> Spec:
    fsdp, tensor = mesh_axes(mesh, profile)
    dp = batch_entry(fsdp)
    dp_size = axes_size(mesh_shape(mesh), fsdp)
    shape = tuple(shape)
    if name == "positions3":         # (3, B, S)
        if shape[1] % dp_size == 0:
            return (None, dp, None)
        return ()
    spec: list = [None] * len(shape)
    if shape and shape[0] % dp_size == 0 and shape[0] > 1:
        spec[0] = dp
    elif len(shape) >= 2 and shape[1] % dp_size == 0 and shape[1] > 1:
        spec[1] = dp                 # batch=1 → shard sequence (CP)
    return tuple(spec)


def infer_batch_specs(batch, mesh, profile: str = "2d"):
    return _map_with_path(
        lambda p, v: spec_for_batch_leaf(p[-1], tuple(v.shape), mesh,
                                         profile), batch)


def spec_for_cache_leaf(name: str, shape, mesh, profile: str = "2d") -> Spec:
    """KV caches: (lead..., B, S, Hkv, Dh); states: (lead..., B, H, Dk, Dv);
    conv: (lead..., B, K, C); memory: (B, S, D); latents: (B, S, R)."""
    fsdp, tensor = mesh_axes(mesh, profile)
    sizes = mesh_shape(mesh)
    dp = batch_entry(fsdp)
    dp_size = axes_size(sizes, fsdp)
    t_size = axes_size(sizes, tensor) if tensor else 1
    shape = tuple(shape)
    ndim = len(shape)
    spec: list = [None] * ndim

    if name in ("k", "v"):            # (..., B, S, Hkv, Dh)
        b_dim, s_dim, h_dim, d_dim = ndim - 4, ndim - 3, ndim - 2, ndim - 1
        if shape[b_dim] % dp_size == 0 and shape[b_dim] > 1:
            spec[b_dim] = dp
        elif shape[s_dim] % dp_size == 0:
            spec[s_dim] = dp          # context-parallel long decode
        if tensor:
            if shape[h_dim] % t_size == 0:
                spec[h_dim] = tensor
            elif spec[s_dim] is None and shape[s_dim] % t_size == 0:
                # kv_heads < tensor axis: shard the sequence instead
                # (flash-decode; matches _sdpa's decode constraints)
                spec[s_dim] = tensor
            elif shape[d_dim] % t_size == 0:
                spec[d_dim] = tensor
    elif name in ("ckv", "k_rope", "memory"):   # (..., B, S, R)
        b_dim, s_dim, r_dim = ndim - 3, ndim - 2, ndim - 1
        if shape[b_dim] % dp_size == 0 and shape[b_dim] > 1:
            spec[b_dim] = dp
        elif shape[s_dim] % dp_size == 0:
            spec[s_dim] = dp
        if tensor and name == "ckv" and shape[r_dim] % t_size == 0:
            spec[r_dim] = tensor
    elif name == "state":             # (..., B, H, Dk, Dv)
        b_dim, h_dim, k_dim = ndim - 4, ndim - 3, ndim - 2
        if shape[b_dim] % dp_size == 0 and shape[b_dim] > 1:
            spec[b_dim] = dp
        if tensor:
            if shape[h_dim] % t_size == 0:
                spec[h_dim] = tensor
            elif shape[k_dim] % t_size == 0:
                spec[k_dim] = tensor
    elif name == "conv":              # (..., B, K, C)
        b_dim, c_dim = ndim - 3, ndim - 1
        if shape[b_dim] % dp_size == 0 and shape[b_dim] > 1:
            spec[b_dim] = dp
        if tensor and shape[c_dim] % t_size == 0:
            spec[c_dim] = tensor
    elif name in ("c", "n", "h", "m"):  # slstm scalars (..., B, H, Dh)
        b_dim = ndim - 3
        if 0 <= b_dim and shape[b_dim] % dp_size == 0 and shape[b_dim] > 1:
            spec[b_dim] = dp
    return tuple(spec)


def infer_cache_specs(caches, mesh, profile: str = "2d"):
    return _map_with_path(
        lambda p, v: spec_for_cache_leaf(p[-1], tuple(v.shape), mesh,
                                         profile), caches)


def logits_spec(mesh, profile: str = "2d") -> Spec:
    fsdp, tensor = mesh_axes(mesh, profile)
    return (batch_entry(fsdp), None, tensor)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def placements(specs, mesh) -> Any:
    """The reference's ``named``: each dim-spec of ``specs`` (a tree of
    them) as the ``(DeviceMesh, spec)`` pair that
    ``CheckpointManager.restore(shardings=)`` lays a leaf out by."""
    if _is_spec(specs):
        return (mesh, specs)
    if isinstance(specs, Mapping):
        return {k: placements(v, mesh) for k, v in specs.items()}
    if isinstance(specs, list):
        return [placements(v, mesh) for v in specs]
    raise TypeError(f"not a tree of dim-specs: {specs!r}")


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's slice of a ``shape`` array under ``spec``
    (every sharded dim divides, as the rules guarantee)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, axes in enumerate(spec):
        if axes is not None:
            n = axes_size(sizes, axes)
            if out[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {axes}")
            out[dim] //= n
    return tuple(out)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every axis name that ``spec`` shards a dim over."""
    out = []
    for axes in spec:
        if axes is None:
            continue
        out.extend((axes,) if isinstance(axes, str) else axes)
    return tuple(out)


def without(spec: Spec, dim: int) -> Spec:
    """``spec`` minus ``dim`` (a reduction over it)."""
    spec = list(spec)
    del spec[dim]
    return tuple(spec)

