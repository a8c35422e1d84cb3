"""Int8 error-feedback gradient compression for data-parallel reduction.

Port of the JAX package's ``optim/grad_compress.py`` on
``torch.distributed``: a process group takes the place of the mesh axis
name, and every rank of the group calls alike (one SPMD program).

Scheme (1-bit-SGD lineage, adapted to int8 + all-reduce):
  * carry a per-parameter error buffer e;
  * quantize (g + e) to int8 with a per-tensor scale chosen so that the
    *sum over D replicas* cannot overflow int8 (scale = max|x|·D/127 — the
    all-reduce's wire dtype stays int8, giving 4× fewer bytes on the DP
    axis than float32 and 2× fewer than bfloat16);
  * new error e' = (g + e) − dequant(quant(g + e)).

Error feedback makes the quantization noise telescoping: what is lost this
step is re-injected next step, which is why aggressive D-scaled int8
still converges. As in the reference, no train step calls it; it is the
reduction an explicit data-parallel step would make.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class CompressionState(NamedTuple):
    error: torch.Tensor


def _is_state(x) -> bool:
    return isinstance(x, CompressionState)


def _flatten(tree, is_leaf):
    """Leaves of a nested dict (keys sorted) / list / tuple, in the
    reference's flattening order."""
    if is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in _flatten(tree[k], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in _flatten(v, is_leaf)]
    return [tree]


def _unflatten(tree, leaves, is_leaf):
    if is_leaf(tree) or not isinstance(tree, (dict, list, tuple)):
        return next(leaves)
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves, is_leaf)
                for k in sorted(tree)}
    return type(tree)(_unflatten(v, leaves, is_leaf) for v in tree)


def _tensor(x) -> bool:
    return torch.is_tensor(x)


def init_compression(params):
    """A zero float32 error buffer a leaf of ``params`` (a tensor or a
    nested dict / list of tensors)."""
    return _unflatten(params, iter(
        CompressionState(torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device))
        for p in _flatten(params, _tensor)), _tensor)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group,
                    num_devices: int):
    """One tensor: error-feedback int8 all-reduce over ``group`` (None:
    the default group) of ``num_devices`` ranks. Returns (the mean of g
    over the ranks, new error).

    All replicas must quantize with the SAME scale (otherwise dequantizing
    the int8 sum with an averaged scale injects O(q·Δscale) error), so the
    scale is agreed by a scalar MAX all-reduce first — negligible wire
    cost."""
    f32 = dict(dtype=torch.float32, device=g.device)
    x = g.to(torch.float32) + err
    amax = torch.max(torch.abs(x))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)   # shared
    scale = torch.clamp(amax * num_devices / torch.full((), 127.0, **f32),
                        min=1e-30)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_err = x - q.to(torch.float32) * scale
    # int8 on the wire; values are D-scaled so the sum fits int8
    summed = q.clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    mean = summed.to(torch.float32) * scale / torch.full(
        (), float(num_devices), **f32)
    return mean.to(g.dtype), new_err


def compressed_psum_tree(grads, comp_state, group, num_devices: int):
    """``compressed_psum`` leaf by leaf; returns (grads, new comp state)
    in the trees' structure."""
    flat_g = _flatten(grads, _tensor)
    flat_e = [s.error for s in _flatten(comp_state, _is_state)]
    out_g, out_e = [], []
    for g, e in zip(flat_g, flat_e):
        gg, ee = compressed_psum(g, e, group, num_devices)
        out_g.append(gg)
        out_e.append(CompressionState(ee))
    return (_unflatten(grads, iter(out_g), _tensor),
            _unflatten(comp_state, iter(out_e), _is_state))
