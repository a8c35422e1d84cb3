"""Serving step factories: prefill, and a decode step with the greedy
token on the device, on one device or on a mesh.

Port of the JAX package's ``runtime/serve_loop.py``. The model holds its
weights, so a step takes the batch (and the caches and the absolute
position ``index``, a Python int) and no parameters. The caches are
written in place, as the reference's donated buffers are.

On a mesh (a model cut by ``runtime.shard.shard_model``, the batch this
rank's rows) the caches are laid out by ``infer_cache_specs``: batch
over the batch axes, KV heads over the model axis, so each rank's cache
is the slice of the one-device cache and is written in place. The
logits are vocab-parallel (``logits_spec``) and the greedy token is the
global argmax, the same on every rank of the model axis. Layouts that
shard the cache's sequence (batch 1, KV heads that the model axis does
not divide) raise ``NotImplementedError``. Nothing is compiled:
``jit_decode_step`` checks the layouts the reference's jit would be
given and returns the step.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM
from repro_torch.runtime import shard as shard_lib
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.mesh_ctx import all_gather, mesh_context


def greedy_token(model: LM, logits: torch.Tensor) -> torch.Tensor:
    """The argmax of the last position's logits (B, ..., V) as int32, the
    first maximum as ``jnp.argmax`` takes it; on a mesh over the whole
    vocabulary from this rank's columns (a tie goes to the lower id)."""
    last = logits[:, -1]
    tp = model.vocab_axes()
    if tp is None:
        return torch.argmax(last, dim=-1).to(torch.int32)
    val, idx = torch.max(last, dim=-1)
    idx = idx + tp.index * last.shape[-1]
    vals = all_gather(val[None].float(), 0, tp)           # (t, B)
    ids = all_gather(idx[None], 0, tp)
    best = torch.argmax(vals, dim=0)                      # first: lower id
    return ids.gather(0, best[None])[0].to(torch.int32)


def check_cache_layout(model: LM, caches, profile: str = "2d") -> None:
    """Raise ``NotImplementedError`` unless this rank's ``caches`` are
    the slices ``infer_cache_specs`` gives of the one-device caches: the
    batch over the batch axes, the KV heads over the model axis when
    they are cut, nothing of the sequence."""
    layout = model.layout
    mesh = layout.mesh
    sizes = shd.mesh_shape(mesh)
    dp_size = 1 if layout.dp is None else layout.dp.size
    heads_tp = model.blocks[0].attn.wk.shard.tensor

    def cuts(entry) -> bool:
        return entry is not None and shd.axes_size(sizes, entry) > 1

    def visit(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, k)
            return
        glob = list(node.shape)                 # (..., B, S, Hkv, Dh)
        glob[-4] *= dp_size
        if heads_tp is not None:
            glob[-2] *= heads_tp.size
        spec = shd.spec_for_cache_leaf(name, glob, mesh, profile)
        if cuts(spec[-3]) or cuts(spec[-1]) or tuple(node.shape) != \
                shd.local_shape(glob, spec, mesh):
            raise NotImplementedError(
                f"cache {name} of global shape {tuple(glob)}: spec {spec} "
                f"on {sizes} (a sequence-sharded cache, "
                f"{shard_lib.NOT_YET})")
    visit(caches, "")


def make_prefill_step(model: LM, mesh=None, max_len: int = 0,
                      profile: str = "2d"):
    shard_lib.check_layout(model, mesh, profile)

    @torch.inference_mode()
    def prefill_step(batch):
        with mesh_context(mesh, profile):
            logits, caches = model.prefill(batch, max_len=max_len)
        if mesh is not None:
            check_cache_layout(model, caches, profile)
        return logits, caches
    return prefill_step


def make_decode_step(model: LM, mesh=None, profile: str = "2d"):
    shard_lib.check_layout(model, mesh, profile)

    @torch.inference_mode()
    def decode_step(batch, caches, index: int):
        with mesh_context(mesh, profile):
            logits, caches = model.decode(batch, caches, index)
        # greedy token for the serving loop (sampling lives client-side);
        # argmax takes the first maximum, as jnp.argmax does
        next_tok = greedy_token(model, logits)
        return next_tok, logits, caches
    return decode_step


def jit_decode_step(model: LM, mesh, caches, batch_specs,
                    profile: str = "2d"):
    """The reference's jit with explicit shardings, eager (the model
    holds its parameters, laid out by ``infer_param_specs``): checks that
    ``caches`` (this rank's) are laid out by ``infer_cache_specs`` and
    that ``batch_specs`` cut the batch over the batch axes, then returns
    the decode step. Nothing is compiled."""
    shard_lib.check_layout(model, mesh, profile)
    shard_lib.check_batch_specs(batch_specs, mesh, profile)
    check_cache_layout(model, caches, profile)
    return make_decode_step(model, mesh, profile)

