"""Serving step factories: prefill, and a decode step with the greedy
token on the device, on one device or on a mesh.

Port of the JAX package's ``runtime/serve_loop.py``. The model holds its
weights, so a step takes the batch (and the caches and the absolute
position ``index``, a Python int) and no parameters. The caches are
written in place, as the reference's donated buffers are.

On a mesh (a model cut by ``runtime.shard.shard_model``, the batch this
rank's slice of it) the caches are laid out by ``infer_cache_specs``:
batch over the batch axes, or at a batch they do not divide, the
sequence of the KV and latent caches and of the encoder's memory over
them (context parallelism: the recurrent states whole); GQA's KV heads,
or else their sequence (flash-decode) or Dh, MLA's latent rank, the
recurrent states' heads (or the mLSTM state's Dk) and the conv caches'
channels over the model axis; the sLSTM's c/n/h/m and the encoder's
memory whole over it. So each rank's cache is the slice of the
one-device cache and is written in place. The logits are vocab-parallel
(``logits_spec``) and the greedy token is the global argmax, the same
on every rank of the model axis. MLA's latent rank is cut apart from
its heads, and a Mamba2 state on N where the axis does not divide its
heads (``check_serve_layout`` tells what runs on a production mesh's
shape alone). Nothing is compiled:
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


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def check_serve_layout(cfg, batch: int, max_len: int, mesh,
                       profile: str = "2d") -> None:
    """Raise unless this slice serves ``cfg`` at a global ``batch`` and
    ``max_len`` on ``mesh``, which may be a production shape given as a
    dict of axis sizes (no process group): ``NotImplementedError`` for a
    family off ``SHARDED_FAMILIES``, ``ValueError`` for a prompt's or a
    decode step's batch layout off the rules'. Every cache layout the
    rules give runs."""
    if cfg.family not in shard_lib.SHARDED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh "
            f"({shard_lib.NOT_YET})")
    for seq in (max_len, 1):
        tok = torch.empty((batch, seq), device="meta")
        shard_lib.check_batch_specs(shd.infer_batch_specs(
            {"tokens": tok, "labels": tok}, mesh, profile), mesh, profile)


def check_cache_layout(model: LM, caches, profile: str = "2d") -> None:
    """Raise ``ValueError`` unless this rank's ``caches`` are the slices
    ``infer_cache_specs`` gives of the caches of the model's last
    ``init_caches`` (its ``cache_geometry``)."""
    layout = model.layout
    if getattr(model, "cache_geometry", None) is None:
        raise ValueError("caches on a mesh: make them with prefill or "
                         "init_caches on this model")
    glob = model.cache_shapes(*model.cache_geometry)
    specs = shd.infer_cache_specs(glob, layout.mesh, profile)
    for (path, local), (_, g), (_, spec) in zip(_flat(caches), _flat(glob),
                                                 _flat(specs)):
        want = shd.local_shape(tuple(g.shape), spec, layout.mesh)
        if tuple(local.shape) != want:
            raise ValueError(f"cache {'/'.join(path)}: {tuple(local.shape)} "
                             f"on this rank, its slice is {want}")


def _context(model: LM, mesh, profile: str, batch, batch_specs):
    """The mesh context of a step on ``batch`` (nothing off a mesh)."""
    cut = None if mesh is None else shard_lib.seq_cut(model, batch,
                                                      batch_specs)
    return mesh_context(mesh, profile, cut)


def make_prefill_step(model: LM, mesh=None, max_len: int = 0,
                      profile: str = "2d", batch_specs=None):
    """``prefill_step(batch) -> (logits, caches)``. On ``mesh`` the
    batch is this rank's slice of the global one, whose dim-specs are
    ``batch_specs``, a ``LocalBatch``'s own, or else those of a batch
    cut on its rows (``shard.batch_specs_of``)."""
    shard_lib.check_layout(model, mesh, profile)

    @torch.inference_mode()
    def prefill_step(batch):
        with _context(model, mesh, profile, batch, batch_specs):
            logits, caches = model.prefill(batch, max_len=max_len)
        if mesh is not None:
            check_cache_layout(model, caches, profile)
        return logits, caches
    return prefill_step


def make_decode_step(model: LM, mesh=None, profile: str = "2d",
                     batch_specs=None):
    """``decode_step(batch, caches, index) -> (next token, logits,
    caches)``; on ``mesh`` the batch as ``make_prefill_step`` takes it
    (a decode step's batch of one position is cut on its rows or whole
    on every rank) and the caches this model made."""
    shard_lib.check_layout(model, mesh, profile)

    @torch.inference_mode()
    def decode_step(batch, caches, index: int):
        with _context(model, mesh, profile, batch, batch_specs):
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
    that ``batch_specs`` are the rules' (``check_batch_specs``), then
    returns the decode step on batches of those specs. Nothing is
    compiled."""
    shard_lib.check_layout(model, mesh, profile)
    shard_lib.check_batch_specs(batch_specs, mesh, profile)
    check_cache_layout(model, caches, profile)
    return make_decode_step(model, mesh, profile, batch_specs)
