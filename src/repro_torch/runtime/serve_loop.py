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
on every rank of the model axis. MLA that the model axis does not
divide and a Mamba2 state cut on N raise ``NotImplementedError``
(``check_serve_layout`` tells on a production mesh's shape alone).
Nothing is compiled:
``jit_decode_step`` checks the layouts the reference's jit would be
given and returns the step.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM, build_model
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


def cache_specs(cfg, caches, mesh, profile: str = "2d"):
    """The dim-specs ``infer_cache_specs`` gives ``caches`` (the
    one-device caches, or tensors of their global shapes on ``meta``) on
    ``mesh`` (a ``DeviceMesh`` or a dict of axis sizes). Raises
    ``NotImplementedError`` for a layout this slice does not run: MLA
    whose heads or latent rank the model axis does not divide, and a
    Mamba2 state cut on N (heads the model axis does not divide)."""
    sizes = shd.mesh_shape(mesh)
    _, tensor = shd.mesh_axes(mesh, profile)
    t = shd.axes_size(sizes, tensor) if tensor else 1
    if cfg.mla is not None and t > 1 and (
            cfg.num_heads % t or cfg.mla.kv_lora_rank % t):
        raise NotImplementedError(
            f"{cfg.name}: MLA's {cfg.num_heads} heads and latent rank "
            f"{cfg.mla.kv_lora_rank} over a model axis of {t} "
            f"({shard_lib.NOT_YET})")
    specs = shd.infer_cache_specs(caches, mesh, profile)
    for (path, _), (_, spec) in zip(_flat(caches), _flat(specs)):
        if cfg.family == "hybrid" and path[-1] == "state" and \
                spec[-2] is not None and shd.axes_size(sizes, spec[-2]) > 1:
            raise NotImplementedError(
                f"cache {'/'.join(path)}: {cfg.num_heads} Mamba2 heads "
                f"over a model axis of {t}, the state cut on N "
                f"({shard_lib.NOT_YET})")
    return specs


def check_serve_layout(cfg, batch: int, max_len: int, mesh,
                       profile: str = "2d") -> None:
    """Raise ``NotImplementedError`` unless this slice serves ``cfg`` at
    a global ``batch`` and ``max_len`` on ``mesh``, which may be a
    production shape given as a dict of axis sizes (no process group):
    the family, the prompt's and a decode step's batch layouts and the
    caches' (``cache_specs``)."""
    if cfg.family not in shard_lib.SHARDED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh "
            f"({shard_lib.NOT_YET})")
    for seq in (max_len, 1):
        tok = torch.empty((batch, seq), device="meta")
        shard_lib.check_batch_specs(shd.infer_batch_specs(
            {"tokens": tok, "labels": tok}, mesh, profile), mesh, profile)
    # a stack's depth is a leading axis no rule cuts: 2 layers tell (a
    # group of the recurrent families: xlstm's period, zamba2's period
    # and a tail)
    layers = 2
    if cfg.family == "ssm":
        layers = cfg.ssm.slstm_period
    elif cfg.family == "hybrid":
        layers = cfg.ssm.shared_attn_period + 1
    model = build_model(cfg.replace(num_layers=layers), device="meta",
                        generator=torch.Generator())
    cache_specs(cfg, model.cache_shapes(batch, max_len), mesh, profile)


def check_cache_layout(model: LM, caches, profile: str = "2d") -> None:
    """Raise ``NotImplementedError`` for a layout this slice does not run
    (``cache_specs``), and ``ValueError`` unless this rank's ``caches``
    are the slices ``infer_cache_specs`` gives of the caches of the
    model's last ``init_caches`` (its ``cache_geometry``)."""
    layout, cfg = model.layout, model.cfg
    if getattr(model, "cache_geometry", None) is None:
        raise ValueError("caches on a mesh: make them with prefill or "
                         "init_caches on this model")
    glob = model.cache_shapes(*model.cache_geometry)
    specs = cache_specs(cfg, glob, layout.mesh, profile)
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
