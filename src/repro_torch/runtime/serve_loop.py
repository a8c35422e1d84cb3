"""Serving step factories: prefill, and a decode step with the greedy
token on the device, on one device or on a mesh.

Port of the JAX package's ``runtime/serve_loop.py``. The model holds its
weights, so a step takes the batch (and the caches and the absolute
position ``index``, a Python int) and no parameters. The caches are
written in place, as the reference's donated buffers are.

On a mesh (a model cut by ``runtime.shard.shard_model``, the batch this
rank's rows) the caches are laid out by ``infer_cache_specs``: batch
over the batch axes; GQA's KV heads, MLA's latent rank, the recurrent
states' heads (or the mLSTM state's Dk) and the conv caches' channels
over the model axis; the sLSTM's c/n/h/m and the encoder's memory whole
over it. So each rank's cache is the slice of the one-device cache and
is written in place. The logits are vocab-parallel (``logits_spec``) and
the greedy token is the global argmax, the same on every rank of the
model axis. Layouts that shard the cache's sequence (batch 1, KV heads
that the model axis does not divide) or that MLA does not divide raise
``NotImplementedError`` (``check_serve_layout`` tells on a production
mesh's shape alone). Nothing is compiled:
``jit_decode_step`` checks the layouts the reference's jit would be
given and returns the step.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import LM, build_model, nest
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


#: the sequence dim of each cache leaf that has one; the others (the
#: recurrent ``state``, ``conv`` and c/n/h/m) hold no sequence
SEQ_DIM = {"k": -3, "v": -3, "ckv": -2, "k_rope": -2, "memory": -2}


def cache_specs(cfg, caches, mesh, profile: str = "2d"):
    """The dim-specs ``infer_cache_specs`` gives ``caches`` (the
    one-device caches, or tensors of their global shapes on ``meta``) on
    ``mesh`` (a ``DeviceMesh`` or a dict of axis sizes). Raises
    ``NotImplementedError`` for a layout this slice does not run: a
    sequence cut (a batch of 1, or KV heads fewer than the model axis:
    the reference's flash-decode fallback), a GQA cache cut on Dh, MLA
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

    def cuts(entry) -> bool:
        return entry is not None and shd.axes_size(sizes, entry) > 1
    for (path, leaf), (_, spec) in zip(_flat(caches), _flat(specs)):
        name = path[-1]
        seq = SEQ_DIM.get(name)
        if (seq is not None and cuts(spec[seq])) or (
                name in ("k", "v") and cuts(spec[-1])):
            raise NotImplementedError(
                f"cache {'/'.join(path)} of global shape "
                f"{tuple(leaf.shape)}: spec {spec} on {sizes} (a "
                f"sequence-sharded cache, {shard_lib.NOT_YET})")
        if cfg.family == "hybrid" and name == "state" and cuts(spec[-2]):
            raise NotImplementedError(
                f"cache {'/'.join(path)}: {cfg.num_heads} Mamba2 heads "
                f"over a model axis of {t}, the state cut on N "
                f"({shard_lib.NOT_YET})")
    return specs


def _whole_tail(cfg, name: str, shape) -> tuple:
    """A cache leaf's global dims after its batch dim, from this rank's
    ``shape`` of it (whose sequence, where it has one, is whole)."""
    if name in ("k", "v"):                      # (..., B, S, Hkv, Dh)
        return (shape[-3], cfg.kv_heads, cfg.resolved_head_dim)
    if name == "ckv":                           # (..., B, S, R)
        return (shape[-2], cfg.mla.kv_lora_rank)
    if name in ("k_rope", "memory"):            # (..., B, S, ·), whole
        return tuple(shape[-2:])
    s, H = cfg.ssm, cfg.num_heads
    d_in = s.expand * cfg.d_model
    mamba = cfg.family == "hybrid"
    if name == "state":                         # (..., B, H, Dk, Dv)
        return (H, s.state_dim, d_in // H) if mamba else \
            (H, d_in // H, d_in // H + 1)
    if name == "conv":                          # (..., B, K − 1, C)
        return (s.conv_dim - 1, d_in + 2 * s.state_dim if mamba else d_in)
    if name in ("c", "n", "h", "m"):            # (..., B, H, Dh)
        return (H, cfg.d_model // H)
    raise ValueError(f"cache leaf {name!r}")


def check_serve_layout(cfg, batch: int, max_len: int, mesh,
                       profile: str = "2d") -> None:
    """Raise ``NotImplementedError`` unless this slice serves ``cfg`` at
    a global ``batch`` and ``max_len`` on ``mesh``, which may be a
    production shape given as a dict of axis sizes (no process group):
    the family, the batch's and the caches' layouts (``cache_specs``)."""
    if cfg.family not in shard_lib.SHARDED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family on a mesh "
            f"({shard_lib.NOT_YET})")
    tok = torch.empty((batch, 1), device="meta")
    shard_lib.check_batch_specs(shd.infer_batch_specs({"tokens": tok}, mesh,
                                                      profile), mesh, profile)
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
    cache_specs(cfg, model.init_caches(batch, max_len), mesh, profile)


def check_cache_layout(model: LM, caches, profile: str = "2d") -> None:
    """Raise ``NotImplementedError`` unless this rank's ``caches`` are
    the slices ``infer_cache_specs`` gives of the one-device caches: the
    batch over the batch axes, the KV heads (GQA), the latent rank R
    (MLA's ``ckv``), the recurrent states' heads or Dk and the conv
    channels over the model axis when they are cut, nothing of the
    sequence (``cache_specs``)."""
    layout, cfg = model.layout, model.cfg
    mesh = layout.mesh
    dp_size = 1 if layout.dp is None else layout.dp.size

    def whole(name, shape):
        tail = _whole_tail(cfg, name, shape)
        b = len(shape) - 1 - len(tail)          # the batch dim
        return torch.empty(tuple(shape[:b]) + (shape[b] * dp_size,) + tail,
                           device="meta")
    glob = nest((p, whole(p[-1], v.shape)) for p, v in _flat(caches))
    specs = cache_specs(cfg, glob, mesh, profile)
    for (path, local), (_, g), (_, spec) in zip(_flat(caches), _flat(glob),
                                                 _flat(specs)):
        want = shd.local_shape(tuple(g.shape), spec, mesh)
        if tuple(local.shape) != want:
            raise NotImplementedError(
                f"cache {'/'.join(path)}: {tuple(local.shape)} on this "
                f"rank, its slice is {want} ({shard_lib.NOT_YET})")


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

