"""Model assembly: one class a family, behind the reference's API.

Port of the JAX package's ``models/model.py``::

    build_model(cfg, device=None, generator=None) -> LM with
        .train_logits(batch)                  -> (B, S, V) logits
        .prefill(batch, max_len)              -> (logits, caches)
        .decode(batch, caches, index)         -> (logits, caches)
        .init_caches(batch_size, max_len)     -> caches
        .num_params()                         -> int

Families: ``dense`` (llama3, qwen1.5, qwen2.5), ``moe`` (deepseek-v2
with MLA and a dense first block, arctic with a dense residual FFN),
``vlm`` (qwen2-vl's text backbone with stub patch embeddings and
M-RoPE), ``ssm`` (xlstm: groups of mLSTM blocks and one sLSTM block),
``hybrid`` (zamba2: groups of Mamba2 blocks, each followed by one shared
attention block, then a tail) and ``encdec``/``audio`` (seamless: an
encoder over stub frame embeddings, a decoder with cross-attention).

The layers are ``nn.Module``s in ``nn.ModuleList``s holding parameters
at ``param_dtype`` and casting them at use, as the reference does.
Caches keep the reference's layout (a leading layer axis a stack, e.g.
``{"blocks": {"k", "v"}}`` of (L, B, max_len, Hkv, Dh) in bfloat16) and
are written in place at ``index`` (a Python int, so a decode step needs
no host sync).

``params_from_numpy`` and ``params_to_numpy`` carry the reference's
parameter pytree (numpy arrays, stacks on leading layer axes, each leaf
in the reference's shape) into and out of the port's modules;
``ref_leaves`` names each leaf of that tree with the parameters that
make it up, which the optimizers update as the reference's leaves.

``cfg.remat`` checkpoints the layers of each stack that the reference
scans under ``_maybe_remat`` (``blocks``, the mLSTM blocks, the Mamba2
blocks, the encoder and the decoder; never deepseek's ``block0``, the
sLSTM blocks or the hybrid's shared attention) when autograd records:
``"full"`` saves nothing inside a layer, ``"block"`` saves the outputs
of the 2-D products (``aten.mm``: the projections, whose operands have
no batch dimension, as the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest.
``prefill`` and ``decode`` run under ``inference_mode`` and never
checkpoint.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, ssm
from repro_torch.models.common import RMSNorm, dense_init, embed_init
from repro_torch.models.ffn import MLP
from repro_torch.models.moe import MoE
from repro_torch.runtime.mesh_ctx import (all_reduce, axes_of, enter_tensor,
                                          gather_tensor, reduce_tensor,
                                          shard_of, tensor_axes, weight)

CACHE_DTYPE = torch.bfloat16
#: patch positions a ``vlm`` prompt starts with (the stub vision frontend)
VLM_PATCHES = 8


def _layer(caches: Dict[str, torch.Tensor], *idx) -> Dict[str, torch.Tensor]:
    """One layer's cache: views into the stacked buffers, so that a
    block's in-place writes land in them."""
    return {name: c[idx] for name, c in caches.items()}


def _stacked(proto: Dict[str, torch.Tensor], *lead: int):
    """Zeros of ``proto``'s entries with leading layer axes ``lead``."""
    return {name: torch.zeros(tuple(lead) + tuple(c.shape), dtype=c.dtype,
                              device=c.device)
            for name, c in proto.items()}


def _save_products(ctx, func, *args, **kwargs):
    """``remat="block"``'s policy: keep the 2-D products' outputs."""
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE
            if func is torch.ops.aten.mm.default
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, layer: nn.Module, *args):
    """``layer(*args)``, checkpointed as ``cfg.remat`` says when autograd
    records (see the module's docstring)."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer(*args)
    if cfg.remat not in ("block", "full"):
        raise ValueError(f"remat {cfg.remat!r}: none, block or full")
    kw = {}
    if cfg.remat == "block":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_products)
    return torch_checkpoint.checkpoint(layer, *args, use_reentrant=False,
                                       **kw)


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(ln1 x), then x + ffn(ln2 x).
    The attention is MLA or GQA, the FFN an MoE or a SwiGLU MLP, as the
    config says."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.ln1 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.ln2 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.attn = attention.MLA(cfg, **kw) if cfg.mla is not None \
            else attention.GQA(cfg, **kw)
        self.ffn = MoE(cfg, **kw) if cfg.moe is not None else MLP(
            cfg.d_model, cfg.d_ff, dtype, common.dt(cfg.compute_dtype), **kw)

    def forward(self, x, positions, cache=None, cache_index: int = 0):
        a, cache = self.attn(self.ln1(x), positions, cache, cache_index)
        x = x + a
        return x + self.ffn(self.ln2(x)), cache


class PreNorm(nn.Module):
    """x + core(ln x): a layer of the xlstm and hybrid stacks."""

    def __init__(self, cfg: ModelConfig, core: nn.Module, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, common.dt(cfg.param_dtype),
                          cfg.norm_eps, device)
        self.core = core

    def forward(self, x, cache=None):
        out, cache = self.core(self.ln(x), cache)
        return x + out, cache


class LM(nn.Module):
    """What every family shares: the embedding, the final norm, the head
    (tied to the embedding or not) and the reference's API. A family
    defines ``_run`` (the layers over a batch, caches written in place)
    and ``init_caches``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.embed = nn.Parameter(embed_init(cfg.vocab_size, cfg.d_model,
                                             dtype, **kw))
        self.final_ln = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init((cfg.d_model, cfg.vocab_size), dtype, **kw))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        cd = common.dt(self.cfg.compute_dtype)
        if shard_of(self.embed) is None:
            # gather, then cast: the values of the reference's
            # cast-then-gather without a copy of the whole table a step
            return self.embed[tokens.long()].to(cd)
        # on a mesh: the table cast and gathered over FSDP; vocab-parallel
        # over the model axis (a token outside this rank's rows gives
        # zeros, then the ranks' rows are summed)
        w = weight(self.embed, cd)
        tp = tensor_axes(self.embed)
        idx = tokens.long()
        if tp is None:
            return w[idx]
        # a negative id counts from the end, as the one-device index does
        idx = torch.where(idx < 0, idx + self.cfg.vocab_size, idx)
        idx = idx - tp.index * w.shape[0]
        inside = (idx >= 0) & (idx < w.shape[0])
        rows = w[idx.clamp(0, w.shape[0] - 1)]
        return reduce_tensor(torch.where(inside[..., None], rows,
                                         torch.zeros((), dtype=cd,
                                                     device=rows.device)),
                             tp)

    def vocab_axes(self):
        """The model axis that cuts the logits' vocabulary (the head's V,
        the only dim the rules put on it), None when they are whole."""
        return tensor_axes(self.embed if self.lm_head is None
                           else self.lm_head)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Logits of ``x``; on a mesh vocab-parallel: this rank's V/t
        columns (``runtime.sharding.logits_spec``)."""
        cd = common.dt(self.cfg.compute_dtype)
        x = self.final_ln(x)
        p = self.embed if self.lm_head is None else self.lm_head
        x = enter_tensor(x, self.vocab_axes())
        w = weight(p, cd)
        return x.to(cd) @ (w.t() if self.lm_head is None else w)

    def train_logits(self, batch) -> torch.Tensor:
        """The forward alone over the whole sequence → (B, S, V)."""
        return self._head(self._run(batch, None, 0))

    @torch.inference_mode()
    def prefill(self, batch, max_len: int):
        """Fill fresh caches of ``max_len`` with the prompt → (logits of
        the last position (B, 1, V), caches)."""
        caches = self.init_caches(batch["tokens"].shape[0], max_len)
        x = self._run(batch, caches, 0)
        return self._head(x[:, -1:]), caches

    @torch.inference_mode()
    def decode(self, batch, caches, index: int):
        """One step at absolute position ``index``: the caches are
        written in place → (logits (B, S, V), caches)."""
        x = self._run(batch, caches, int(index))
        return self._head(x), caches

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())


# ---------------------------------------------------------------------------
# Dense / MoE / VLM decoder-only family
# ---------------------------------------------------------------------------

class DecoderOnly(LM):
    """``dense``, ``moe`` and ``vlm``. deepseek's first block is dense
    (an MLP of ``d_ff`` or 4·d_model, MLA kept) and caches apart, as
    ``caches["block0"]`` with a leading axis of 1."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__(cfg, generator=generator, device=device)
        kw = dict(generator=generator, device=device)
        first_dense = cfg.moe is not None and cfg.name.startswith("deepseek")
        self.block0 = Block(cfg.replace(moe=None, d_ff=cfg.d_ff or
                                        4 * cfg.d_model), **kw) \
            if first_dense else None
        self.blocks = nn.ModuleList(
            Block(cfg, **kw) for _ in range(cfg.num_layers - first_dense))
        self.patch_proj = nn.Parameter(dense_init(
            (cfg.d_model, cfg.d_model), common.dt(cfg.param_dtype), **kw)) \
            if cfg.frontend == "vision" else None

    def _assemble_x(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        if self.patch_proj is not None and "patches" in batch:
            cd = common.dt(self.cfg.compute_dtype)
            pe = batch["patches"].to(cd) @ weight(self.patch_proj, cd)
            # on a mesh the projection's output width is cut over the
            # model axis; the sequence needs it whole
            pe = gather_tensor(pe, -1, tensor_axes(self.patch_proj))
            x = torch.cat([pe, x], dim=1)
        return x

    def _positions(self, batch, B: int, S: int, cache_index: int):
        if self.cfg.mrope:
            pos = batch.get("positions3")
            if pos is None:   # the reference's default: 0..S-1, no offset
                pos = common.positions_for(B, S, device=self.device)[None]
                pos = pos.expand(3, B, S)
            return pos
        return common.positions_for(B, S, cache_index, device=self.device)

    def _run(self, batch, caches, cache_index: int):
        x = self._assemble_x(batch)
        B, S = x.shape[:2]
        positions = self._positions(batch, B, S, cache_index)
        if self.block0 is not None:
            x, _ = self.block0(x, positions, None if caches is None else
                               _layer(caches["block0"], 0), cache_index)
        for l, block in enumerate(self.blocks):
            if caches is None:
                x, _ = _remat(self.cfg, block, x, positions)
            else:
                x, _ = block(x, positions, _layer(caches["blocks"], l),
                             cache_index)
        return x

    def init_caches(self, batch_size: int, max_len: int):
        """Zero caches; on a mesh ``batch_size`` is this rank's rows, the
        KV heads are its own and MLA's latent ``ckv`` is its R-slice."""
        cfg, attn = self.cfg, self.blocks[0].attn
        if cfg.mla is None:
            init = attention.init_gqa_cache
            cfg = cfg.replace(kv_heads=attn.local_kv_heads())
        else:
            init = attention.init_mla_cache
            cfg = cfg.replace(mla=dataclasses.replace(
                cfg.mla, kv_lora_rank=attn.local_latent_rank()))
        proto = init(cfg, batch_size, max_len, CACHE_DTYPE,
                     device=self.device)
        caches = {"blocks": _stacked(proto, len(self.blocks))}
        if self.block0 is not None:
            caches["block0"] = _stacked(proto, 1)
        return caches


# ---------------------------------------------------------------------------
# xLSTM family (mLSTM groups + periodic sLSTM)
# ---------------------------------------------------------------------------

class XLSTM(LM):
    """``ssm``: groups of ``slstm_period`` − 1 mLSTM blocks and one sLSTM
    block. Recurrent, so decode needs no position."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__(cfg, generator=generator, device=device)
        kw = dict(generator=generator, device=device)
        period = cfg.ssm.slstm_period
        if cfg.num_layers % period:
            raise ValueError(f"xlstm: {cfg.num_layers} layers are not a "
                             f"multiple of the sLSTM period {period}")
        groups = cfg.num_layers // period
        self.mlstm = nn.ModuleList(
            nn.ModuleList(PreNorm(cfg, ssm.MLSTM(cfg, **kw), device)
                          for _ in range(period - 1))
            for _ in range(groups))
        self.slstm = nn.ModuleList(PreNorm(cfg, ssm.SLSTM(cfg, **kw), device)
                                   for _ in range(groups))

    def _run(self, batch, caches, cache_index: int):
        x = self._embed(batch["tokens"])
        for g, group in enumerate(self.mlstm):
            for j, block in enumerate(group):
                x, _ = (_remat(self.cfg, block, x) if caches is None else
                        block(x, _layer(caches["mlstm"], g, j)))
            x, _ = self.slstm[g](x, None if caches is None else
                                 _layer(caches["slstm"], g))
        return x

    def init_caches(self, batch_size: int, max_len: int):
        """Zero caches; on a mesh ``batch_size`` is this rank's rows and
        the mLSTM caches its slices (the sLSTM's are whole over the
        model axis)."""
        groups, per_group = len(self.mlstm), self.cfg.ssm.slstm_period - 1
        mc = ssm.init_mlstm_cache(
            self.cfg, batch_size, CACHE_DTYPE, device=self.device,
            tp=tensor_axes(self.mlstm[0][0].core.down_proj))
        sc = ssm.init_slstm_cache(self.cfg, batch_size, device=self.device)
        return {"mlstm": _stacked(mc, groups, per_group),
                "slstm": _stacked(sc, groups)}


# ---------------------------------------------------------------------------
# Zamba2-style hybrid (mamba2 stacks + one *shared* attention block)
# ---------------------------------------------------------------------------

class Hybrid(LM):
    """``hybrid``: groups of ``shared_attn_period`` Mamba2 blocks, each
    followed by the one shared attention block (one module, its weights
    reused by every group; each group keeps its own KV cache), then a
    tail of Mamba2 blocks. On a mesh each use of the shared block
    gathers its FSDP weights again, and its gradients sum over the
    groups through autograd."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__(cfg, generator=generator, device=device)
        kw = dict(generator=generator, device=device)
        period = cfg.ssm.shared_attn_period
        groups = cfg.num_layers // period
        self.mamba = nn.ModuleList(
            nn.ModuleList(PreNorm(cfg, ssm.Mamba2(cfg, **kw), device)
                          for _ in range(period))
            for _ in range(groups))
        self.mamba_tail = nn.ModuleList(
            PreNorm(cfg, ssm.Mamba2(cfg, **kw), device)
            for _ in range(cfg.num_layers - groups * period))
        self.shared_attn = Block(cfg.replace(moe=None), **kw)

    def _run(self, batch, caches, cache_index: int):
        x = self._embed(batch["tokens"])
        B, S = batch["tokens"].shape
        positions = common.positions_for(B, S, cache_index,
                                         device=self.device)
        for g, group in enumerate(self.mamba):
            for j, block in enumerate(group):
                x, _ = (_remat(self.cfg, block, x) if caches is None else
                        block(x, _layer(caches["groups"]["mamba"], g, j)))
            x, _ = self.shared_attn(x, positions, None if caches is None else
                                    _layer(caches["groups"]["attn"], g),
                                    cache_index)
        for j, block in enumerate(self.mamba_tail):
            x, _ = (_remat(self.cfg, block, x) if caches is None else
                    block(x, _layer(caches["tail"], j)))
        return x

    def init_caches(self, batch_size: int, max_len: int):
        """Zero caches; on a mesh ``batch_size`` is this rank's rows, the
        Mamba2 caches its heads' and channels' slices and the shared
        attention's its KV heads."""
        groups, period = len(self.mamba), self.cfg.ssm.shared_attn_period
        first = (self.mamba[0] if groups else self.mamba_tail)[0].core
        mc = ssm.init_mamba2_cache(self.cfg, batch_size, CACHE_DTYPE,
                                   device=self.device,
                                   tp=tensor_axes(first.out_proj))
        attn = self.shared_attn.attn
        ac = attention.init_gqa_cache(
            self.cfg.replace(kv_heads=attn.local_kv_heads()), batch_size,
            max_len, CACHE_DTYPE, device=self.device)
        caches = {"groups": {"mamba": _stacked(mc, groups, period),
                             "attn": _stacked(ac, groups)}}
        if len(self.mamba_tail):
            caches["tail"] = _stacked(mc, len(self.mamba_tail))
        return caches


# ---------------------------------------------------------------------------
# Encoder-decoder (seamless-m4t text decoder over stub audio encodings)
# ---------------------------------------------------------------------------

class EncDecBlock(nn.Module):
    """An encoder block (non-causal self-attention, then the MLP) or,
    with ``cross``, a decoder block (causal self-attention with a cache,
    cross-attention to the encoder's memory, then the MLP)."""

    def __init__(self, cfg: ModelConfig, cross: bool, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.ln1 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.attn = attention.GQA(cfg, **kw)
        self.ln2 = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device)
        self.ffn = MLP(cfg.d_model, cfg.d_ff, dtype,
                       common.dt(cfg.compute_dtype), **kw)
        self.ln_x = RMSNorm(cfg.d_model, dtype, cfg.norm_eps, device) \
            if cross else None
        self.cross = attention.GQA(cfg, **kw) if cross else None

    def forward(self, x, positions, memory=None, cache=None,
                cache_index: int = 0):
        decoder = self.cross is not None
        a, cache = self.attn(self.ln1(x), positions, cache, cache_index,
                             causal=decoder)
        x = x + a
        if decoder:
            c, _ = self.cross(self.ln_x(x), positions, kv_source=memory,
                              causal=False)
            x = x + c
        return x + self.ffn(self.ln2(x)), cache


class EncDec(LM):
    """``encdec``/``audio``. The encoder memory is cached at prefill in
    bfloat16, ``max_len`` frames: zeros past the encoder's length, longer
    memories cropped. As in the reference, prefill cross-attends to the
    unpadded memory and decode to the whole zero-padded buffer. On a
    mesh ``frame_proj``'s output columns are cut over the model axis and
    gathered whole for the encoder (``gather_tensor``), and the memory
    cache is this rank's batch rows, whole over the model axis."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__(cfg, generator=generator, device=device)
        kw = dict(generator=generator, device=device)
        self.frame_proj = nn.Parameter(dense_init(
            (cfg.d_model, cfg.d_model), common.dt(cfg.param_dtype), **kw))
        self.enc = nn.ModuleList(EncDecBlock(cfg, False, **kw)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(EncDecBlock(cfg, True, **kw)
                                 for _ in range(cfg.num_layers))

    def _encode(self, batch) -> torch.Tensor:
        cd = common.dt(self.cfg.compute_dtype)
        x = batch["frames"].to(cd) @ weight(self.frame_proj, cd)
        # on a mesh the projection's output width is cut over the model
        # axis; the encoder needs it whole
        x = gather_tensor(x, -1, tensor_axes(self.frame_proj))
        positions = common.positions_for(*x.shape[:2], device=self.device)
        for block in self.enc:
            x, _ = _remat(self.cfg, block, x, positions)
        return x

    def _decode_stack(self, tokens, memory, caches, cache_index: int):
        x = self._embed(tokens)
        positions = common.positions_for(*tokens.shape, cache_index,
                                         device=self.device)
        for l, block in enumerate(self.dec):
            if caches is None:
                x, _ = _remat(self.cfg, block, x, positions, memory)
            else:
                x, _ = block(x, positions, memory, _layer(caches, l),
                             cache_index)
        return x

    def _run(self, batch, caches, cache_index: int):
        return self._decode_stack(batch["tokens"], self._encode(batch),
                                  None, 0)

    def init_caches(self, batch_size: int, max_len: int):
        """Zero caches; on a mesh ``batch_size`` is this rank's rows, the
        self-attention's KV heads its own and the memory whole over the
        model axis."""
        cfg = self.cfg.replace(kv_heads=self.dec[0].attn.local_kv_heads())
        proto = attention.init_gqa_cache(cfg, batch_size, max_len,
                                         CACHE_DTYPE, device=self.device)
        return {"self": _stacked(proto, len(self.dec)),
                "memory": torch.zeros((batch_size, max_len,
                                       self.cfg.d_model), dtype=CACHE_DTYPE,
                                      device=self.device)}

    @torch.inference_mode()
    def prefill(self, batch, max_len: int):
        memory = self._encode(batch)
        caches = self.init_caches(batch["tokens"].shape[0], max_len)
        kept = memory[:, :max_len]
        caches["memory"][:, :kept.shape[1]] = kept.to(CACHE_DTYPE)
        x = self._decode_stack(batch["tokens"], memory, caches["self"], 0)
        return self._head(x[:, -1:]), caches

    @torch.inference_mode()
    def decode(self, batch, caches, index: int):
        memory = caches["memory"].to(common.dt(self.cfg.compute_dtype))
        x = self._decode_stack(batch["tokens"], memory, caches["self"],
                               int(index))
        return self._head(x), caches


# ---------------------------------------------------------------------------

_FAMILIES = {"dense": DecoderOnly, "moe": DecoderOnly, "vlm": DecoderOnly,
             "ssm": XLSTM, "hybrid": Hybrid, "encdec": EncDec,
             "audio": EncDec}


def resolve_device(device=None) -> torch.device:
    """``device``, the card if None; raises without a card unless the
    CPU is asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' (--device "
                           "cpu) to run on the CPU")
    return device


def build_model(cfg: ModelConfig, device=None,
                generator: Optional[torch.Generator] = None) -> LM:
    """The model of ``cfg`` on ``device`` (the card unless ``"cpu"``),
    its weights drawn from ``generator`` (one seeded with 0 on the device
    if None)."""
    family = _FAMILIES.get(cfg.family)
    if family is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return family(cfg, generator=generator, device=device)


# ---------------------------------------------------------------------------
# The reference's parameter pytree, as numpy arrays
# ---------------------------------------------------------------------------

def _ref_tree(module: nn.Module):
    """The module's parameters in the reference's pytree: a dict of
    (parameter, the reference's shape) leaves and sub-dicts, a
    ``ModuleList`` as a list (a stack on a leading axis; an empty one is
    left out, as the reference has no leaf for it)."""
    if isinstance(module, nn.ModuleList):
        return [_ref_tree(m) for m in module]
    shapes = module.ref_shapes() if hasattr(module, "ref_shapes") else {}
    tree = {name: (p, shapes.get(name, tuple(p.shape)))
            for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        sub = _ref_tree(child)
        if sub:
            tree[name] = sub
    return tree


class RefLeaf(NamedTuple):
    """One leaf of the reference's parameter pytree: its ``path`` of
    dict keys, the port's ``params`` that make it up (one, or one a
    layer of a stack, layer-major), the reference's ``shape`` (a
    stack's leading layer axes included) and ``lead``, the number of
    those axes.

    On a mesh (``runtime.shard.shard_model``) the leaf is this rank's
    slice: ``shape`` is the slice's, ``global_shape`` the whole leaf's,
    ``spec`` its dim-spec on ``mesh``; off a mesh those three are None."""
    path: Tuple[str, ...]
    params: List[nn.Parameter]
    shape: Tuple[int, ...]
    lead: int = 0
    global_shape: Optional[Tuple[int, ...]] = None
    spec: Optional[Tuple] = None
    mesh: Any = None

    def value(self) -> torch.Tensor:
        """The leaf at the reference's shape: a view of an unstacked
        parameter, a stacked copy of a stack's."""
        if len(self.params) == 1:
            return self.params[0].view(self.shape)
        return torch.stack([p.reshape(-1) for p in self.params]
                           ).view(self.shape)

    def slices(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Views of ``t`` (at ``shape``) shaped as each parameter."""
        rows = t.view(len(self.params), -1)
        return [r.view(p.shape) for r, p in zip(rows, self.params)]

    def mean(self, x: torch.Tensor, dim: Optional[int] = None,
             of: Optional[int] = None) -> torch.Tensor:
        """``x.mean(dim)`` (all of ``x`` for None) of the whole leaf's
        ``x``. On a mesh, from this rank's slice: the sum is all-reduced
        over the axes that cut the leaf's dim ``of`` (``dim`` by default;
        every axis of the spec for ``dim`` None), then divided by that
        dim's whole size (a float32 0-dim tensor)."""
        if self.spec is None:
            return x.mean() if dim is None else x.mean(dim)
        if dim is None:
            entries, count = self.spec, math.prod(self.global_shape)
        else:
            of = (dim if of is None else of) % len(self.spec)
            entries, count = (self.spec[of],), self.global_shape[of]
        axes = tuple(a for e in entries if e is not None
                     for a in ((e,) if isinstance(e, str) else e))
        if not axes:
            return x.mean() if dim is None else x.mean(dim)
        s = x.sum() if dim is None else x.sum(dim)
        s = all_reduce(s, axes_of(self.mesh, axes))
        return s / torch.full((), count, dtype=torch.float32,
                              device=s.device)


def _leaves_of(node, path: Tuple[str, ...]) -> List[RefLeaf]:
    if isinstance(node, tuple):
        param, shape = node
        return [RefLeaf(path, [param], tuple(shape))]
    if isinstance(node, list):
        layers = [_leaves_of(sub, path) for sub in node]
        return [RefLeaf(col[0].path, [p for leaf in col for p in leaf.params],
                        (len(node),) + col[0].shape, col[0].lead + 1)
                for col in zip(*layers)]
    return [leaf for k in sorted(node) for leaf in _leaves_of(node[k],
                                                               path + (k,))]


def ref_leaves(module: nn.Module) -> List[RefLeaf]:
    """The leaves of the reference's parameter pytree of ``module``, in
    its flattening order (dict keys sorted). A stack is one leaf with
    leading layer axes (a ``(L, d)`` norm scale, an ``(L, d, H, Dh)``
    projection), as the reference's optimizers see it. A model laid out
    on a mesh (``runtime.shard.shard_model``) gives its rank's slices."""
    layout = getattr(module, "layout", None)
    if layout is not None:
        return layout.leaves
    return _leaves_of(_ref_tree(module), ())


def nest(items) -> Dict:
    """A nested dict from ``(path, value)`` pairs."""
    tree: Dict = {}
    for path, value in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = value
    return tree


def _paths(tree, prefix: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


def params_from_numpy(model: nn.Module, tree) -> nn.Module:
    """Copy the reference's parameter pytree (numpy arrays) into
    ``model`` (a whole model or one of its modules), in place, at each
    parameter's dtype and device. A model on a mesh takes either the
    whole arrays (it keeps its rank's slice of each) or its slices."""
    values = dict(_paths(tree))
    layout = getattr(model, "layout", None)
    if layout is not None:
        values = layout.local_values(values)
    leaves = ref_leaves(model)
    differ = set(values) ^ {leaf.path for leaf in leaves}
    if differ:
        raise ValueError(f"params: the reference's tree and the model's "
                         f"differ at {sorted('/'.join(p) for p in differ)}")
    with torch.no_grad():
        for leaf in leaves:
            value = np.asarray(values[leaf.path])
            if value.shape != leaf.shape:
                raise ValueError(f"params/{'/'.join(leaf.path)}: the "
                                 f"reference's shape is {leaf.shape}, "
                                 f"given {value.shape}")
            t = torch.from_numpy(np.ascontiguousarray(value,
                                                      dtype=np.float32))
            for p, v in zip(leaf.params, leaf.slices(t)):
                p.copy_(v)
    return model


def params_to_numpy(model: nn.Module) -> dict:
    """The inverse of ``params_from_numpy``: the reference's pytree, as
    float32 numpy arrays in the reference's shapes (on a mesh, this
    rank's slices; ``runtime.shard.gather_params`` gives them whole)."""
    return nest((leaf.path, np.stack([p.detach().float().cpu().numpy()
                                      for p in leaf.params]
                                     ).reshape(leaf.shape))
                for leaf in ref_leaves(model))
