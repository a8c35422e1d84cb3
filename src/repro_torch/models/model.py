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

import contextlib
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
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.mesh_ctx import (WHOLE, SeqCut, all_reduce, axes_of,
                                          current_cut, enter_tensor,
                                          gather_partial, gather_tensor, own,
                                          reduce_tensor, seq_context,
                                          seq_offset, shard_of, tensor_axes,
                                          weight)

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
    records (see the module's docstring). The recompute, which runs in
    the backward, runs under the ``SeqCut`` of the forward."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return layer(*args)
    if cfg.remat not in ("block", "full"):
        raise ValueError(f"remat {cfg.remat!r}: none, block or full")
    kw = {}
    if cfg.remat == "block":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _save_products)
    cut = current_cut()

    def run(*a):
        with seq_context(cut):
            return layer(*a)
    return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                       **kw)


def _with_seq(ax):
    """The running ``SeqCut`` with the activations' sequence cut over
    ``ax`` (nothing to set off a step on a mesh)."""
    cut = current_cut()
    return contextlib.nullcontext() if cut is None else \
        seq_context(dataclasses.replace(cut, seq=ax))


def _map_caches(fn, tree):
    """``tree`` (nested dicts of tensors) with each leaf replaced by
    ``fn(leaf name, leaf)``."""
    return {k: _map_caches(fn, v) if isinstance(v, dict) else fn(k, v)
            for k, v in tree.items()}


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
    """x + core(ln x): a layer of the xlstm and hybrid stacks. Its
    recurrent core runs on the whole sequence: on a sequence cut over
    the batch axes (``SeqCut.seq``) its input is gathered over them
    (``gather_partial``: the backward sums the ranks' gradients, then
    keeps this rank's slice) and each rank keeps its slice of the
    output; the final state, the same on every rank, is the whole
    sequence's, as the caches' layout (whole over those axes) wants."""

    def __init__(self, cfg: ModelConfig, core: nn.Module, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, common.dt(cfg.param_dtype),
                          cfg.norm_eps, device)
        self.core = core

    def forward(self, x, cache=None):
        sq = (current_cut() or WHOLE).seq
        out, cache = self.core(gather_partial(self.ln(x), 1, sq), cache)
        return x + own(out, 1, sq), cache


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
        """The forward alone over the whole sequence → (B, S, V) (on a
        mesh this rank's positions of it, where the sequence is cut)."""
        with self._cut(batch):
            return self._head(self._run(batch, None, 0))

    def aligned_labels(self, batch) -> torch.Tensor:
        """The labels that the last positions of ``train_logits``
        score: ``batch["labels"]`` (a vlm on a cut sequence realigns
        them)."""
        return batch["labels"]

    @torch.inference_mode()
    def prefill(self, batch, max_len: int):
        """Fill fresh caches of ``max_len`` with the prompt → (logits of
        the last position (B, 1, V), caches)."""
        caches = self.init_caches(self._global_rows(batch), max_len)
        with self._cut(batch, serving=True):
            x = self._run(batch, caches, 0)
            return self._head(self._last(x)), caches

    @torch.inference_mode()
    def decode(self, batch, caches, index: int):
        """One step at absolute position ``index``: the caches are
        written in place → (logits (B, S, V), caches)."""
        with self._cut(batch, serving=True):
            x = self._run(batch, caches, int(index))
            return self._head(x), caches

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- caches and the sequence's cut on a mesh --------------------------

    def cache_shapes(self, batch_size: int, max_len: int):
        """The caches of a global batch of ``batch_size`` rows and
        ``max_len`` positions, as tensors on ``meta`` (the reference's
        ``init_caches`` shapes)."""
        raise NotImplementedError

    def init_caches(self, batch_size: int, max_len: int):
        """Zero caches for a global batch of ``batch_size`` rows and
        ``max_len`` positions. On a mesh each leaf is this rank's slice,
        as ``infer_cache_specs`` cuts it (the batch, KV heads, latent
        rank, recurrent heads and conv channels, and the sequence or Dh
        where the rules cut them), and the model keeps the geometry
        (``cache_geometry``) that its steps read the cut from."""
        shapes = self.cache_shapes(batch_size, max_len)
        layout = getattr(self, "layout", None)
        if layout is not None:
            self.cache_geometry = (batch_size, max_len)

        def zeros(name, t):
            shape = tuple(t.shape)
            if layout is not None:
                spec = shd.spec_for_cache_leaf(name, shape, layout.mesh,
                                               layout.profile)
                shape = shd.local_shape(shape, spec, layout.mesh)
            return torch.zeros(shape, dtype=t.dtype, device=self.device)
        return _map_caches(zeros, shapes)

    def _global_rows(self, batch) -> int:
        """The global batch of a step's batch: its rows, times the batch
        axes' ranks where they cut the rows."""
        cut = current_cut()
        layout = getattr(self, "layout", None)
        rows = cut.rows if cut is not None else (
            None if layout is None else layout.dp)
        B = batch["tokens"].shape[0]
        return B if rows is None else B * rows.size

    def _x_cut(self, batch, cut: SeqCut):
        """The batch axes, where they cut the activations' sequence."""
        return cut.tokens

    def _cache_cut(self) -> Dict:
        """The ``SeqCut`` fields of the caches, from the rules on the
        global shapes of the last ``init_caches``."""
        layout, cfg = self.layout, self.cfg
        if getattr(self, "cache_geometry", None) is None:
            raise ValueError("a serve step on a mesh takes caches made by "
                             "this model (prefill or init_caches)")
        B, L = self.cache_geometry
        sizes = shd.mesh_shape(layout.mesh)

        def axes(name, shape, dim):
            e = shd.spec_for_cache_leaf(name, shape, layout.mesh,
                                        layout.profile)[dim]
            return None if e is None or shd.axes_size(sizes, e) == 1 \
                else axes_of(layout.mesh, e)
        kv = (B, L, cfg.kv_heads, cfg.resolved_head_dim)
        out = {"kv": axes("k", kv, 1), "kv_dh": axes("k", kv, 3),
               "memory": axes("memory", (B, L, cfg.d_model), 1)}
        if cfg.mla is not None:
            out["latent"] = axes("ckv", (B, L, cfg.mla.kv_lora_rank), 1)
        return out

    def _cut(self, batch, serving: bool = False):
        """The context a step's forward runs in on a mesh: the step's
        ``SeqCut`` (rows cut, by default), the activations' sequence cut
        and, serving, the caches'."""
        layout = getattr(self, "layout", None)
        if layout is None:
            return contextlib.nullcontext()
        cut = current_cut() or SeqCut(rows=layout.dp)
        cut = dataclasses.replace(cut, seq=self._x_cut(batch, cut))
        if serving:
            cut = dataclasses.replace(cut, **self._cache_cut())
            if self._global_rows(batch) != self.cache_geometry[0]:
                raise ValueError(
                    f"a batch of {self._global_rows(batch)} rows on "
                    f"caches of {self.cache_geometry[0]}: give the step "
                    f"the batch's specs (runtime.shard.shard_batch)")
        return seq_context(cut)

    def _last(self, x: torch.Tensor) -> torch.Tensor:
        """The last position of the sequence (B, 1, d): the last rank's
        where the batch axes cut it."""
        return gather_partial(x[:, -1:], 1,
                              (current_cut() or WHOLE).seq)[:, -1:]


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

    def _vision(self, batch) -> bool:
        return self.patch_proj is not None and "patches" in batch

    def _x_cut(self, batch, cut: SeqCut):
        """A vlm's activations are the patches, then the tokens: where
        the batch axes cut either's sequence, they cut the whole one's
        when they divide it, else it is whole on every rank."""
        dp = cut.tokens or cut.patches
        if not self._vision(batch) or dp is None:
            return cut.tokens
        total = sum(batch[k].shape[1] * (1 if c is None else c.size)
                    for k, c in (("tokens", cut.tokens),
                                 ("patches", cut.patches)))
        return dp if total % dp.size == 0 else None

    def _assemble_x(self, batch) -> torch.Tensor:
        x = self._embed(batch["tokens"])
        if self._vision(batch):
            cd = common.dt(self.cfg.compute_dtype)
            pe = batch["patches"].to(cd) @ weight(self.patch_proj, cd)
            # on a mesh the projection's output width is cut over the
            # model axis; the sequence needs it whole
            pe = gather_tensor(pe, -1, tensor_axes(self.patch_proj))
            cut = current_cut() or WHOLE
            # a cut sequence: the global order, then this rank's slice
            x = torch.cat([gather_partial(pe, 1, cut.patches),
                           gather_partial(x, 1, cut.tokens)], dim=1)
            x = own(x, 1, cut.seq)
        return x

    def aligned_labels(self, batch) -> torch.Tensor:
        """A vlm's labels on a cut sequence: gathered, after a −1 a
        patch, then cut as its activations are."""
        labels = batch["labels"]
        cut = current_cut()
        if cut is None or not self._vision(batch) or (
                cut.tokens is None and cut.patches is None):
            return labels
        P = batch["patches"].shape[1] * (1 if cut.patches is None
                                         else cut.patches.size)
        full = gather_partial(labels, 1, cut.tokens)
        full = torch.cat([full.new_full((full.shape[0], P), -1), full], 1)
        return own(full, 1, self._x_cut(batch, cut))

    def _positions(self, batch, B: int, S: int, cache_index: int):
        sq = (current_cut() or WHOLE).seq
        off = seq_offset(sq, S)
        if self.cfg.mrope:
            pos = batch.get("positions3")
            if pos is None:   # the reference's default: 0..S-1, no offset
                pos = common.positions_for(B, S, off, device=self.device)
                return pos[None].expand(3, B, S)
            # whole over the batch axes where they do not cut the rows
            return own(pos, 2, sq)
        return common.positions_for(B, S, cache_index + off,
                                    device=self.device)

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

    def cache_shapes(self, batch_size: int, max_len: int):
        init = attention.init_gqa_cache if self.cfg.mla is None else \
            attention.init_mla_cache
        proto = init(self.cfg, batch_size, max_len, CACHE_DTYPE,
                     device="meta")
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

    def cache_shapes(self, batch_size: int, max_len: int):
        groups, per_group = len(self.mlstm), self.cfg.ssm.slstm_period - 1
        mc = ssm.init_mlstm_cache(self.cfg, batch_size, CACHE_DTYPE,
                                  device="meta")
        sc = ssm.init_slstm_cache(self.cfg, batch_size, device="meta")
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
        positions = common.positions_for(
            B, S, cache_index + seq_offset((current_cut() or WHOLE).seq, S),
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

    def cache_shapes(self, batch_size: int, max_len: int):
        groups, period = len(self.mamba), self.cfg.ssm.shared_attn_period
        mc = ssm.init_mamba2_cache(self.cfg, batch_size, CACHE_DTYPE,
                                   device="meta")
        ac = attention.init_gqa_cache(self.cfg, batch_size, max_len,
                                      CACHE_DTYPE, device="meta")
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
                cache_index: int = 0, memory_seq=None):
        decoder = self.cross is not None
        a, cache = self.attn(self.ln1(x), positions, cache, cache_index,
                             causal=decoder)
        x = x + a
        if decoder:
            c, _ = self.cross(self.ln_x(x), positions, kv_source=memory,
                              causal=False, kv_seq=memory_seq)
            x = x + c
        return x + self.ffn(self.ln2(x)), cache


class EncDec(LM):
    """``encdec``/``audio``. The encoder memory is cached at prefill in
    bfloat16, ``max_len`` frames: zeros past the encoder's length, longer
    memories cropped. As in the reference, prefill cross-attends to the
    unpadded memory and decode to the whole zero-padded buffer. On a
    mesh ``frame_proj``'s output columns are cut over the model axis and
    gathered whole for the encoder (``gather_tensor``), and the memory
    cache is this rank's batch rows, whole over the model axis. Where
    the batch axes cut the frames' sequence, the encoder runs on its
    cut and its output is gathered for the decoder; the memory cache
    cut on S is attended with the softmax combined over the cut."""

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
        """The encoder's output, whole in its sequence."""
        cd = common.dt(self.cfg.compute_dtype)
        x = batch["frames"].to(cd) @ weight(self.frame_proj, cd)
        # on a mesh the projection's output width is cut over the model
        # axis; the encoder needs it whole
        x = gather_tensor(x, -1, tensor_axes(self.frame_proj))
        frames = (current_cut() or WHOLE).frames
        B, F = x.shape[:2]
        with _with_seq(frames):
            positions = common.positions_for(B, F, seq_offset(frames, F),
                                             device=self.device)
            for block in self.enc:
                x, _ = _remat(self.cfg, block, x, positions)
        return gather_partial(x, 1, frames)

    def _decode_stack(self, tokens, memory, caches, cache_index: int,
                      memory_seq=None):
        x = self._embed(tokens)
        B, S = tokens.shape
        positions = common.positions_for(
            B, S, cache_index + seq_offset((current_cut() or WHOLE).seq, S),
            device=self.device)
        for l, block in enumerate(self.dec):
            if caches is None:
                x, _ = _remat(self.cfg, block, x, positions, memory)
            else:
                x, _ = block(x, positions, memory, _layer(caches, l),
                             cache_index, memory_seq)
        return x

    def _run(self, batch, caches, cache_index: int):
        return self._decode_stack(batch["tokens"], self._encode(batch),
                                  None, 0)

    def cache_shapes(self, batch_size: int, max_len: int):
        proto = attention.init_gqa_cache(self.cfg, batch_size, max_len,
                                         CACHE_DTYPE, device="meta")
        return {"self": _stacked(proto, len(self.dec)),
                "memory": torch.zeros((batch_size, max_len,
                                       self.cfg.d_model), dtype=CACHE_DTYPE,
                                      device="meta")}

    @torch.inference_mode()
    def prefill(self, batch, max_len: int):
        caches = self.init_caches(self._global_rows(batch), max_len)
        with self._cut(batch, serving=True):
            memory = self._encode(batch)
            attention._write(caches, {"memory": memory[:, :max_len]}, 0,
                             (current_cut() or WHOLE).memory)
            x = self._decode_stack(batch["tokens"], memory, caches["self"],
                                   0)
            return self._head(self._last(x)), caches

    @torch.inference_mode()
    def decode(self, batch, caches, index: int):
        with self._cut(batch, serving=True):
            memory = caches["memory"].to(common.dt(self.cfg.compute_dtype))
            x = self._decode_stack(batch["tokens"], memory, caches["self"],
                                   int(index),
                                   (current_cut() or WHOLE).memory)
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
