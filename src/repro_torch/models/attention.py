"""Attention: GQA/MHA with QKV bias and RoPE or M-RoPE, cross-attention,
and DeepSeek-V2's multi-head latent attention (MLA), with KV caches.

Port of the JAX package's ``models/attention.py`` (``init_gqa``,
``_sdpa``, ``gqa_attention``, ``init_gqa_cache``, ``init_mla``,
``mla_attention``, ``init_mla_cache``).

A GQA cache is ``{"k", "v"}`` of (B, S_max, Hkv, Dh); an MLA cache holds
the compressed latents, ``{"ckv": (B, S_max, kv_lora), "k_rope": (B,
S_max, rope_dim)}``, and K and V are expanded from the whole buffer at
every step, as the reference does. Both are written in place at
``cache_index``; attention then runs over the whole buffer with the
causal mask. Dtypes follow the reference: the products at the compute
dtype, logits and softmax in float32, probabilities cast back to the
compute dtype before the product with V.

On a mesh the step's ``runtime.mesh_ctx.SeqCut`` says where the
sequences lie: queries cut over the batch axes attend to K/V (or MLA's
latents) gathered over them; a cache cut on S (over the batch axes, or
over the model axis where it does not divide the KV heads) or on Dh is
written in this rank's range of it (``_write``) and, once it holds
earlier positions, attended with the softmax combined over the cut
(``_split_attention``, ``softmax_combine``), as the reference's
flash-decode layout has GSPMD do.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import (RMSNorm, apply_mrope, apply_rope,
                                       dense_init)
from repro_torch.runtime.mesh_ctx import (WHOLE, all_reduce,
                                          constrain, current_cut,
                                          enter_tensor, gather_cache,
                                          gather_partial, own, own_slice,
                                          row_parallel, seq_offset,
                                          softmax_combine, tensor_axes,
                                          weight)
from repro_torch.runtime.sharding import spec_for_cache_leaf

#: prefill query chunk: a query longer than this, and a multiple of it, is
#: attended in chunks so that the (B, H, Sq, Skv) logits never exist whole
#: (a 32k prefill would need them at ~17 GB a layer)
_Q_CHUNK = 2048

_MASKED = -1e30


def _as(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype``, as a weakly typed Python scalar is
    in the reference before it multiplies an array of that dtype."""
    return float(torch.tensor(scale, dtype=dtype))


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k/v: (B, Skv, Hkv, Dh); mask: (Sq, Skv) bool.

    Decode (Sq = 1) groups the H query heads over the Hkv cached heads;
    prefill and training (Sq > 1) repeat K/V to all H heads, and chunk the
    queries past ``_Q_CHUNK``. On a mesh the heads here are this rank's
    (``GQA`` cuts them over the model axis); ``constrain`` marks where
    the reference pins their layout."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    cd = compute_dtype
    scale = _as(Dh ** -0.5, cd)

    if Sq == 1:
        k = constrain(k, "batch", "tensor", None, None)
        v = constrain(v, "batch", "tensor", None, None)
        qg = q.reshape(B, Hkv, groups, Dh).to(cd)
        logits = torch.matmul(qg, k.to(cd).permute(0, 2, 3, 1)) * scale
        logits = torch.where(mask, logits.float(), _MASKED)
        probs = torch.softmax(logits, dim=-1).to(cd)      # (B, Hkv, g, Skv)
        out = torch.matmul(probs, v.to(cd).transpose(1, 2))
        return out.reshape(B, Sq, H, Dh)

    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    q = constrain(q.to(cd), "batch", None, "tensor", None)
    k = constrain(k.to(cd), "batch", None, "tensor", None)
    v = constrain(v.to(cd), "batch", None, "tensor", None)
    qh = q.transpose(1, 2)                                # (B, H, Sq, Dh)
    kt = k.permute(0, 2, 3, 1)                            # (B, H, Dh, Skv)
    vh = v.transpose(1, 2)                                # (B, H, Skv, Dh)

    def att(q_blk, mask_blk):
        logits = constrain(torch.matmul(q_blk, kt) * scale,
                           "batch", "tensor", None, None)
        logits = torch.where(mask_blk, logits.float(), _MASKED)
        probs = torch.softmax(logits, dim=-1).to(cd)
        return torch.matmul(probs, vh)                    # (B, H, s, Dh)

    chunk = _Q_CHUNK
    if Sq > chunk and Sq % chunk == 0:
        out = torch.empty_like(qh)
        for c in range(0, Sq, chunk):
            out[:, :, c:c + chunk] = att(qh[:, :, c:c + chunk],
                                         mask[c:c + chunk])
    else:
        out = att(qh, mask)
    return out.transpose(1, 2)


def _heads(k: torch.Tensor, v: torch.Tensor, part, groups: int):
    """K/V of every KV head, on a model rank that keeps only its share
    ``part`` of the query heads: repeated to the query heads, then this
    rank's slice (as the reference's prefill repeats them and pins the
    heads to the model axis); unchanged where ``part`` is None."""
    if part is None:
        return k, v
    return (own_slice(t.repeat_interleave(groups, dim=2), 2, part)
            for t in (k, v))


def _split_attention(q, k, v, cd, *, causal: bool, q_pos: int, kv_ax,
                     dh_ax, part, sq):
    """Attention of ``q`` (B, Sq, H_loc, Dh: this rank's queries and
    heads, the first of the sequence at global position ``q_pos``) over
    K/V (B, S_loc, Hkv_c, Dh_c) cut on their sequence over
    ``kv_ax`` and/or on Dh over ``dh_ax`` (a cache buffer, or the
    encoder's memory cache): every query of the sequence (gathered over
    ``sq``) and, where the KV heads are whole on each model rank
    (``part``), every head; the logits of each rank's keys, summed over
    ``dh_ax`` where Dh is cut; the softmax combined over ``kv_ax``
    (``softmax_combine``); the output's Dh gathered; then this rank's
    queries and heads again."""
    B = q.shape[0]
    q = gather_partial(gather_partial(q, 1, sq), 2, part)
    Sq, H, Dh = q.shape[1:]
    S, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    scale = _as(Dh ** -0.5, cd)
    q = own(q, -1, dh_ax)
    qg = q.reshape(B, Sq, Hkv, g, -1).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, g * Sq, q.shape[-1])
    kt = k.permute(0, 2, 3, 1)                             # (B, Hkv, d, S)
    if dh_ax is None:
        logits = torch.matmul(qg.to(cd), kt.to(cd)) * scale
    else:     # partial dot products over Dh, at float32, rounded once
        logits = all_reduce(qg.to(cd).float() @ kt.to(cd).float(),
                            dh_ax).to(cd) * scale
    if causal:
        mask = common.causal_mask(Sq, S, q_pos - seq_offset(kv_ax, S),
                                  device=q.device).repeat(g, 1)
        logits = torch.where(mask, logits.float(), _MASKED)
    out = softmax_combine(logits.float(), v.transpose(1, 2), kv_ax, cd)
    out = gather_partial(out, -1, dh_ax)                  # (B, Hkv, g·Sq, Dh)
    out = out.reshape(B, Hkv, g, Sq, Dh).permute(0, 3, 1, 2, 4).reshape(
        B, Sq, H, Dh)
    return own(own(out, 2, part), 1, sq)


class GQA(nn.Module):
    """Grouped-query self-attention of one block. Weights at
    ``param_dtype``: ``wq`` (d, H·Dh), ``wk``/``wv`` (d, Hkv·Dh), ``wo``
    (H·Dh, d), biases (H·Dh,) / (Hkv·Dh,) when ``qkv_bias``.

    On a mesh (``runtime.shard``) a rank holds the heads of its model
    coordinate, H/t query and Hkv/t KV heads (column-parallel ``wq``,
    ``wk``, ``wv`` and biases, row-parallel ``wo`` with an all-reduce),
    and its FSDP slice of d, gathered at use; the head counts are read
    off the local weights. Where the model axis does not divide the KV
    heads, ``wk``/``wv``/``bk``/``bv`` are whole on each model rank,
    which computes every KV head and keeps its query heads' share of
    them: those four enter through ``enter_tensor``, so that their
    gradient, a partial sum on each rank, is summed over the model axis.

    The step's ``SeqCut`` says how the sequences lie: the queries' over
    the batch axes (``seq``; K/V then gathered over them, backward
    summed and sliced: ``gather_partial``), and the cache's S (``kv``)
    and Dh (``kv_dh``). A cut cache is written in this rank's range of
    it (``_write``); a fresh one is attended through the new K/V at its
    dtype (what the buffer holds), a used one by ``_split_attention``."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.kv_heads
        Dh = cfg.resolved_head_dim
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        # drawn in the reference's 3-D shapes, so that fan-in matches
        self.wq = nn.Parameter(dense_init((d, H, Dh), dtype, **kw)
                               .reshape(d, H * Dh))
        self.wk = nn.Parameter(dense_init((d, Hkv, Dh), dtype, **kw)
                               .reshape(d, Hkv * Dh))
        self.wv = nn.Parameter(dense_init((d, Hkv, Dh), dtype, **kw)
                               .reshape(d, Hkv * Dh))
        self.wo = nn.Parameter(dense_init((H, Dh, d), dtype, (0, 1), **kw)
                               .reshape(H * Dh, d))
        if cfg.qkv_bias:
            zeros = dict(dtype=dtype, device=device)
            self.bq = nn.Parameter(torch.zeros(H * Dh, **zeros))
            self.bk = nn.Parameter(torch.zeros(Hkv * Dh, **zeros))
            self.bv = nn.Parameter(torch.zeros(Hkv * Dh, **zeros))

    def ref_shapes(self) -> Dict[str, tuple]:
        """The reference's shape of each parameter stored flattened."""
        cfg = self.cfg
        d, H, Hkv = cfg.d_model, cfg.num_heads, cfg.kv_heads
        Dh = cfg.resolved_head_dim
        return {"wq": (d, H, Dh), "wk": (d, Hkv, Dh), "wv": (d, Hkv, Dh),
                "wo": (H, Dh, d), "bq": (H, Dh), "bk": (Hkv, Dh),
                "bv": (Hkv, Dh)}

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0,
                kv_source: Optional[torch.Tensor] = None,
                causal: bool = True, kv_seq=None):
        """x: (B, S, d) at the compute dtype; positions (B, S), or
        (3, B, S) for M-RoPE, global. With a cache, K/V are written at
        ``cache_index`` and the queries attend over the whole buffer.
        ``kv_source`` (cross-attention) gives K/V's input in place of x,
        whole in its sequence, or cut on it over ``kv_seq`` (the encoder
        memory's cache), and then neither q nor k is rotated;
        ``causal=False`` attends to every key. Returns (out, cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        Dh = cfg.resolved_head_dim
        cd = common.dt(cfg.compute_dtype)
        cut = current_cut() or WHOLE
        tp = tensor_axes(self.wq)
        part = tp if tensor_axes(self.wk) is None else None
        x = enter_tensor(x, tp)
        src = x if kv_source is None else enter_tensor(kv_source, tp)
        q = x @ weight(self.wq, x.dtype)
        k = src @ enter_tensor(weight(self.wk, x.dtype), part)
        v = src @ enter_tensor(weight(self.wv, x.dtype), part)
        if cfg.qkv_bias:
            q = q + self.bq.to(q.dtype)
            k = k + enter_tensor(self.bk, part).to(k.dtype)
            v = v + enter_tensor(self.bv, part).to(v.dtype)
        Skv = src.shape[1]
        q, k, v = (q.view(B, S, -1, Dh), k.view(B, Skv, -1, Dh),
                   v.view(B, Skv, -1, Dh))
        groups = cfg.num_heads // cfg.kv_heads
        if kv_source is None:
            if cfg.mrope:
                q = apply_mrope(q, positions, cfg.mrope_sections,
                                cfg.rope_theta)
                k = apply_mrope(k, positions, cfg.mrope_sections,
                                cfg.rope_theta)
            else:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)
            # this rank's queries against the whole sequence's keys
            k, v = (gather_partial(t, 1, cut.seq) for t in (k, v))
        off = seq_offset(cut.seq, S)          # of this rank's queries

        def attend(k, v, q_pos):
            kv_len = k.shape[1]
            mask = (common.causal_mask(S, kv_len, q_pos, device=x.device)
                    if causal else
                    torch.ones((S, kv_len), dtype=torch.bool,
                               device=x.device))
            return _sdpa(q, *_heads(k, v, part, groups), mask, cd)

        if kv_seq is not None:
            out = _split_attention(q, k, v, cd, causal=False, q_pos=0,
                                   kv_ax=kv_seq, dh_ax=None, part=part,
                                   sq=cut.seq)
        elif cache is None:
            out = attend(k, v, off)
        elif cut.kv is None and cut.kv_dh is None:
            # the whole buffer on every rank
            _write(cache, {"k": k, "v": v}, cache_index)
            out = attend(cache["k"], cache["v"], cache_index + off)
        else:
            _write(cache, {"k": own(k, -1, cut.kv_dh),
                           "v": own(v, -1, cut.kv_dh)}, cache_index, cut.kv)
            if cache_index == 0:
                # a fresh buffer holds the new K/V at its dtype, then
                # zeros (masked)
                dtype = cache["k"].dtype
                out = attend(k.to(dtype), v.to(dtype), off)
            else:
                out = _split_attention(q, cache["k"], cache["v"], cd,
                                       causal=True, q_pos=cache_index,
                                       kv_ax=cut.kv, dh_ax=cut.kv_dh,
                                       part=part, sq=cut.seq)
        out = out.reshape(B, S, -1)
        return row_parallel(out, self.wo, tp).to(x.dtype), cache


def _write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
           cache_index: int, ax=None) -> None:
    """Write each (B, S, ...) entry of ``new`` into its (B, S_max, ...)
    buffer at ``cache_index``, at the buffer's dtype. The start clamps
    into the buffer, as the reference's dynamic_update_slice does; the
    caller's mask keeps the true position. A buffer cut on S over ``ax``
    is this rank's range of the global one: the clamp is the global
    one, and the rank writes the positions that fall in its range."""
    for name, t in new.items():
        buf = cache[name]
        S, n = t.shape[1], buf.shape[1]
        lo = seq_offset(ax, n)
        at = max(0, min(cache_index, n * (1 if ax is None else ax.size) - S))
        a, b = max(at, lo), min(at + S, lo + n)
        if a < b:
            buf[:, a - lo:b - lo] = t[:, a - at:b - at].to(buf.dtype)


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str,
                                                              torch.Tensor]:
    Dh = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.kv_heads, Dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


class MLA(nn.Module):
    """DeepSeek-V2's multi-head latent attention of one block. Weights at
    ``param_dtype`` in the reference's shapes: q through a low rank
    (``wq_a`` (d, q_lora), ``q_norm``, ``wq_b`` (q_lora, H, nope + rope)),
    K and V from a compressed latent (``wkv_a`` (d, kv_lora),
    ``kv_norm``, ``wk_b`` / ``wv_b`` (kv_lora, H, ·)) plus one decoupled
    rotary key (``wk_rope`` (d, rope)), ``wo`` (H, v, d).

    On a mesh (``runtime.shard``) the down projections ``wq_a``,
    ``wkv_a`` and ``wk_rope`` are cut on d over the FSDP axes and
    gathered at use, and the norms run whole on every model rank. Where
    the model axis divides the heads (``head_axes``), the up projections
    ``wq_b``, ``wk_b``, ``wv_b`` are column-parallel on them (each rank
    expands K_nope and V for its H/t heads from the whole latent, which
    enters through ``enter_tensor``) and ``wo`` is row-parallel; where it
    does not, the rules cut none of the four on it, and every model rank
    runs every head. Apart from the heads, the latent cache ``ckv`` is
    cut on R over the model axis where it divides R (``latent_axes``,
    ``infer_cache_specs``): a rank writes its R-slice and gathers the
    whole buffer at each step (R·(t − 1)/t elements a cached position
    a layer, where summing partial expansions over the axis would move
    H·(nope + v)); ``k_rope`` is whole."""

    #: the model axis of the mesh the block is laid out on (set by
    #: ``runtime.shard.shard_model``; None off a mesh)
    model_axis = None

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, H = cfg.d_model, cfg.num_heads
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        qd = m.nope_head_dim + m.rope_head_dim
        self.wq_a = nn.Parameter(dense_init((d, m.q_lora_rank), dtype, **kw))
        self.q_norm = RMSNorm(m.q_lora_rank, dtype, cfg.norm_eps, device)
        self.wq_b = nn.Parameter(dense_init((m.q_lora_rank, H, qd), dtype,
                                            **kw))
        self.wkv_a = nn.Parameter(dense_init((d, m.kv_lora_rank), dtype,
                                             **kw))
        self.kv_norm = RMSNorm(m.kv_lora_rank, dtype, cfg.norm_eps, device)
        self.wk_rope = nn.Parameter(dense_init((d, m.rope_head_dim), dtype,
                                               **kw))
        self.wk_b = nn.Parameter(dense_init(
            (m.kv_lora_rank, H, m.nope_head_dim), dtype, **kw))
        self.wv_b = nn.Parameter(dense_init(
            (m.kv_lora_rank, H, m.v_head_dim), dtype, **kw))
        self.wo = nn.Parameter(dense_init((H, m.v_head_dim, d), dtype,
                                          (0, 1), **kw))

    def head_axes(self):
        """The model axis that cuts the heads (``wq_b``, ``wk_b``,
        ``wv_b`` and ``wo`` alike); None off a mesh or where it does not
        divide them."""
        return tensor_axes(self.wk_b)

    def latent_axes(self):
        """The model axis that cuts the latent cache's R, as the rules
        cut ``ckv`` (where it divides R, whatever the heads); None off a
        mesh or where it does not."""
        ax = self.model_axis
        if ax is None:
            return None
        spec = spec_for_cache_leaf("ckv", (1, 1, self.cfg.mla.kv_lora_rank),
                                   {"model": ax.size})
        return ax if spec[2] is not None else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0):
        """x: (B, S, d) at the compute dtype; positions (B, S), global.
        With a cache, the latents are written at ``cache_index`` (rounded
        to the cache's dtype) and K/V are expanded from the whole buffer.
        On a cut sequence (``SeqCut.seq``) the latents are gathered over
        it (backward summed and sliced), and a cache cut on S
        (``SeqCut.latent``) is written in this rank's range; a fresh one
        is attended through the new latents at its dtype, a used one
        with the softmax combined over the cut after the R gather.
        Returns (out, cache)."""
        cfg, m = self.cfg, self.cfg.mla
        cd = common.dt(cfg.compute_dtype)
        B, S, _ = x.shape
        nope, rope = m.nope_head_dim, m.rope_head_dim
        tp, lat = self.head_axes(), self.latent_axes()
        cut = current_cut() or WHOLE

        q_lat = self.q_norm(x @ weight(self.wq_a, x.dtype))
        q = enter_tensor(q_lat, tp) @ weight(self.wq_b, x.dtype).flatten(1)
        q = q.view(B, S, -1, nope + rope)                  # this rank's heads
        q_nope, q_rope = q.split([nope, rope], dim=-1)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        ckv = self.kv_norm(x @ weight(self.wkv_a, x.dtype))
        k_rope = apply_rope((x @ weight(self.wk_rope, x.dtype))[:, :, None, :],
                            positions, cfg.rope_theta)[:, :, 0, :]
        # this rank's queries against the whole sequence's latents
        ckv, k_rope = (gather_partial(t, 1, cut.seq) for t in (ckv, k_rope))
        off = seq_offset(cut.seq, S)

        if cache is None:
            out = self._attend(q_nope, q_rope, ckv, k_rope, off, cd)
        else:
            _write(cache, {"ckv": own(ckv, -1, lat), "k_rope": k_rope},
                   cache_index, cut.latent)
            if cut.latent is None:
                out = self._attend(q_nope, q_rope,
                                   gather_cache(cache["ckv"], -1, lat),
                                   cache["k_rope"], cache_index + off, cd)
            elif cache_index == 0:
                dtype = cache["ckv"].dtype
                out = self._attend(q_nope, q_rope, ckv.to(dtype),
                                   k_rope.to(dtype), off, cd)
            else:        # every query against this rank's positions
                ax, n = cut.latent, cache["k_rope"].shape[1]
                out = own(self._attend(
                    gather_partial(q_nope, 1, cut.seq),
                    gather_partial(q_rope, 1, cut.seq),
                    gather_cache(cache["ckv"], -1, lat), cache["k_rope"],
                    cache_index - seq_offset(ax, n), cd, ax), 1, cut.seq)
        out = out.reshape(B, S, -1)
        return row_parallel(out, self.wo, tp).to(x.dtype), cache

    def _attend(self, q_nope, q_rope, ckv, k_rope, q_pos: int, cd,
                ax=None) -> torch.Tensor:
        """(B, S, H, v) attention of this rank's heads' queries, the
        first at position ``q_pos`` relative to the first latent, over
        the latents ``ckv`` (B, T, R) and ``k_rope`` (B, T, rope); with
        ``ax`` the latents are cut on T over it (``softmax_combine``)."""
        m = self.cfg.mla
        nope, rope = m.nope_head_dim, m.rope_head_dim
        tp = self.head_axes()
        B, S = q_nope.shape[:2]
        T = ckv.shape[1]
        mask = common.causal_mask(S, T, q_pos, device=ckv.device)
        # the latents expanded to per-head K_nope and V (not absorbed
        # into the queries: that form rounds differently)
        c = enter_tensor(ckv.to(cd), tp)
        k_nope = (c @ weight(self.wk_b, cd).flatten(1)).view(B, T, -1, nope)
        v = (c @ weight(self.wv_b, cd).flatten(1)).view(B, T, -1,
                                                        m.v_head_dim)
        kr = enter_tensor(k_rope.to(cd), tp)
        scale = _as((nope + rope) ** -0.5, cd)
        logits = (q_nope.to(cd).transpose(1, 2) @ k_nope.permute(0, 2, 3, 1)
                  + q_rope.to(cd).transpose(1, 2)
                  @ kr.transpose(1, 2)[:, None]) * scale
        logits = torch.where(mask, logits.float(), _MASKED)  # (B, H, S, T)
        return softmax_combine(logits, v.transpose(1, 2), ax,
                               cd).transpose(1, 2)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str,
                                                              torch.Tensor]:
    m = cfg.mla
    kw = dict(dtype=dtype, device=device)
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_len, m.rope_head_dim), **kw)}
