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
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import (RMSNorm, apply_mrope, apply_rope,
                                       dense_init)
from repro_torch.runtime.mesh_ctx import (NOT_YET, constrain, enter_tensor,
                                          gather_cache, own_slice,
                                          row_parallel, tensor_axes, weight)

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


class GQA(nn.Module):
    """Grouped-query self-attention of one block. Weights at
    ``param_dtype``: ``wq`` (d, H·Dh), ``wk``/``wv`` (d, Hkv·Dh), ``wo``
    (H·Dh, d), biases (H·Dh,) / (Hkv·Dh,) when ``qkv_bias``.

    On a mesh (``runtime.shard``) a rank holds the heads of its model
    coordinate, H/t query and Hkv/t KV heads (column-parallel ``wq``,
    ``wk``, ``wv`` and biases, row-parallel ``wo`` with an all-reduce),
    and its FSDP slice of d, gathered at use; the head counts are read
    off the local weights."""

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

    def local_kv_heads(self) -> int:
        """The KV heads this rank holds (all of them off a mesh)."""
        return self.wk.shape[1] // self.cfg.resolved_head_dim

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0,
                kv_source: Optional[torch.Tensor] = None,
                causal: bool = True):
        """x: (B, S, d) at the compute dtype; positions (B, S), or
        (3, B, S) for M-RoPE. With a cache, K/V are written at
        ``cache_index`` and the queries attend over the whole buffer.
        ``kv_source`` (cross-attention) gives K/V's input in place of x,
        and then neither q nor k is rotated; ``causal=False`` attends to
        every key. Returns (out, cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        Dh = cfg.resolved_head_dim
        tp = tensor_axes(self.wq)
        x = enter_tensor(x, tp)
        src = x if kv_source is None else enter_tensor(kv_source, tp)
        q = x @ weight(self.wq, x.dtype)
        k = src @ weight(self.wk, x.dtype)
        v = src @ weight(self.wv, x.dtype)
        if cfg.qkv_bias:
            q = q + self.bq.to(q.dtype)
            k = k + self.bk.to(k.dtype)
            v = v + self.bv.to(v.dtype)
        Skv = src.shape[1]
        q, k, v = (q.view(B, S, -1, Dh), k.view(B, Skv, -1, Dh),
                   v.view(B, Skv, -1, Dh))
        if kv_source is None:
            if cfg.mrope:
                q = apply_mrope(q, positions, cfg.mrope_sections,
                                cfg.rope_theta)
                k = apply_mrope(k, positions, cfg.mrope_sections,
                                cfg.rope_theta)
            else:
                q = apply_rope(q, positions, cfg.rope_theta)
                k = apply_rope(k, positions, cfg.rope_theta)

        offset = 0
        if cache is not None:
            _write(cache, {"k": k, "v": v}, cache_index)
            k, v = cache["k"], cache["v"]
            offset = cache_index
        kv_len = k.shape[1]
        mask = (common.causal_mask(S, kv_len, offset, device=x.device)
                if causal else
                torch.ones((S, kv_len), dtype=torch.bool, device=x.device))
        out = _sdpa(q, k, v, mask, common.dt(cfg.compute_dtype))
        out = out.reshape(B, S, -1)
        return row_parallel(out, self.wo, tp).to(x.dtype), cache


def _write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
           cache_index: int) -> None:
    """Write each (B, S, ...) entry of ``new`` into its (B, S_max, ...)
    buffer at ``cache_index``, at the buffer's dtype. The start clamps
    into the buffer, as the reference's dynamic_update_slice does; the
    caller's mask keeps the true position."""
    for name, t in new.items():
        buf = cache[name]
        S = t.shape[1]
        at = max(0, min(cache_index, buf.shape[1] - S))
        buf[:, at:at + S] = t.to(buf.dtype)


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
    gathered at use, and the norms run whole on every model rank; the
    up projections ``wq_b``, ``wk_b``, ``wv_b`` are column-parallel on
    the heads (each rank expands K_nope and V for its H/t heads from the
    whole latent, which enters through ``enter_tensor``), and ``wo`` is
    row-parallel. The latent cache ``ckv`` is cut on R over the model
    axis (``infer_cache_specs``): a rank writes its R-slice and gathers
    the whole buffer at each step; ``k_rope`` is whole."""

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

    def latent_axes(self):
        """The model axis that cuts the latent cache's R: the one that
        cuts the heads (None off a mesh or when they are whole)."""
        return tensor_axes(self.wk_b)

    def local_latent_rank(self) -> int:
        """The width of this rank's slice of the ``ckv`` cache."""
        R, tp = self.cfg.mla.kv_lora_rank, self.latent_axes()
        if tp is None:
            return R
        if R % tp.size:
            raise NotImplementedError(
                f"{self.cfg.name}: the latent rank {R} over a model axis "
                f"of {tp.size} ({NOT_YET})")
        return R // tp.size

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0):
        """x: (B, S, d) at the compute dtype; positions (B, S). With a
        cache, the latents are written at ``cache_index`` (rounded to the
        cache's dtype) and K/V are expanded from the whole buffer.
        Returns (out, cache)."""
        cfg, m = self.cfg, self.cfg.mla
        cd = common.dt(cfg.compute_dtype)
        B, S, _ = x.shape
        nope, rope = m.nope_head_dim, m.rope_head_dim
        tp = self.latent_axes()

        q_lat = self.q_norm(x @ weight(self.wq_a, x.dtype))
        q = enter_tensor(q_lat, tp) @ weight(self.wq_b, x.dtype).flatten(1)
        q = q.view(B, S, -1, nope + rope)                  # this rank's heads
        q_nope, q_rope = q.split([nope, rope], dim=-1)
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        ckv = self.kv_norm(x @ weight(self.wkv_a, x.dtype))
        k_rope = apply_rope((x @ weight(self.wk_rope, x.dtype))[:, :, None, :],
                            positions, cfg.rope_theta)[:, :, 0, :]

        offset = 0
        if cache is not None:
            mine = ckv if tp is None else own_slice(ckv, -1, tp)
            _write(cache, {"ckv": mine, "k_rope": k_rope}, cache_index)
            ckv = gather_cache(cache["ckv"], -1, tp)
            k_rope = cache["k_rope"]
            offset = cache_index
        T = ckv.shape[1]
        mask = common.causal_mask(S, T, offset, device=x.device)

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
        logits = torch.where(mask, logits.float(), _MASKED)
        probs = torch.softmax(logits, dim=-1).to(cd)      # (B, H, S, T)
        out = (probs @ v.transpose(1, 2)).transpose(1, 2)  # (B, S, H, v)
        out = out.reshape(B, S, -1)
        return row_parallel(out, self.wo, tp).to(x.dtype), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str,
                                                              torch.Tensor]:
    m = cfg.mla
    kw = dict(dtype=dtype, device=device)
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), **kw),
            "k_rope": torch.zeros((batch, max_len, m.rope_head_dim), **kw)}
