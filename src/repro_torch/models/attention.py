"""Attention: GQA/MHA with QKV bias and RoPE or M-RoPE, with a KV cache.

Port of the JAX package's ``models/attention.py`` (``init_gqa``,
``_sdpa``, ``gqa_attention``, ``init_gqa_cache``). MLA and
cross-attention wait for the MoE and encoder-decoder slices.

A GQA cache is ``{"k", "v"}`` of (B, S_max, Hkv, Dh), written in place at
``cache_index``; attention then runs over the whole buffer with the causal
mask, as the reference does. Dtypes follow the reference: the products at
the compute dtype, logits and softmax in float32, probabilities cast back
to the compute dtype before the product with V.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import apply_mrope, apply_rope, dense_init

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
    queries past ``_Q_CHUNK``."""
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    groups = H // Hkv
    cd = compute_dtype
    scale = _as(Dh ** -0.5, cd)

    if Sq == 1:
        qg = q.reshape(B, Hkv, groups, Dh).to(cd)
        logits = torch.matmul(qg, k.to(cd).permute(0, 2, 3, 1)) * scale
        logits = torch.where(mask, logits.float(), _MASKED)
        probs = torch.softmax(logits, dim=-1).to(cd)      # (B, Hkv, g, Skv)
        out = torch.matmul(probs, v.to(cd).transpose(1, 2))
        return out.reshape(B, Sq, H, Dh)

    if groups > 1:
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
    qh = q.to(cd).transpose(1, 2)                         # (B, H, Sq, Dh)
    kt = k.to(cd).permute(0, 2, 3, 1)                     # (B, H, Dh, Skv)
    vh = v.to(cd).transpose(1, 2)                         # (B, H, Skv, Dh)

    def att(q_blk, mask_blk):
        logits = torch.matmul(q_blk, kt) * scale
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
    (H·Dh, d), biases (H·Dh,) / (Hkv·Dh,) when ``qkv_bias``."""

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

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_index: int = 0):
        """x: (B, S, d) at the compute dtype; positions (B, S), or
        (3, B, S) for M-RoPE. With a cache, K/V are written at
        ``cache_index`` and the queries attend over the whole buffer.
        Returns (out, cache)."""
        cfg = self.cfg
        B, S, _ = x.shape
        H, Hkv, Dh = cfg.num_heads, cfg.kv_heads, cfg.resolved_head_dim
        q = x @ self.wq.to(x.dtype)
        k = x @ self.wk.to(x.dtype)
        v = x @ self.wv.to(x.dtype)
        if cfg.qkv_bias:
            q = q + self.bq.to(q.dtype)
            k = k + self.bk.to(k.dtype)
            v = v + self.bv.to(v.dtype)
        q, k, v = (q.view(B, S, H, Dh), k.view(B, S, Hkv, Dh),
                   v.view(B, S, Hkv, Dh))
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
            k = apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)

        offset = 0
        if cache is not None:
            # the start clamps into the buffer, as the reference's
            # dynamic_update_slice does; the mask keeps the true position
            at = max(0, min(cache_index, cache["k"].shape[1] - S))
            cache["k"][:, at:at + S] = k.to(cache["k"].dtype)
            cache["v"][:, at:at + S] = v.to(cache["v"].dtype)
            k, v = cache["k"], cache["v"]
            offset = cache_index
        mask = common.causal_mask(S, k.shape[1], offset, device=x.device)
        out = _sdpa(q, k, v, mask, common.dt(cfg.compute_dtype))
        out = out.reshape(B, S, H * Dh)
        return (out @ self.wo.to(out.dtype)).to(x.dtype), cache


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str,
                                                              torch.Tensor]:
    Dh = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.kv_heads, Dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
