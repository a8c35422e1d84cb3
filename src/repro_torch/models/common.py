"""Shared model primitives: norms, RoPE/M-RoPE, initializers, dtype policy.

Port of the JAX package's ``models/common.py``. Parameters live in
``nn.Module``s at ``param_dtype`` and are cast at use; the functions here
are the pure pieces the modules call. Every dtype is pinned: norms and
rotary embeddings compute in float32 and cast back to the input's dtype.
Random initialisation draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from repro_torch.runtime.mesh_ctx import (enter_tensor, own_slice,
                                          reduce_shared)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def dense_init(shape: Sequence[int], dtype: torch.dtype, in_axis=0, *,
               generator: torch.Generator, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal truncated to ±2,
    times σ = 1/√fan_in (fan_in: the size of ``in_axis``, or the product
    of the sizes of a tuple of axes), drawn in float32."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else \
        math.prod(shape[a] for a in in_axis)
    std = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    if w.is_meta:                      # shapes only: nothing to draw
        return w.to(dtype)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * std).to(dtype)


def embed_init(vocab: int, d: int, dtype: torch.dtype, *,
               generator: torch.Generator, device=None) -> torch.Tensor:
    """A normal table scaled by 1/√d, drawn in float32."""
    w = torch.randn((vocab, d), dtype=torch.float32, device=device,
                    generator=generator)
    return (w * (1.0 / math.sqrt(d))).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(orig)


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, ax=None) -> torch.Tensor:
        """The norm of ``x``; with ``ax`` (a model axis that cuts the
        normed width) ``x`` is this rank's slice of it: the float32 sum
        of squares is summed over ``ax`` forward and backward
        (``reduce_shared``), and the whole scale, replicated, enters
        through ``enter_tensor`` before this rank reads its slice."""
        if ax is None:
            return rmsnorm(self.scale, x, self.eps)
        xf = x.float()
        ss = reduce_shared((xf * xf).sum(-1, keepdim=True), ax)
        xf = xf * torch.rsqrt(ss / (x.shape[-1] * ax.size) + self.eps)
        scale = own_slice(enter_tensor(self.scale, ax), 0, ax)
        return (xf * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the two halves of x (B, S, H, D) by angles (B, S, D/2)."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 500000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int],
                theta: float = 1000000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. positions3: (3, B, S), the temporal,
    height and width position streams (equal for pure text). The head
    dim's frequency bands are split into ``sections`` (t, h, w), each
    rotated by its own position stream."""
    d = x.shape[-1]
    half = d // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to half "
                         f"the head dim {d}")
    freqs = rope_freqs(d, theta, device=x.device)             # (half,)
    sec_id = torch.repeat_interleave(                         # (half,)
        torch.arange(3, device=x.device),
        torch.tensor(sections, device=x.device), output_size=half)
    pos_f = positions3.float()[sec_id]                        # (half, B, S)
    return _rotate(x, pos_f.permute(1, 2, 0) * freqs)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def causal_mask(q_len: int, kv_len: int, q_offset: int = 0,
                device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; q_offset = absolute position of query 0."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    return q_pos >= kv_pos


def positions_for(B: int, S: int, offset: int = 0,
                  device=None) -> torch.Tensor:
    """(B, S) int32 positions offset + 0..S-1."""
    base = torch.arange(S, dtype=torch.int32, device=device) + offset
    return base[None].expand(B, S)
