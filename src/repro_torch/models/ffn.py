"""Feed-forward blocks: the SwiGLU MLP (also the MoE's shared experts
and Arctic's dense residual).

Port of the JAX package's ``models/ffn.py`` (``init_mlp`` and ``mlp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init


class MLP(nn.Module):
    """SwiGLU: down(silu(x·gate) ⊙ (x·up)), the products at
    ``compute_dtype``, the output at the input's dtype."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 compute_dtype: torch.dtype, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        kw = dict(generator=generator, device=device)
        self.gate = nn.Parameter(dense_init((d_model, d_ff), dtype, **kw))
        self.up = nn.Parameter(dense_init((d_model, d_ff), dtype, **kw))
        self.down = nn.Parameter(dense_init((d_ff, d_model), dtype, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        xc = x.to(cd)
        h = F.silu(xc @ self.gate.to(cd)) * (xc @ self.up.to(cd))
        return (h @ self.down.to(cd)).to(x.dtype)
