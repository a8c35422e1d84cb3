"""Feed-forward blocks: the SwiGLU MLP (also the MoE's shared experts
and Arctic's dense residual).

Port of the JAX package's ``models/ffn.py`` (``init_mlp`` and ``mlp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import dense_init
from repro_torch.runtime.mesh_ctx import (enter_tensor, row_parallel,
                                          tensor_axes, weight)


class MLP(nn.Module):
    """SwiGLU: down(silu(x·gate) ⊙ (x·up)), the products at
    ``compute_dtype``, the output at the input's dtype. On a mesh
    ``gate``/``up`` are column-parallel on F and ``down`` row-parallel
    with an all-reduce over the model axis (``runtime.mesh_ctx``)."""

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
        tp = tensor_axes(self.gate)
        xc = enter_tensor(x.to(cd), tp)
        h = F.silu(xc @ weight(self.gate, cd)) * (xc @ weight(self.up, cd))
        return row_parallel(h, self.down, tp).to(x.dtype)
