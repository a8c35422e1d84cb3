"""Mixture-of-Experts FFN: top-k routing with capacity-based scatter
dispatch.

Port of the JAX package's ``models/moe.py`` (``_capacity``, ``init_moe``,
``moe_ffn``, ``router_aux_loss``), its algorithm exactly: a float32
router, softmax, then top-k with renormalisation; each assignment's
position in its expert's buffer by a one-hot cumsum (integer work, no
products); assignments past the capacity dropped; a scatter-add into
(E, C, d) buffers; the SwiGLU batched over all E experts; a gather, then
the weighted sum over the token's k experts; the shared experts and the
dense residual FFN added. Every expert's weights are multiplied at every
step, whichever experts the tokens chose, as in the reference.

Covers DeepSeek-V2 (160 routed top-6 + 2 shared experts) and Arctic (128
routed top-2 + a parallel dense residual FFN). The reference's sharding
constraints (``constrain`` in its ``moe_ffn``) wait for the MoE's sharded
slice: ``runtime.shard.shard_model`` refuses the family on a mesh.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.models.ffn import MLP


def _capacity(tokens: int, m: MoEConfig) -> int:
    c = int(tokens * m.top_k / m.num_experts * m.capacity_factor) + 1
    return max(8, ((c + 7) // 8) * 8)          # lane-align


def _expert_init(shape, dtype: torch.dtype, in_axis: int, *,
                 generator: torch.Generator, device=None) -> torch.Tensor:
    """``dense_init`` of an (E, ·, ·) expert tensor (fan-in on
    ``in_axis``), drawn one expert at a time from the same distribution:
    a float32 draw of arctic's whole (128, 7168, 4864) tensor would take
    17.9 GB, and its scaling as much again."""
    w = torch.empty(tuple(shape), dtype=dtype, device=device)
    for e in range(shape[0]):
        w[e] = dense_init(shape[1:], dtype, in_axis - 1,
                          generator=generator, device=device)
    return w


class MoE(nn.Module):
    """The routed experts (``experts``: ``gate``/``up`` (E, d, f),
    ``down`` (E, f, d), at ``param_dtype``), a float32 ``router`` (d, E),
    and the optional ``shared`` and ``dense_residual`` MLPs.
    ``last_dropped`` is the number of assignments the last call dropped
    for want of capacity (a 0-dim tensor on the device, so that reading
    it is the caller's sync)."""

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d, E, f = cfg.d_model, m.num_experts, m.expert_d_ff
        dtype = common.dt(cfg.param_dtype)
        cd = common.dt(cfg.compute_dtype)
        kw = dict(generator=generator, device=device)
        self.router = nn.Parameter(dense_init((d, E), torch.float32, **kw))
        self.experts = nn.ParameterDict({
            "gate": _expert_init((E, d, f), dtype, 1, **kw),
            "up": _expert_init((E, d, f), dtype, 1, **kw),
            "down": _expert_init((E, f, d), dtype, 1, **kw)})
        self.shared = MLP(d, f * m.shared_experts, dtype, cd, **kw) \
            if m.shared_experts else None
        self.dense_residual = MLP(d, m.dense_residual_d_ff, dtype, cd, **kw) \
            if m.dense_residual_d_ff else None
        self.last_dropped: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, S, d) → (B, S, d) at x's dtype."""
        m = self.cfg.moe
        cd = common.dt(self.cfg.compute_dtype)
        B, S, d = x.shape
        T, k, E = B * S, m.top_k, m.num_experts
        xf = x.reshape(T, d)

        # routing (a float32 router, the production default)
        probs = torch.softmax(xf.float() @ self.router, dim=-1)
        top_p, top_e = probs.topk(k, dim=-1)                  # (T, k)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

        # each assignment's slot in its expert's buffer: a one-hot cumsum
        C = _capacity(T, m)
        e_flat = top_e.reshape(-1)                            # (T·k,)
        pos = F.one_hot(e_flat, E).cumsum(0) - 1              # (T·k, E)
        pos_flat = pos.gather(1, e_flat[:, None])[:, 0]
        keep = pos_flat < C                                   # overflow drops
        p_clip = pos_flat.clamp(0, C - 1)
        self.last_dropped = (~keep).sum()

        # dispatch: scatter-add the tokens into (E, C, d) buffers (a
        # dropped assignment adds zeros to its expert's last slot)
        x_rep = xf.repeat_interleave(k, dim=0).to(cd) * keep[:, None].to(cd)
        buf = torch.zeros((E, C, d), dtype=cd, device=x.device)
        buf.index_put_((e_flat, p_clip), x_rep, accumulate=True)

        # the SwiGLU, batched over all E experts
        ex = self.experts
        h = torch.bmm(buf, ex["gate"].to(cd))
        u = torch.bmm(buf, ex["up"].to(cd))
        y = torch.bmm(F.silu(h) * u, ex["down"].to(cd))

        # combine: gather, then the weighted sum over the token's k experts
        w = (top_p.reshape(-1).to(cd) * keep.to(cd))[:, None]
        out = (y[e_flat, p_clip] * w).reshape(T, k, d).sum(dim=1)
        out = out.reshape(B, S, d).to(x.dtype)

        if self.shared is not None:
            out = out + self.shared(x)
        if self.dense_residual is not None:
            out = out + self.dense_residual(x)
        return out


def router_aux_loss(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E[f_e · p_e] · E."""
    E = moe.cfg.moe.num_experts
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ moe.router,
                          dim=-1)
    frac = F.one_hot(probs.argmax(-1), E).float().mean(0)
    return (frac * probs.mean(0)).sum() * E
