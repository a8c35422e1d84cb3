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
routed top-2 + a parallel dense residual FFN).

On a mesh (``runtime.shard.shard_model``: the experts' E over the model
axis, their d over the FSDP axes, the router's d over the FSDP axes) the
layer keeps the reference's global semantics, which its ``jit`` gets from
seeing every token: the capacity is taken over the global token count,
and the slots number the assignments in global token order, b·S + s:
data-rank-major where the batch rows are cut in contiguous blocks, and
row-major, then rank-major within a row, where the batch axes cut the
sequence (a batch they do not divide; ``SeqCut``); a batch whole on
every rank is counted as it is. Each rank:

  * routes its own tokens, whole on every model rank (replicated
    compute, outside ``enter_tensor``: its input gradient is not summed
    over the model axis);
  * all-gathers its per-expert assignment counts (a row's, on a cut
    sequence) over the batch axes and offsets its one-hot cumsum by the
    counts of the assignments before its own, so that each slot,
    ``keep`` and the drop count are the one device's;
  * scatters its kept assignments to the experts it owns into an (E/t,
    C, d) buffer at their global slots (the other data ranks' rows stay
    zero; the SwiGLU is row-wise, so each row's product is the one
    device's), the input through ``enter_tensor`` and the expert leaves
    gathered over FSDP by ``weight``;
  * gathers the rows of its owned assignments (zeros for the others) and
    sums them over the model axis (``reduce_tensor``: one rank adds the
    one non-zero, so the sum is exact and its backward the identity),
    then takes the weighted sum over the k experts locally.

The reference's ``constrain`` call sites stay where they are (no-ops in
eager PyTorch, ``runtime.mesh_ctx``).
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
from repro_torch.runtime.mesh_ctx import (WHOLE, all_gather, constrain,
                                          current_cut, enter_tensor,
                                          reduce_tensor, tensor_axes, weight)


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
    it is the caller's sync), the global batch's on a mesh (the step's
    ``SeqCut`` says how the batch lies on the batch axes)."""

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
        """x: (B, S, d) → (B, S, d) at x's dtype (on a mesh, this rank's
        rows)."""
        m = self.cfg.moe
        cd = common.dt(self.cfg.compute_dtype)
        B, S, d = x.shape
        T, k, E = B * S, m.top_k, m.num_experts
        xf = constrain(x.reshape(T, d), "batch", None)

        # routing (a float32 router, the production default), whole on
        # every model rank
        logits = constrain(xf.float() @ weight(self.router, torch.float32),
                           "batch", None)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = probs.topk(k, dim=-1)                  # (T, k)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

        # each assignment's slot in its expert's buffer: a one-hot cumsum
        # in global token order, b·S + s
        e_flat = top_e.reshape(-1)                            # (T·k,)
        onehot = F.one_hot(e_flat, E)
        pos = onehot.cumsum(0) - 1                            # (T·k, E)
        counts = onehot.sum(0)                                # (E,)
        cut = current_cut() or WHOLE
        rows, seq = cut.rows, cut.seq
        if rows is not None and rows.size > 1:
            # rows cut: the earlier data ranks' counts first
            every = all_gather(counts[None], 0, rows)         # (ranks, E)
            pos = pos + every[:rows.index].sum(0)
            counts = every.sum(0)
            T *= rows.size
        elif seq is not None:
            # the sequence cut: within each row, the earlier ranks'
            # counts; before them, the earlier rows' on every rank
            rowwise = onehot.view(B, S * k, E)
            pos = rowwise.cumsum(1) - 1                       # (B, S·k, E)
            every = all_gather(rowwise.sum(1)[None], 0, seq)  # (ranks, B, E)
            per_row = every.sum(0)                            # (B, E)
            pos = pos + (per_row.cumsum(0) - per_row
                         + every[:seq.index].sum(0))[:, None]
            pos = pos.view(T * k, E)
            counts = per_row.sum(0)
            T *= seq.size
        C = _capacity(T, m)
        pos_flat = pos.gather(1, e_flat[:, None])[:, 0]
        keep = pos_flat < C                                   # overflow drops
        p_clip = pos_flat.clamp(0, C - 1)
        self.last_dropped = (counts - C).clamp_min(0).sum()

        # the experts this rank owns (all of them off the model axis)
        ex = self.experts
        tp = tensor_axes(ex["gate"])
        E_own = ex["gate"].shape[0]
        e_own = e_flat if tp is None else e_flat - tp.index * E_own
        own = (e_own >= 0) & (e_own < E_own)
        e_own = e_own.clamp(0, E_own - 1)

        # dispatch: scatter-add the tokens into (E/t, C, d) buffers (a
        # dropped assignment, or one of another rank's experts, adds
        # zeros)
        x_rep = enter_tensor(xf, tp).repeat_interleave(k, dim=0).to(cd)
        x_rep = constrain(x_rep * (keep & own)[:, None].to(cd), "batch",
                          None)
        buf = torch.zeros((E_own, C, d), dtype=cd, device=x.device)
        buf.index_put_((e_own, p_clip), x_rep, accumulate=True)
        buf = constrain(buf, "tensor", None, None)

        # the SwiGLU, batched over the owned experts
        h = torch.bmm(buf, weight(ex["gate"], cd))
        u = torch.bmm(buf, weight(ex["up"], cd))
        y = torch.bmm(F.silu(h) * u, weight(ex["down"], cd))
        y = constrain(y, "tensor", None, None)

        # combine: gather (each row from its expert's owner), then the
        # weighted sum over the token's k experts
        y_tok = y[e_own, p_clip]
        if tp is not None:
            y_tok = reduce_tensor(torch.where(
                own[:, None], y_tok, torch.zeros((), dtype=cd,
                                                 device=x.device)), tp)
        y_tok = constrain(y_tok, "batch", None)               # (T·k, d)
        w = (top_p.reshape(-1).to(cd) * keep.to(cd))[:, None]
        out = (y_tok * w).reshape(B * S, k, d).sum(dim=1)
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
