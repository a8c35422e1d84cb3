"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM).

Port of the JAX package's ``models/ssm.py``. Mamba2's SSD and xLSTM's
mLSTM are both gated linear attention with a scalar forget gate a head,
so they share one chunkwise-parallel core::

    state_t = a_t · state_{t-1} + k_t v_tᵀ          (a_t = exp(log_f_t))
    out_t   = q_tᵀ · state_t

``chunked_gla`` evaluates it with O(S·L) work (L the chunk): masked
attention inside a chunk, and the state carried across chunks by a
Python loop where the reference scans. ``gla_step`` is the O(1) form a
decode step uses. sLSTM (scalar memory) is a loop over time.

Dtypes are pinned as the reference's: the chunk state is carried at the
compute dtype and returned at the cache's; ``A_log``, ``D``,
``dt_bias``, ``if_bias`` and sLSTM's ``bias`` are float32 whatever
``param_dtype`` is, and so are the gates and sLSTM's c/n/h/m state.

A block takes and returns its cache, as attention does, and writes it
in place. A conv cache is held at the compute dtype: the reference's is
bfloat16 only until its first step, which returns it at the compute
dtype (``_causal_conv`` concatenates at the input's dtype).

On a mesh (``runtime.shard``) a block holds the reference's rules'
slices and runs on its share of the heads (``runtime.mesh_ctx``):

  * Mamba2: ``in_proj``, the conv and ``out_proj`` each follow their
    own cut (the rules cut F = 2·d_in + 2N + H, C = d_in + 2N and d_in
    where the model axis divides each), and every rank holds z | xBC |
    dt and the conv's output whole (``gather_tensor`` of a column cut),
    reading each in the share its layer's cut gives (``share``, whose
    backward sums the ranks' gradients). The depthwise conv runs on the
    channels of this rank's ``conv_w`` slice (and ``conv`` cache slice).
    The SSD core runs as the ``state`` cache is cut: on H/t heads (x,
    dt, ``A_log``, ``D``, ``dt_bias`` sliced, B and C whole); or, where
    the model axis does not divide the heads but divides N, on every
    head and this rank's N-slice of B and C, the output a partial sum
    over N summed over the model axis before the ``D`` skip term, which
    is added once; or whole. The d_in norm sums its squares over the
    model axis and ``out_proj`` is row-parallel where ``out_proj`` is
    cut, and both run whole where it is not;
  * mLSTM: ``up_proj``'s output is gathered whole the same way; the
    conv runs on this rank's d_in channels, then ``wqkv`` and ``wif``
    (cut on their input dim d_in) are row-parallel, which gives whole
    q/k/v and gates. The core runs as the ``state`` cache is cut: on
    this rank's heads (H cut), or on its slice of Dk (q·state and q·k
    are partial sums over Dk, the output is summed over the model axis;
    the state update k[Dk] ⊗ v is local), or whole where the rules
    leave the state whole; then the d_in norm and a row-parallel
    ``down_proj``;
  * sLSTM: with its heads cut (``w_in`` and the block-diagonal ``r``) a
    head-parallel recurrence with no collective inside the time loop;
    with ``w_in``/``r`` replicated (H that the model axis does not
    divide) the whole recurrence on every rank. The c/n/h/m caches are
    whole over the model axis: a head-parallel run reads its heads and
    writes back the whole state, gathered once after the loop. Then the
    norm (over the cut d when the heads are cut) and a row-parallel
    ``out_proj``.

A replicated vector that a rank reads only in its heads (``A_log``,
``D``, ``dt_bias``, ``if_bias``, sLSTM's ``bias``, the norm scales)
enters through ``enter_tensor``, so its gradient is the sum of the
ranks'.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import _as
from repro_torch.models.common import RMSNorm, dense_init
from repro_torch.runtime.mesh_ctx import (enter_tensor, gather_cache,
                                          gather_partial, gather_tensor, own,
                                          reduce_tensor, row_parallel, share,
                                          tensor_axes, weight)
from repro_torch.runtime.sharding import spec_for_cache_leaf

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Chunkwise gated-linear-attention core
# ---------------------------------------------------------------------------

def chunked_gla(q, k, v, log_f, chunk: int, state0=None):
    """q, k: (B, S, H, Dk); v: (B, S, H, Dv); log_f: (B, S, H) (≤ 0).
    Returns (out (B, S, H, Dv), final state (B, H, Dk, Dv))."""
    B, S, H, Dk = q.shape
    Dv = v.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {L}")
    N = S // L
    cd = q.dtype

    # (B, N, H, L, ·): a chunk's positions on the second-last axis
    qc = q.reshape(B, N, L, H, Dk).transpose(2, 3)
    kc = k.reshape(B, N, L, H, Dk).transpose(2, 3)
    vc = v.reshape(B, N, L, H, Dv).transpose(2, 3)
    cum = log_f.reshape(B, N, L, H).float().cumsum(2).transpose(2, 3)
    total = cum[..., -1]                                  # (B, N, H)

    # inside a chunk: (q_t·k_s) · exp(cum_t − cum_s) for s ≤ t. The decay
    # above the diagonal is positive and overflows to inf once a chunk's
    # gates sum below −88.7 (zamba2's 256 positions at dt ~0.7): it is
    # masked to −inf before the exp, so that neither the product (inf·0)
    # nor exp's backward (0·inf, where the reference's gradient is NaN)
    # meets it; the values are the reference's
    att = qc @ kc.transpose(-1, -2)                       # (B, N, H, t, s)
    decay = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    att = att * decay.masked_fill(~mask, -math.inf).exp().to(cd)
    out = att @ vc                                        # (B, N, H, L, Dv)

    # across chunks: the q side decays by exp(cum_t), the k side by
    # exp(total − cum_s)
    q_dec = qc * cum.exp()[..., None].to(cd)
    k_dec = kc * (total[..., None] - cum).exp()[..., None].to(cd)
    chunk_kv = k_dec.transpose(-1, -2) @ vc               # (B, N, H, Dk, Dv)
    a = total.exp().to(cd)[..., None, None]               # (B, N, H, 1, 1)

    state_dtype = cd if state0 is None else state0.dtype
    state = (torch.zeros((B, H, Dk, Dv), dtype=cd, device=q.device)
             if state0 is None else state0.to(cd))
    inter = torch.empty_like(out)
    for n in range(N):
        inter[:, n] = q_dec[:, n] @ state
        state = state * a[:, n] + chunk_kv[:, n]
    out = (out + inter).transpose(2, 3).reshape(B, S, H, Dv)
    return out, state.to(state_dtype)


def gla_step(state, q, k, v, log_f):
    """O(1) decode step. q, k: (B, H, Dk); v: (B, H, Dv); log_f: (B, H).
    Returns (out (B, H, Dv), new state at the state's dtype)."""
    a = log_f.float().exp()[..., None, None].to(q.dtype)
    new_state = state.to(q.dtype) * a + k[..., :, None] * v[..., None, :]
    out = (q[..., None, :] @ new_state)[..., 0, :]
    return out, new_state.to(state.dtype)


def _causal_conv(x, w, b, cache=None):
    """Depthwise causal conv1d of kernel K. x: (B, S, C); w: (K, C); b:
    (C,). With a cache ((B, K − 1, C) of trailing context) also returns
    the updated one, at x's dtype."""
    K, S = w.shape[0], x.shape[1]
    if cache is not None:
        xx = torch.cat([cache.to(x.dtype), x], dim=1)
        new_cache = xx[:, -(K - 1):] if K > 1 else cache
    else:
        xx = F.pad(x, (0, 0, K - 1, 0))
        new_cache = None
    out = xx[:, :S] * w[0]
    for i in range(1, K):
        out = out + xx[:, i:i + S] * w[i]
    return F.silu(out + b), new_cache


def _update(cache: Optional[Cache], new: Cache) -> Optional[Cache]:
    """Copy a step's new state into the caller's cache, in place."""
    if cache is not None:
        for name, t in new.items():
            cache[name].copy_(t)
    return cache


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

class Mamba2(nn.Module):
    #: the model axis of the mesh the block is laid out on (set by
    #: ``runtime.shard.shard_model``; None off a mesh)
    model_axis = None

    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        s = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d                    # inner width
        H = cfg.num_heads                      # SSD heads
        N = s.state_dim
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        conv_ch = d_in + 2 * N                 # x, B and C get the conv
        self.in_proj = nn.Parameter(dense_init((d, 2 * d_in + 2 * N + H),
                                               dtype, **kw))
        self.conv_w = nn.Parameter(dense_init((s.conv_dim, conv_ch), dtype,
                                              **kw))
        self.conv_b = nn.Parameter(torch.zeros(conv_ch, dtype=dtype,
                                               device=device))
        self.A_log = nn.Parameter(torch.full((H,), math.log(0.5), **f32))
        self.D = nn.Parameter(torch.ones(H, **f32))
        self.dt_bias = nn.Parameter(torch.zeros(H, **f32))
        self.norm = RMSNorm(d_in, dtype, cfg.norm_eps, device)
        self.out_proj = nn.Parameter(dense_init((d_in, d), dtype, **kw))

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None):
        """x: (B, S, d). cache: {"conv": (B, K − 1, C), "state": (B, H,
        N, P)} (on a mesh this rank's slices: C/t channels where the
        model axis divides C, and H/t heads or N/t of N as
        ``mamba2_state_cut`` says). Returns (out, cache)."""
        s, cfg = self.cfg.ssm, self.cfg
        cd = common.dt(cfg.compute_dtype)
        B, S, d = x.shape
        d_in = s.expand * d
        H = cfg.num_heads
        P = d_in // H
        N = s.state_dim
        t_in, t_conv, t_out = (tensor_axes(p) for p in (
            self.in_proj, self.conv_w, self.out_proj))
        heads, n_cut = mamba2_state_cut(cfg, self.model_axis)
        Hl = H if heads is None else H // heads.size

        xc = enter_tensor(x.to(cd), t_in)
        z_xbc_dt = gather_tensor(xc @ weight(self.in_proj, cd), -1, t_in)
        z, xbc, dt = z_xbc_dt.split([d_in, d_in + 2 * N, H], dim=-1)
        xbc, new_conv = _causal_conv(share(xbc, -1, t_conv),
                                     self.conv_w.to(cd), self.conv_b.to(cd),
                                     None if cache is None else cache["conv"])
        xs, Bmat, Cmat = gather_tensor(xbc, -1, t_conv).split([d_in, N, N],
                                                              dim=-1)
        # this rank's heads (each reads the whole B and C), or its N-slice
        # of B and C (every head)
        xs, dt = share(xs, -1, heads), share(dt, -1, heads)
        Bmat, Cmat = (share(enter_tensor(m, heads), -1, n_cut)
                      for m in (Bmat, Cmat))
        dt_bias, A_log, D = (share(p, 0, heads)
                             for p in (self.dt_bias, self.A_log, self.D))
        dt = F.softplus(dt.float() + dt_bias)              # (B, S, Hl)
        log_f = dt * -A_log.exp()                          # ≤ 0

        v = xs.reshape(B, S, Hl, P) * dt[..., None].to(cd)
        k = Bmat[:, :, None, :].expand(B, S, Hl, -1).to(cd)
        q = Cmat[:, :, None, :].expand(B, S, Hl, -1).to(cd)
        # on an N-slice each rank's output is a partial sum over N
        v_n, log_f = enter_tensor(v, n_cut), enter_tensor(log_f, n_cut)

        if S == 1 and cache is not None:
            out, new_state = gla_step(cache["state"], q[:, 0], k[:, 0],
                                      v_n[:, 0], log_f[:, 0])
            out = out[:, None]
        else:
            out, new_state = chunked_gla(
                q, k, v_n, log_f, s.chunk,
                None if cache is None else cache["state"])
        out = reduce_tensor(out, n_cut) + v * D.to(cd)[:, None]
        out = out.reshape(B, S, Hl * P)
        if heads is None:       # whole: this rank's share of out_proj's rows
            out = share(out, -1, t_out)
        out = self.norm(out, t_out) * F.silu(share(z, -1, t_out))
        out = row_parallel(out, self.out_proj, t_out).to(x.dtype)
        return out, _update(cache, {"conv": new_conv, "state": new_state})


def mamba2_state_cut(cfg: ModelConfig, ax):
    """(heads, n): the model axis ``ax`` where the rules cut Mamba2's
    ``state`` cache (B, H, N, P) on its heads, and where they cut it on N
    (``runtime.sharding.spec_for_cache_leaf``: H where ``ax`` divides it,
    else N where it divides that); None for each they leave whole, and
    both off a mesh."""
    if ax is None:
        return None, None
    H, N = cfg.num_heads, cfg.ssm.state_dim
    spec = spec_for_cache_leaf("state", (1, H, N, 1), {"model": ax.size})
    return (ax if spec[1] else None), (ax if spec[2] else None)


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                      device=None) -> Cache:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = cfg.num_heads
    return {
        "conv": torch.zeros((batch, s.conv_dim - 1, d_in + 2 * s.state_dim),
                            dtype=common.dt(cfg.compute_dtype),
                            device=device),
        "state": torch.zeros((batch, H, s.state_dim, d_in // H),
                             dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# xLSTM: the mLSTM block (matrix memory) and the sLSTM block (scalar memory)
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        s = cfg.ssm
        d = cfg.d_model
        d_in = s.expand * d
        H = cfg.num_heads
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        f32 = dict(dtype=torch.float32, device=device)
        self.up_proj = nn.Parameter(dense_init((d, 2 * d_in), dtype, **kw))
        self.conv_w = nn.Parameter(dense_init((s.conv_dim, d_in), dtype,
                                              **kw))
        self.conv_b = nn.Parameter(torch.zeros(d_in, dtype=dtype,
                                               device=device))
        self.wqkv = nn.Parameter(dense_init((d_in, 3, H, d_in // H), dtype,
                                            **kw))
        self.wif = nn.Parameter(dense_init((d_in, 2 * H), dtype, **kw))
        # input-gate bias 0, forget-gate bias 3..6
        self.if_bias = nn.Parameter(torch.cat([
            torch.zeros(H, **f32),
            3.0 + torch.arange(H, **f32) / max(H - 1, 1) * 3.0]))
        self.norm = RMSNorm(d_in, dtype, cfg.norm_eps, device)
        self.down_proj = nn.Parameter(dense_init((d_in, d), dtype, **kw))

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None):
        """x: (B, S, d). cache: {"conv": (B, K − 1, d_in), "state": (B,
        H, Dh, Dh + 1)} (on a mesh this rank's slices: d_in/t channels,
        the state cut as ``mlstm_state_cut`` says). Returns (out,
        cache)."""
        s, cfg = self.cfg.ssm, self.cfg
        cd = common.dt(cfg.compute_dtype)
        B, S, d = x.shape
        d_in = s.expand * d
        H = cfg.num_heads
        Dh = d_in // H
        tp = tensor_axes(self.down_proj)       # the d_in cut
        cut = mlstm_state_cut(cfg, tp)

        xc = enter_tensor(x.to(cd), tp)
        up = gather_partial(xc @ weight(self.up_proj, cd), -1, tp)
        h_in, gate = up.chunk(2, dim=-1)
        h_conv, new_conv = _causal_conv(own(h_in, -1, tp),
                                        self.conv_w.to(cd),
                                        self.conv_b.to(cd),
                                        None if cache is None
                                        else cache["conv"])
        qkv = row_parallel(h_conv, self.wqkv, tp, out_dims=3)
        if_gates = row_parallel(h_conv, self.wif, tp).float() + self.if_bias
        heads = tp if cut == "heads" else None
        if cut in ("heads", "dk"):   # each rank reads its part of them
            qkv, if_gates = enter_tensor(qkv, tp), enter_tensor(if_gates, tp)
        q, k, v = own(qkv.view(B, S, 3, H, Dh), 3, heads).unbind(2)
        k = k / _as(math.sqrt(Dh), cd)

        i_gate, f_gate = (own(g, -1, heads)                   # (B, S, H)
                          for g in if_gates.chunk(2, dim=-1))
        log_f = -F.softplus(-f_gate)                          # log σ(f)
        # the exponential input gate folded into k; the normalizer is an
        # extra column of ones in v
        k_eff = k * i_gate.clamp(max=8.0).exp()[..., None].to(cd)
        v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
        dk = tp if cut == "dk" else None
        q, k_eff = own(q, -1, dk), own(k_eff, -1, dk)

        if S == 1 and cache is not None:
            out_aug, new_state = gla_step(cache["state"], q[:, 0],
                                          k_eff[:, 0], v_aug[:, 0],
                                          log_f[:, 0])
            out_aug = out_aug[:, None]
        else:
            out_aug, new_state = chunked_gla(
                q, k_eff, v_aug, log_f, s.chunk,
                None if cache is None else cache["state"])
        # a Dk slice's output is a partial sum over Dk
        out_aug = reduce_tensor(out_aug, dk)
        out, n = out_aug[..., :Dh], out_aug[..., Dh:]
        out = (out / n.abs().clamp(min=1.0)).reshape(B, S, -1)
        if tp is not None and cut != "heads":   # whole: keep this rank's
            out = own(enter_tensor(out, tp), -1, tp)
        out = self.norm(out, tp) * F.silu(own(gate, -1, tp))
        out = row_parallel(out, self.down_proj, tp).to(x.dtype)
        return out, _update(cache, {"conv": new_conv, "state": new_state})


def mlstm_state_cut(cfg: ModelConfig, tp) -> Optional[str]:
    """How the rules cut the mLSTM's ``state`` cache (B, H, Dh, Dh + 1)
    over the model axis ``tp`` (``runtime.sharding.spec_for_cache_leaf``):
    ``"heads"`` where it divides H, else ``"dk"`` where it divides Dh,
    else None (whole), as off a mesh."""
    if tp is None:
        return None
    H = cfg.num_heads
    Dh = cfg.ssm.expand * cfg.d_model // H
    return "heads" if H % tp.size == 0 else (
        "dk" if Dh % tp.size == 0 else None)


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                     device=None) -> Cache:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    Dh = d_in // cfg.num_heads
    return {
        "conv": torch.zeros((batch, s.conv_dim - 1, d_in),
                            dtype=common.dt(cfg.compute_dtype),
                            device=device),
        "state": torch.zeros((batch, cfg.num_heads, Dh, Dh + 1),
                             dtype=dtype, device=device),
    }


class SLSTM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        H = cfg.num_heads
        Dh = d // H
        dtype = common.dt(cfg.param_dtype)
        kw = dict(generator=generator, device=device)
        self.w_in = nn.Parameter(dense_init((d, 4, H, Dh), dtype, **kw))
        # recurrent weights, block-diagonal a head (the xLSTM design)
        self.r = nn.Parameter(dense_init((H, Dh, 4, Dh), dtype, 1, **kw))
        self.bias = nn.Parameter(torch.zeros((4, H, Dh), dtype=torch.float32,
                                             device=device))
        self.norm = RMSNorm(d, dtype, cfg.norm_eps, device)
        self.out_proj = nn.Parameter(dense_init((d, d), dtype, **kw))

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None):
        """A loop over time. cache: {"c", "n", "h", "m"}, each (B, H, Dh)
        float32 (on a mesh whole over the model axis). Returns (out,
        cache)."""
        cd = common.dt(self.cfg.compute_dtype)
        B, S, d = x.shape
        H = self.cfg.num_heads
        Dh = d // H
        tp = tensor_axes(self.w_in)            # the heads' cut, if any
        tp_out = tensor_axes(self.out_proj)
        Hl = H if tp is None else H // tp.size
        xc = enter_tensor(x.to(cd), tp)
        zx = (xc @ weight(self.w_in, cd).flatten(1)).view(B, S, 4, Hl, Dh)
        st = cache if cache is not None else init_slstm_cache(
            self.cfg, B, device=x.device)
        c, n, h, m = (own(st[k], 1, tp) for k in ("c", "n", "h", "m"))
        r = self.r.to(cd).flatten(2)                        # (H, Dh, 4·Dh)
        bias = own(enter_tensor(self.bias, tp), 1, tp)
        hs = []
        for t in range(S):
            rec = (h.to(cd).transpose(0, 1) @ r).view(Hl, B, 4, Dh)
            pre = (zx[:, t] + rec.permute(1, 2, 0, 3)).float() + bias
            z_t = torch.tanh(pre[:, 0])
            i_t = pre[:, 1]
            o_t = torch.sigmoid(pre[:, 3])
            # stabilized exponential gating (xLSTM eq. 15-17)
            log_f = -F.softplus(-pre[:, 2])
            m_new = torch.maximum(log_f + m, i_t)
            i_e = torch.exp(i_t - m_new)
            f_e = torch.exp(log_f + m - m_new)
            c = f_e * c + i_e * z_t
            n = f_e * n + i_e
            h = o_t * c / n.clamp(min=1.0)
            m = m_new
            hs.append(h.to(cd))
        out = self.norm(torch.stack(hs, dim=1).reshape(B, S, Hl * Dh), tp)
        if tp is None and tp_out is not None:   # whole: keep this rank's
            out = own(enter_tensor(out, tp_out), -1, tp_out)
        out = row_parallel(out, self.out_proj, tp_out).to(x.dtype)
        if cache is None:
            return out, None
        return out, _update(cache, {k: gather_cache(v, 1, tp) for k, v in
                                    (("c", c), ("n", n), ("h", h),
                                     ("m", m))})


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> Cache:
    shape = (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("c", "n", "h", "m")}
