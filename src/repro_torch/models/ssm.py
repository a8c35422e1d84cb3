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
    # above the diagonal is positive and may overflow to inf; the mask
    # takes it out before it multiplies (inf·0 would be NaN)
    att = qc @ kc.transpose(-1, -2)                       # (B, N, H, t, s)
    decay = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    att = att * torch.where(mask, decay.exp(), 0.0).to(cd)
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
        N, P)}. Returns (out, cache)."""
        s, cfg = self.cfg.ssm, self.cfg
        cd = common.dt(cfg.compute_dtype)
        B, S, d = x.shape
        d_in = s.expand * d
        H = cfg.num_heads
        P = d_in // H
        N = s.state_dim

        z_xbc_dt = x.to(cd) @ self.in_proj.to(cd)
        z, xbc, dt = z_xbc_dt.split([d_in, d_in + 2 * N, H], dim=-1)
        xbc, new_conv = _causal_conv(xbc, self.conv_w.to(cd),
                                     self.conv_b.to(cd),
                                     None if cache is None else cache["conv"])
        xs, Bmat, Cmat = xbc.split([d_in, N, N], dim=-1)

        dt = F.softplus(dt.float() + self.dt_bias)         # (B, S, H)
        log_f = dt * -self.A_log.exp()                     # ≤ 0

        v = xs.reshape(B, S, H, P) * dt[..., None].to(cd)
        k = Bmat[:, :, None, :].expand(B, S, H, N).to(cd)
        q = Cmat[:, :, None, :].expand(B, S, H, N).to(cd)

        if S == 1 and cache is not None:
            out, new_state = gla_step(cache["state"], q[:, 0], k[:, 0],
                                      v[:, 0], log_f[:, 0])
            out = out[:, None]
        else:
            out, new_state = chunked_gla(
                q, k, v, log_f, s.chunk,
                None if cache is None else cache["state"])
        out = out + v * self.D.to(cd)[:, None]
        out = self.norm(out.reshape(B, S, d_in)) * F.silu(z)
        out = (out @ self.out_proj.to(cd)).to(x.dtype)
        return out, _update(cache, {"conv": new_conv, "state": new_state})


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
        H, Dh, Dh + 1)}. Returns (out, cache)."""
        s, cfg = self.cfg.ssm, self.cfg
        cd = common.dt(cfg.compute_dtype)
        B, S, d = x.shape
        d_in = s.expand * d
        H = cfg.num_heads
        Dh = d_in // H

        h_in, gate = (x.to(cd) @ self.up_proj.to(cd)).chunk(2, dim=-1)
        h_conv, new_conv = _causal_conv(h_in, self.conv_w.to(cd),
                                        self.conv_b.to(cd),
                                        None if cache is None
                                        else cache["conv"])
        qkv = (h_conv @ self.wqkv.to(cd).flatten(1)).view(B, S, 3, H, Dh)
        q, k, v = qkv.unbind(2)
        k = k / _as(math.sqrt(Dh), cd)

        if_gates = (h_conv @ self.wif.to(cd)).float() + self.if_bias
        i_gate, f_gate = if_gates.chunk(2, dim=-1)            # (B, S, H)
        log_f = -F.softplus(-f_gate)                          # log σ(f)
        # the exponential input gate folded into k; the normalizer is an
        # extra column of ones in v
        k_eff = k * i_gate.clamp(max=8.0).exp()[..., None].to(cd)
        v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)

        if S == 1 and cache is not None:
            out_aug, new_state = gla_step(cache["state"], q[:, 0],
                                          k_eff[:, 0], v_aug[:, 0],
                                          log_f[:, 0])
            out_aug = out_aug[:, None]
        else:
            out_aug, new_state = chunked_gla(
                q, k_eff, v_aug, log_f, s.chunk,
                None if cache is None else cache["state"])
        out, n = out_aug[..., :Dh], out_aug[..., Dh:]
        out = out / n.abs().clamp(min=1.0)
        out = self.norm(out.reshape(B, S, d_in)) * F.silu(gate)
        out = (out @ self.down_proj.to(cd)).to(x.dtype)
        return out, _update(cache, {"conv": new_conv, "state": new_state})


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
        float32. Returns (out, cache)."""
        cd = common.dt(self.cfg.compute_dtype)
        B, S, d = x.shape
        H = self.cfg.num_heads
        Dh = d // H
        zx = (x.to(cd) @ self.w_in.to(cd).flatten(1)).view(B, S, 4, H, Dh)
        st = cache if cache is not None else init_slstm_cache(
            self.cfg, B, device=x.device)
        c, n, h, m = st["c"], st["n"], st["h"], st["m"]
        r = self.r.to(cd).flatten(2)                        # (H, Dh, 4·Dh)
        hs = []
        for t in range(S):
            rec = (h.to(cd).transpose(0, 1) @ r).view(H, B, 4, Dh)
            pre = (zx[:, t] + rec.permute(1, 2, 0, 3)).float() + self.bias
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
        out = self.norm(torch.stack(hs, dim=1).reshape(B, S, d))
        out = (out @ self.out_proj.to(cd)).to(x.dtype)
        return out, _update(cache, {"c": c, "n": n, "h": h, "m": m})


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> Cache:
    shape = (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    return {name: torch.zeros(shape, dtype=torch.float32, device=device)
            for name in ("c", "n", "h", "m")}
