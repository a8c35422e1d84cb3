"""Plain PyTorch versions of every matcher kernel (the port's oracles).

Port of the JAX package's ``kernels/ref.py``. These functions are the
CPU execution path and the yardstick each hand-written CUDA kernel is
held against on the card.

Shapes follow the JAX oracles, with one generalisation: every function
takes any number of leading batch dimensions on its per-particle
arguments, and the graph arguments ``Q`` (…, n, n), ``G`` (…, m, m) and
``mask`` (…, n, m) broadcast against them. That is how the port writes
out JAX's ``vmap``.

Order of operations. A float sum whose result later feeds a discrete
decision (the PSO row normalisation before quantisation, the fitness
that decides the local and global bests) is taken left to right, one
term at a time, in the same order the CUDA kernels use. Kernel and plain
version then agree bit for bit on the card, and a one-ulp difference
can never flip an argmax between them. Integer products go through
float64 matrix products, which are exact for these 0/1 and uint8
operands (every partial sum stays far below 2**53) and, unlike integer
matrix products, run on the card too.
"""
from __future__ import annotations

import torch

EPS = 1e-9
NEG = torch.finfo(torch.float32).min


def strict_fp32(x: torch.Tensor) -> None:
    """Keep float32 products in full float32 on the card (no TF32)."""
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matrix product of small non-negative integer tensors
    (int64 result), through float64."""
    return torch.matmul(a.double(), b.double()).round().long()


def seq_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over ``dim`` strictly left to right (the kernels' order)."""
    x = x.movedim(dim, -1)
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    acc = x[..., 0].clone()
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def fdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE float32 division on every device.

    PyTorch's CUDA ``tensor / python_scalar`` multiplies by the
    reciprocal (one more rounding) and ``scalar / tensor`` is
    ``reciprocal(tensor) * scalar``; a 0-dim tensor on the same device
    keeps the true division the kernels and JAX use. It is filled on
    the device, so a CUDA ``x`` costs no host-to-device copy."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def _graph(Q: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Align a graph operand with the leading dims of ``S`` (…, n, m)."""
    return Q.expand(*S.shape[:-2], *Q.shape[-2:])


# ---------------------------------------------------------------------------
# 1. Edge-preserving fitness  -||Q - S G S^T||_F^2   (paper §3.3)
# ---------------------------------------------------------------------------

def edge_fitness(S: torch.Tensor, Q: torch.Tensor,
                 G: torch.Tensor) -> torch.Tensor:
    """Float path: fitness f = -||Q - S G Sᵀ||² over the last two dims.

    Every sum runs in ascending index order: SG[i, j] over k, SGS[i, u]
    over j, the squared residual over u within a row, then over rows.
    """
    S = S.float()
    Qf = Q.float()
    Gf = G.float()
    m = S.shape[-1]
    SG = S[..., :, 0:1] * Gf[..., 0:1, :]
    for k in range(1, m):
        SG = SG + S[..., :, k:k + 1] * Gf[..., k:k + 1, :]
    SGS = SG[..., :, None, 0] * S[..., None, :, 0]
    for j in range(1, m):
        SGS = SGS + SG[..., :, None, j] * S[..., None, :, j]
    resid = Qf - SGS
    return -seq_sum(seq_sum(resid * resid, -1), -1)


def edge_fitness_quantized(S_q: torch.Tensor, Q: torch.Tensor,
                           G: torch.Tensor, scale: int = 255) -> torch.Tensor:
    """Fixed-point path (paper §3.4): uint8 S_q ≈ S·scale, integer MACs.

    The squared residual is summed exactly in int64 (it stays below 2**63
    at any size this matcher runs) and converted to float32 once, so the
    CUDA kernel and this version agree bit for bit. The JAX oracle sums
    in float32; the two agree to float32 rounding.
    """
    SG = imatmul(S_q, G)
    SGS = imatmul(SG, S_q.transpose(-1, -2))
    resid = Q.long() * (scale * scale) - SGS
    return -(resid * resid).sum((-2, -1)).to(torch.float32)


# ---------------------------------------------------------------------------
# 2. Ullmann refinement and the global pre-prune
# ---------------------------------------------------------------------------

def ullmann_refine_step(M: torch.Tensor, Q: torch.Tensor,
                        G: torch.Tensor) -> torch.Tensor:
    """One Ullmann sweep: keep (i, j) iff every out-/in-neighbour u of i
    still has a candidate v adjacent to j in the same direction."""
    Mi = M.long()
    support_out = imatmul(Mi, G.transpose(-1, -2))
    support_in = imatmul(Mi, G)
    miss_out = (support_out == 0).long()
    miss_in = (support_in == 0).long()
    viol = imatmul(Q, miss_out) + imatmul(Q.transpose(-1, -2), miss_in)
    return (Mi * (viol == 0)).to(M.dtype)


def ullmann_refine_fixpoint(M: torch.Tensor, Q: torch.Tensor,
                            G: torch.Tensor, max_iters: int = 0):
    """Iterate the sweep to fixpoint (``max_iters`` > 0: exactly that many
    sweeps)."""
    if max_iters and max_iters > 0:
        for _ in range(max_iters):
            M = ullmann_refine_step(M, Q, G)
        return M
    while True:
        M2 = ullmann_refine_step(M, Q, G)
        if torch.equal(M2, M):
            return M2
        M = M2


def injectivity_prune(M: torch.Tensor) -> torch.Tensor:
    """All-different propagation: a singleton row claims its column."""
    Mi = M.long()
    singleton_rows = (Mi.sum(-1, keepdim=True) == 1).long()
    claimed = (singleton_rows * Mi).sum(-2, keepdim=True)
    keep = 1 - (claimed > 0).long() * (1 - singleton_rows * Mi)
    return (Mi * keep.clamp(0, 1)).to(M.dtype)


def prune_fixpoint_count(mask: torch.Tensor, Q: torch.Tensor,
                         G: torch.Tensor, max_iters: int = 0):
    """Fused pre-prune (refine sweep + injectivity) to fixpoint.

    Batched over a leading problem axis: ``mask`` (P, n, m), ``Q``
    (P, n, n), ``G`` (P, m, m). A problem stops counting once its mask
    stops changing or its sweep budget is spent (``max_iters`` > 0, else
    n·m + 1). Returns ``(pruned mask, sweeps (P,) int32)``.
    """
    P, n, m = mask.shape
    bound = max_iters if max_iters and max_iters > 0 else n * m + 1
    active = torch.ones(P, dtype=torch.bool, device=mask.device)
    sweeps = torch.zeros(P, dtype=torch.int32, device=mask.device)
    mk = mask
    while bool(active.any()):
        mk2 = injectivity_prune(ullmann_refine_step(mk, Q, G))
        changed = (mk2 != mk).flatten(1).any(1)
        mk = torch.where(active[:, None, None], mk2, mk)
        sweeps = sweeps + active.int()
        active = active & changed & (sweeps < bound)
    return mk, sweeps


def prune_mask_fixpoint(mask, Q, G, max_iters: int = 0):
    """Single-problem pre-prune, mask only."""
    out, _ = prune_fixpoint_count(mask[None], Q[None], G[None], max_iters)
    return out[0]


def is_feasible(M: torch.Tensor, Q: torch.Tensor,
                G: torch.Tensor) -> torch.Tensor:
    """M is a 0/1 injective assignment (one candidate per row) and
    M G Mᵀ covers Q. Batched over leading dims."""
    Mi = M.long()
    rows_ok = (Mi.sum(-1) == 1).all(-1)
    cols_ok = (Mi.sum(-2) <= 1).all(-1)
    mapped = imatmul(imatmul(Mi, G), Mi.transpose(-1, -2))
    covers = (mapped >= Q.long()).flatten(-2).all(-1)
    return rows_ok & cols_ok & covers


# ---------------------------------------------------------------------------
# 3. PSO update (velocity + position + mask + row-normalize)
# ---------------------------------------------------------------------------

def pso_update(S, V, S_local, S_star, S_bar, mask, r, omega: float,
               c1: float, c2: float, c3: float, v_max: float = 1.0):
    """One PSO step (paper Algorithm 1 lines 8-11). ``r`` (…, 3) holds
    the cognitive/social/consensus uniforms of each particle."""
    S = S.float()
    V = V.float()
    maskf = mask.float()
    r0 = r[..., 0, None, None].float()
    r1 = r[..., 1, None, None].float()
    r2 = r[..., 2, None, None].float()
    V_new = (omega * V
             + c1 * r0 * (S_local.float() - S)
             + c2 * r1 * (S_star.float() - S)
             + c3 * r2 * (S_bar.float() - S))
    V_new = V_new.clamp(-v_max, v_max)
    S_new = (S + V_new).clamp(min=0.0) * maskf
    row_sum = seq_sum(S_new, -1)[..., None]
    mask_rows = maskf.sum(-1, keepdim=True)
    uniform = maskf / mask_rows.clamp(min=1.0)
    S_new = torch.where(row_sum > EPS, S_new / row_sum.clamp(min=EPS),
                        uniform)
    return S_new, V_new


# ---------------------------------------------------------------------------
# 4. Masked argmax and the projections
# ---------------------------------------------------------------------------

def masked_argmax(X: torch.Tensor, mask: torch.Tensor):
    """Global argmax over entries where mask != 0 → (value, i·m + j).
    Ties go to the first index in row-major order."""
    flat = torch.where(mask.reshape(-1) != 0, X.reshape(-1).float(),
                       torch.full_like(X.reshape(-1).float(), NEG))
    idx = torch.argmax(flat)
    return flat[idx], idx.to(torch.int32)


def greedy_project(S: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """n rounds of masked global argmax with row/column knockout → uint8
    injective M̂. Batched over leading dims of ``S``."""
    n, m = S.shape[-2:]
    lead = S.shape[:-2]
    Sf = S.float().reshape(-1, n * m)
    B = Sf.shape[0]
    avail = (mask != 0).expand(*lead, n, m).reshape(B, n, m).clone()
    out = torch.zeros(B, n, m, dtype=torch.uint8, device=S.device)
    ar = torch.arange(B, device=S.device)
    for _ in range(n):
        flat = torch.where(avail.reshape(B, -1), Sf,
                           torch.full_like(Sf, NEG))
        idx = flat.argmax(-1)
        take = flat[ar, idx] > NEG
        i, j = idx // m, idx % m
        avail[ar, i, :] &= ~take[:, None]
        avail[ar, :, j] &= ~take[:, None]
        out[ar, i, j] = torch.where(take, 1, out[ar, i, j]).to(torch.uint8)
    return out.reshape(*lead, n, m)


def structured_project(S: torch.Tensor, Q: torch.Tensor, G: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Adjacency-guided projection: place query rows in index (topological)
    order, each on the highest-S free compatible target vertex adjacent to
    the images of all its predecessors and with enough free out-neighbours
    left for its successors. Rows without such a vertex stay zero.
    Batched over leading dims of ``S``; ``Q``/``G``/``mask`` broadcast."""
    n, m = S.shape[-2:]
    lead = S.shape[:-2]
    Sf = S.float().reshape(-1, n, m)
    B = Sf.shape[0]
    dev = S.device
    Qi = _graph(Q, S).reshape(B, n, n).long()
    Gi = _graph(G, S).reshape(B, m, m).long()
    avail = (_graph(mask, S) != 0).reshape(B, n, m).clone()
    col_avail = torch.ones(B, m, dtype=torch.long, device=dev)
    out = torch.zeros(B, n, m, dtype=torch.uint8, device=dev)
    img_rows = torch.zeros(B, n, m, dtype=torch.long, device=dev)
    succ_need = Qi.sum(-1)
    ar = torch.arange(B, device=dev)
    neg = torch.full((B, m), NEG, dtype=torch.float32, device=dev)
    for i in range(n):
        preds = Qi[:, :, i]
        need = preds.sum(-1, keepdim=True)
        support = (preds[:, :, None] * img_rows).sum(1)
        free_out = imatmul(col_avail[:, None, :],
                           Gi.transpose(-1, -2))[:, 0]
        feas = (avail[:, i] & (support >= need)
                & (free_out >= succ_need[:, i, None]))
        scores = torch.where(feas, Sf[:, i], neg)
        j = scores.argmax(-1)
        ok = scores[ar, j] > NEG
        kill = (torch.arange(m, device=dev)[None] == j[:, None]) & ok[:, None]
        avail &= ~kill[:, None, :]
        col_avail = col_avail * (~kill).long()
        out[ar, i, j] = ok.to(torch.uint8)
        img_rows[:, i] = torch.where(ok[:, None], Gi[ar, j],
                                     torch.zeros_like(Gi[:, 0]))
    return out.reshape(*lead, n, m)


# ---------------------------------------------------------------------------
# Quantization helpers (paper §3.4)
# ---------------------------------------------------------------------------

def quantize_s(S: torch.Tensor, scale: int = 255) -> torch.Tensor:
    """Uniform uint8 quantization; ``round`` is half to even, as in JAX."""
    return torch.round(S.float() * scale).clamp(0, 255).to(torch.uint8)


def dequantize_s(S_q: torch.Tensor, scale: int = 255) -> torch.Tensor:
    return fdiv(S_q.float(), scale)


def row_normalize_quantized(S_q: torch.Tensor, mask: torch.Tensor,
                            scale: int = 255) -> torch.Tensor:
    """Divide-free row renormalisation: a Q1.15 reciprocal of each int32
    row sum, then multiply-round-shift back to uint8. The reciprocal is
    a float32 true division, as JAX's weak-typed ``(1 << 15) / row`` is."""
    row = S_q.int().sum(-1, keepdim=True)
    rowf = row.clamp(min=1).to(torch.float32)
    recip_q15 = torch.round(torch.full_like(rowf, 32768.0) / rowf
                            ).to(torch.int32)
    prod = S_q.int() * recip_q15 * scale
    out = ((prod + (1 << 14)) >> 15).clamp(0, 255).to(torch.uint8)
    maskq = mask != 0
    mask_rows = maskq.sum(-1, keepdim=True)
    uniform = torch.where(
        maskq, (scale // mask_rows.clamp(min=1)).clamp(1, 255),
        torch.zeros_like(mask_rows)).to(torch.uint8)
    return torch.where(row > 0, out * maskq, uniform)
