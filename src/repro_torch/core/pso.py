"""Ullmann-refined Particle Swarm Optimization for subgraph matching.

Port of the JAX package's ``core/pso.py`` (paper Algorithm 1). Each
particle carries a relaxed mapping S ∈ [0,1]^{n×m}, row-stochastic and
masked by the global compatibility mask. Per epoch:

  1. InitParticles   — a fresh swarm (the global bests persist);
  2. K inner steps   — ONE ``epoch_fused`` launch (update, optional
                       requantize, fitness, local and global bests);
  3. the epoch tail  — ONE ``epoch_finish`` call: structured and greedy
                       projections, Ullmann refinement, feasibility and
                       the elite consensus S̄.

JAX's ``vmap`` over problems is a leading problem axis P written out:
every kernel takes (P, …) tensors with per-problem Q and G, and the
single-problem entry points are the batched ones at P = 1. JAX's
``lax.scan`` over epochs is a Python loop; its ``lax.cond`` early exit
freezes finished problems on the device with ``torch.where`` and stops
the loop once every problem is done, at the cost of at most one bool
fetch per epoch (counted in ``host_syncs``).

Random numbers. ``jax.random`` cannot be reproduced with torch, so the
draws are inputs: ``draws`` holds, per epoch, the ``init_particles``
uniforms on [0.05, 1), the step uniforms ``r_all`` and (τ > 0) the
Gumbel field. Without ``draws`` every problem has a draw stream of its
own (a seed, a ``torch.Generator`` or a callable, see ``Stream``), as
the JAX package gives each problem of a batch its own PRNG key: problem
b's epoch-t draws depend only on its stream and t, never on its batch
mates, its position or the batch's padding.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import backend as kernel_backend
from repro_torch.kernels import ref

_NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    """Static configuration of Algorithm 1, field for field the JAX
    package's ``PSOConfig``; ``backend`` is ``"auto"``, ``"ref"``,
    ``"cuda"`` or the name of a suite added with ``register_backend``."""
    num_particles: int = 64          # N
    epochs: int = 4                  # T
    inner_steps: int = 12            # K
    omega: float = 0.7               # inertia
    c1: float = 1.4                  # cognitive (S_local)
    c2: float = 1.4                  # social (S*)
    c3: float = 0.6                  # consensus (S̄) — the paper's addition
    v_max: float = 0.5               # velocity clamp per S entry
    elite_frac: float = 0.25         # top-k fraction fused into S̄
    consensus_temp: float = 25.0     # softmax temperature on normalized f
    refine_threshold: float = 0.5    # S ≥ τ·rowmax(S) enters the candidate set
    refine_iters: int = 6            # Ullmann pruning sweeps
    quantized: bool = False          # uint8 S + int32-MAC fitness (§3.4)
    backend: str = "auto"            # "auto" | "ref" | "cuda" | a registered
                                     # suite (kernels/backend.py)
    prune_mask: bool = True          # global Ullmann+injectivity pre-prune
    prune_iters: int = 0             # 0 = iterate the pre-prune to fixpoint
    early_exit: bool = False         # stop epochs once a good mapping exists
    early_exit_fitness: float = float("-inf")   # "good" = feasible ∧ f ≥ this
    carry_fastpath: bool = True      # with early_exit: verify the warm
                                     # carry's S* by one projection and skip
                                     # every epoch if it is still feasible
    gumbel_tau: float = 0.0          # >0: Gumbel-perturbed structured
                                     # projection per particle

    def replace(self, **kw) -> "PSOConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: Dict) -> "PSOConfig":
        """Build from ``dataclasses.asdict`` of a JAX ``PSOConfig``. A JAX
        backend name the port has not registered (``pallas``,
        ``interpret``) becomes ``"auto"``."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        if str(kw.get("backend", "auto")).strip().lower() not in (
                "auto", *kernel_backend.registered_backends()):
            kw["backend"] = "auto"
        return cls(**kw)


def elite_k_for(cfg: PSOConfig) -> int:
    """Static elite count k = max(1, round(elite_frac · N)) (line 24)."""
    return max(1, int(round(cfg.elite_frac * cfg.num_particles)))


def init_particles(u: torch.Tensor, mask: torch.Tensor):
    """Masked row-stochastic mappings from uniforms ``u`` on [0.05, 1)
    (…, N, n, m), and zero velocities. ``mask`` broadcasts against u."""
    maskf = mask.float()
    s = u.float() * maskf
    row = ref.seq_sum(s, -1)[..., None]
    mask_rows = maskf.sum(-1, keepdim=True)
    uniform = (maskf / mask_rows.clamp(min=1.0)).expand_as(s)
    s = torch.where(row > ref.EPS, s / row.clamp(min=ref.EPS), uniform)
    return s, torch.zeros_like(s)


def _fitness(S, Q, G, cfg: PSOConfig):
    """Fitness of S (P, N, n, m) on per-problem Q/G, in float units."""
    bk = kernel_backend.for_config(cfg)
    if cfg.quantized:
        f = bk.edge_fitness_quantized(bk.quantize_s(S), Q, G)
        return ref.fdiv(f, 255.0 ** 4)
    return bk.edge_fitness(S, Q, G)


def _maybe_requantize(S, mask, cfg: PSOConfig):
    """Straight-through uint8 re-quantization of the swarm state (the
    accelerator keeping S resident in uint8 between steps): quantize,
    Q1.15 row renormalisation, dequantize. ``mask`` broadcasts against
    S (…, n, m); S passes through when ``cfg.quantized`` is off."""
    if not cfg.quantized:
        return S
    bk = kernel_backend.for_config(cfg)
    return bk.dequantize_s(bk.row_normalize_quantized(bk.quantize_s(S),
                                                      mask))


def ullmann_refine_candidates(S, M_proj, Q, G, mask, cfg: PSOConfig):
    """Paper line 20 for ONE problem, batched over particles: refine the
    candidate structure with ``cfg.refine_iters`` Ullmann sweeps, then
    re-project (``KernelBackend.ullmann_refine_candidates``). Returns
    ``(M_hat uint8, cand uint8)``."""
    bk = kernel_backend.for_config(cfg)
    return bk.ullmann_refine_candidates(
        S, M_proj, Q, G, mask, refine_threshold=cfg.refine_threshold,
        refine_iters=cfg.refine_iters)


def elite_consensus(S_all, f_all, cfg: PSOConfig):
    """S̄ parts ``(weighted, weight_total, w)`` of one swarm (N, n, m)."""
    bk = kernel_backend.for_config(cfg)
    k = max(1, int(round(cfg.elite_frac * S_all.shape[-3])))
    return bk.elite_consensus(S_all, f_all, elite_k=k,
                              consensus_temp=cfg.consensus_temp)


def _epoch_start(carry, draws, Q, G, mask, cfg: PSOConfig):
    """Epoch prologue over P problems: fresh swarm, its fitness, and the
    global best seeded from it if better."""
    S_star, f_star, _ = carry
    S, V = init_particles(draws["init"], mask[:, None])
    f_local = _fitness(S, Q, G, cfg)
    ar = torch.arange(S.shape[0], device=S.device)
    best0 = f_local.argmax(-1)
    f0 = f_local[ar, best0]
    better0 = f0 > f_star
    S_star = torch.where(better0[:, None, None], S[ar, best0], S_star)
    f_star = torch.where(better0, f0, f_star)
    return S, V, f_local, S_star, f_star


def run_epoch_batch(carry, draws, Qb, Gb, maskb, cfg: PSOConfig):
    """One epoch for P problems: the prologue, ONE ``epoch_fused`` and
    ONE ``epoch_finish``. ``carry`` = (S* (P, n, m), f* (P,), S̄
    (P, n, m)); ``draws`` = dict(init (P, N, n, m), steps (P, K, N, 3),
    gumbel (P, N, n, m) or None). Returns ``(carry, outs)``."""
    bk = kernel_backend.for_config(cfg)
    S_bar = carry[2]
    S, V, f_local, S_star, f_star = _epoch_start(carry, draws, Qb, Gb,
                                                 maskb, cfg)
    S, S_star, f_star, f_trace, f_last = bk.epoch_fused_batch(
        S, V, S, f_local, S_star, f_star, S_bar, maskb, Qb, Gb,
        draws["steps"], omega=cfg.omega, c1=cfg.c1, c2=cfg.c2, c3=cfg.c3,
        v_max=cfg.v_max, quantized=cfg.quantized)
    gum = draws.get("gumbel") if cfg.gumbel_tau > 0 else None
    M_hat, feasible, S_bar = bk.epoch_finish_batch(
        S, f_last, gum, maskb, Qb, Gb, gumbel_tau=cfg.gumbel_tau,
        refine_threshold=cfg.refine_threshold,
        refine_iters=cfg.refine_iters, elite_k=elite_k_for(cfg),
        consensus_temp=cfg.consensus_temp)
    out = dict(mappings=M_hat, feasible=feasible, fitness=f_last,
               f_star_trace=f_trace, S_final=S)
    return (S_star, f_star, S_bar), out


def _batch1(carry):
    """One problem's carry with a leading problem axis of 1."""
    return tuple(x[None] if torch.is_tensor(x) and x.dim() > 0
                 else torch.as_tensor(x, dtype=torch.float32).reshape(1)
                 for x in carry)


def _unbatch(carry):
    """Inverse of ``_batch1``."""
    return tuple(x[0] for x in carry)


def run_epoch(carry, draws, Q, G, mask, cfg: PSOConfig):
    """One epoch of one problem (``run_epoch_batch`` at P = 1); draws are
    (N, n, m), (K, N, 3) and optionally (N, n, m)."""
    d1 = {k: (None if v is None else v[None]) for k, v in draws.items()}
    carry, outs = run_epoch_batch(_batch1(carry), d1, Q[None], G[None],
                                  mask[None], cfg)
    return _unbatch(carry), {k: v[0] for k, v in outs.items()}


def default_carry(mask: torch.Tensor):
    """Cold controller state: uniform S̄ over the mask, no best yet.
    ``mask`` (n, m) or batched (P, n, m)."""
    maskf = mask.float()
    S_bar0 = maskf / maskf.sum(-1, keepdim=True).clamp(min=1.0)
    f_star = torch.full(mask.shape[:-2], _NEG_INF, dtype=torch.float32,
                        device=mask.device)
    return (S_bar0, f_star, S_bar0)


default_carry_batch = default_carry


def carry_from_numpy(carry, device="cuda"):
    """A carry ``(S*, f*, S̄)`` of numpy arrays (e.g. the JAX package's
    ``MatchResult.carry``) as float32 tensors on ``device``."""
    return tuple(torch.as_tensor(np.array(x, dtype=np.float32),
                                 device=device) for x in carry)


def rebase_carry(carry, mask: torch.Tensor, *, in_place: bool = False):
    """Project a stored carry onto a (possibly different) mask: S* and S̄
    masked and row-renormalized (vanished rows fall back to uniform);
    f* passes through. Batched over leading dims. ``in_place`` writes
    the float32 S* and S̄ over themselves (a launch that owns its freshly
    gathered carry), with the same bits."""
    S_star, f_star, S_bar = carry
    maskf = mask.float()
    uniform = maskf / maskf.sum(-1, keepdim=True).clamp(min=1.0)

    def onto(S, own):
        own = own and S.dtype == torch.float32
        S = S.mul_(maskf) if own else S.float() * maskf
        row = ref.seq_sum(S, -1)[..., None]
        return torch.where(row > ref.EPS, S / row.clamp(min=ref.EPS),
                           uniform, out=S if own else None)

    shared = S_bar.data_ptr() == S_star.data_ptr()   # the cold prior's
    return (onto(S_star, in_place), f_star,
            onto(S_bar, in_place and not shared))


def carry_fast_path(carry0, Q, G, mask, cfg: PSOConfig):
    """Project the carried S* once; ``ok`` if that is still a feasible
    mapping and the carry holds a real decision. Batched over leading
    dims. Returns ``(M_c, ok)``."""
    bk = kernel_backend.for_config(cfg)
    S_star0, f_star0, _ = carry0
    M_c = bk.structured_project(S_star0, Q, G, mask).to(torch.uint8)
    ok = (bk.is_feasible(M_c, Q, G) & (f_star0 > _NEG_INF)
          & (f_star0 >= cfg.early_exit_fitness))
    return M_c, ok


def revalidate_carry(carry0, Q, G, mask, cfg: PSOConfig, *,
                     donate: bool = False):
    """Tier-0/1 decision over P problems: rebase + ONE structured
    projection + its fitness (one fitness launch). ``donate`` lets the
    rebase overwrite ``carry0``'s S* and S̄. Returns
    ``dict(mapping, ok, ok_rebase, fitness, S_star, S_bar)``."""
    bk = kernel_backend.for_config(cfg)
    S_rb, f_star0, S_bar_rb = rebase_carry(carry0, mask, in_place=donate)
    M_c = bk.structured_project(S_rb, Q, G, mask).to(torch.uint8)
    f_c = _fitness(M_c.float()[:, None], Q, G, cfg)[:, 0]
    ok = (bk.is_feasible(M_c, Q, G) & (f_star0 > _NEG_INF)
          & (f_star0 >= cfg.early_exit_fitness))
    ok_rebase = ok & (f_c >= cfg.early_exit_fitness)
    return dict(mapping=M_c, ok=ok, ok_rebase=ok_rebase, fitness=f_c,
                S_star=S_rb, S_bar=S_bar_rb)


def revalidate_batch(Qb, Gb, maskb, cfg: PSOConfig, carry0, *,
                     donate: bool = False):
    """Tier-0 entry point: pre-prune (one launch), then re-validate P
    stored carries. Returns the ``revalidate_carry`` dict plus
    ``prune_sweeps`` (P,) and ``f_carry`` (P,), the carried f*.
    ``donate``: see ``revalidate_carry``."""
    P = maskb.shape[0]
    bk = kernel_backend.for_config(cfg)
    if cfg.prune_mask:
        maskb, prune_sweeps = bk.prune_fixpoint_batch(maskb, Qb, Gb,
                                                      cfg.prune_iters)
    else:
        prune_sweeps = torch.zeros(P, dtype=torch.int32, device=maskb.device)
    f_carry = carry0[1].float()
    outs = revalidate_carry(carry0, Qb, Gb, maskb, cfg, donate=donate)
    outs["prune_sweeps"] = prune_sweeps
    outs["f_carry"] = f_carry
    return outs


def _skip_epoch_outs(carry, n, m, cfg: PSOConfig):
    """Shape-matched placeholder outputs of a finished problem's epoch."""
    f_star = carry[1]
    P, N, dev = f_star.shape[0], cfg.num_particles, f_star.device
    return dict(
        mappings=torch.zeros(P, N, n, m, dtype=torch.uint8, device=dev),
        feasible=torch.zeros(P, N, dtype=torch.bool, device=dev),
        fitness=torch.full((P, N), _NEG_INF, dtype=torch.float32,
                           device=dev),
        f_star_trace=f_star.float()[:, None].expand(
            P, cfg.inner_steps).clone())


def epoch_found(outs, cfg: PSOConfig) -> torch.Tensor:
    """Per problem: some particle projected to a feasible mapping whose
    fitness clears the bound."""
    return (outs["feasible"] & (outs["fitness"] >= cfg.early_exit_fitness)
            ).any(-1)


def scan_epochs_batch(run_one: Callable, carry0, n, m, cfg: PSOConfig,
                      done0: Optional[torch.Tensor] = None,
                      all_found: Optional[Callable] = None):
    """Run ``run_one(carry, t) -> (carry, outs)`` for t < T over P
    problems. With ``cfg.early_exit`` a problem that found a mapping is
    frozen (its carry kept, its outputs the skip placeholders) and the
    loop stops once all are done: one bool fetch per epoch at most.
    ``all_found`` (the distributed matcher) fuses each epoch's
    found-predicate across the mesh before it is fetched, so every rank
    takes the same branch: the live branch holds collectives. ``done0``
    must likewise be the same on every rank.
    Returns ``(carry, outs stacked over T, epochs_run (P,), host_syncs)``.
    """
    P = carry0[1].shape[0]
    dev = carry0[1].device
    T = cfg.epochs
    carry, per_epoch = carry0, []
    done = (torch.zeros(P, dtype=torch.bool, device=dev) if done0 is None
            else done0.to(torch.bool))
    n_run = torch.zeros(P, dtype=torch.int32, device=dev)
    syncs, all_done = 0, False
    for t in range(T):
        if cfg.early_exit and not all_done and (t > 0 or done0 is not None):
            syncs += 1
            all_done = bool(done.all())
        if all_done:
            per_epoch.append(_skip_epoch_outs(carry, n, m, cfg))
            continue
        carry2, outs = run_one(carry, t)
        if cfg.early_exit:
            skip = _skip_epoch_outs(carry, n, m, cfg)

            def keep(old, new):
                d = done.reshape((P,) + (1,) * (new.dim() - 1))
                return torch.where(d, old, new)

            carry2 = tuple(keep(o, c) for o, c in zip(carry, carry2))
            outs = {k: keep(skip[k], v) for k, v in outs.items()}
            n_run = n_run + (~done).int()
            found = epoch_found(outs, cfg)
            if all_found is not None:
                found = all_found(found)
            done = done | found
        per_epoch.append(outs)
        carry = carry2
    if not cfg.early_exit:
        n_run = torch.full((P,), T, dtype=torch.int32, device=dev)
    stacked = {k: torch.stack([o[k] for o in per_epoch])
               for k in per_epoch[0]}
    return carry, stacked, n_run, syncs


def scan_epochs(run_one: Callable, carry0, n, m, cfg: PSOConfig,
                done0: Optional[torch.Tensor] = None,
                all_found: Optional[Callable] = None):
    """Single-problem ``scan_epochs_batch``: ``run_one(carry, t)`` takes
    and returns one problem's carry. Returns ``(carry, outs,
    epochs_run, host_syncs)``."""
    def run_b(carry_b, t):
        carry, outs = run_one(_unbatch(carry_b), t)
        return _batch1(carry), {k: v[None] for k, v in outs.items()}

    carry, outs, n_run, syncs = scan_epochs_batch(
        run_b, _batch1(carry0), n, m, cfg,
        None if done0 is None else done0.reshape(1), all_found)
    return (_unbatch(carry), {k: v[:, 0] for k, v in outs.items()},
            n_run[0], syncs)


#: One problem's draw stream: an int seed, a ``torch.Generator`` on the
#: problems' device, or a callable ``t -> dict(init (N, n, m), steps
#: (K, N, 3)[, gumbel (N, n, m)])`` of that problem's epoch-t draws (how
#: tests hand in the JAX package's draws, key by key).
Stream = Union[int, torch.Generator, Callable[[int], Dict]]


def _draw_fns(streams: Optional[Sequence[Stream]], P, N, n, m,
              cfg: PSOConfig, device):
    """Per problem, a function t -> its epoch-t draws. A seed becomes a
    fresh generator, so equal seeds give equal streams; a generator is
    drawn from in epoch order (a problem that early exits inside a batch
    still draws its later epochs, so its state after the call depends on
    the epochs the batch ran). ``None`` is seed 0 for every problem."""
    if streams is None:
        streams = [0] * P
    if len(streams) != P:
        raise ValueError(f"{len(streams)} draw streams for {P} problems")
    K = cfg.inner_steps

    def from_generator(g):
        def draw(t):
            u = torch.rand((N, n, m), generator=g, device=device)
            out = dict(init=u * 0.95 + 0.05,
                       steps=torch.rand((K, N, 3), generator=g,
                                        device=device),
                       gumbel=None)
            if cfg.gumbel_tau > 0:
                e = torch.empty((N, n, m), device=device).exponential_(
                    generator=g)
                out["gumbel"] = -torch.log(e)
            return out
        return draw

    fns = []
    for s in streams:
        if callable(s):
            fns.append(s)
        elif isinstance(s, torch.Generator):
            fns.append(from_generator(s))
        else:
            fns.append(from_generator(
                torch.Generator(device=device).manual_seed(int(s))))
    return fns


def _epoch_draws(draws, draw_fns, t, cfg, device):
    """The random inputs of epoch t for P problems: slices of ``draws``,
    or each problem's own stream stacked on the problem axis."""
    tau = cfg.gumbel_tau > 0
    if draws is not None:
        gum = draws.get("gumbel")
        return dict(
            init=draws["init"][t].to(device),
            steps=draws["steps"][t].to(device),
            gumbel=(gum[t].to(device) if gum is not None and tau
                    else None))
    per = [f(t) for f in draw_fns]

    def stack(name):
        return torch.stack([torch.as_tensor(d[name], device=device)
                            for d in per])

    return dict(init=stack("init"), steps=stack("steps"),
                gumbel=stack("gumbel") if tau else None)


def match_batch(Qb, Gb, maskb, cfg: PSOConfig, carry0=None, *,
                streams: Optional[Sequence[Stream]] = None,
                draws: Optional[Dict] = None):
    """Batched Algorithm 1: P problems in one pass.

    ``Qb`` (P, n, n), ``Gb`` (P, m, m), ``maskb`` (P, n, m) on one device;
    ``carry0`` optionally warm-starts each problem (stacked (S*, f*, S̄)).
    ``draws``: dict(init (T, P, N, n, m), steps (T, P, K, N, 3)[, gumbel
    (T, P, N, n, m)]); else ``streams``, one ``Stream`` per problem (seed
    0 for each if None), so that problem b's slice of the output is what
    ``match`` returns for it alone with ``stream=streams[b]``.

    Returns mappings (T, P, N, n, m), feasible/fitness (T, P, N),
    f_star_trace (T, P, K), S_star/S_bar (P, n, m), f_star (P,),
    epochs_run (P,), carry_mapping (P, n, m), carry_feasible (P,),
    prune_sweeps (P,) and ``host_syncs`` (int): the bool fetches the
    early exit made.
    """
    P, n, m = maskb.shape
    dev = maskb.device
    if carry0 is None:
        carry0 = default_carry_batch(maskb)
    draw_fns = (None if draws is not None else
                _draw_fns(streams, P, cfg.num_particles, n, m, cfg, dev))
    bk = kernel_backend.for_config(cfg)
    if cfg.prune_mask:
        maskb, prune_sweeps = bk.prune_fixpoint_batch(maskb, Qb, Gb,
                                                      cfg.prune_iters)
    else:
        prune_sweeps = torch.zeros(P, dtype=torch.int32, device=dev)
    fast = cfg.early_exit and cfg.carry_fastpath
    if fast:
        M_c, carry_ok = carry_fast_path(carry0, Qb, Gb, maskb, cfg)
    else:
        M_c = torch.zeros(P, n, m, dtype=torch.uint8, device=dev)
        carry_ok = torch.zeros(P, dtype=torch.bool, device=dev)

    def run_one(carry, t):
        d = _epoch_draws(draws, draw_fns, t, cfg, dev)
        carry, outs = run_epoch_batch(carry, d, Qb, Gb, maskb, cfg)
        del outs["S_final"]
        return carry, outs

    (S_star, f_star, S_bar), outs, epochs_run, syncs = scan_epochs_batch(
        run_one, carry0, n, m, cfg, done0=carry_ok if fast else None)
    outs.update(S_star=S_star, f_star=f_star, S_bar=S_bar,
                epochs_run=epochs_run, carry_mapping=M_c,
                carry_feasible=carry_ok, prune_sweeps=prune_sweeps,
                host_syncs=syncs)
    return outs


#: Output leaves with an epoch axis (the problem axis follows it).
PER_EPOCH = ("mappings", "feasible", "fitness", "f_star_trace")


def match(Q, G, mask, cfg: PSOConfig, carry0=None, *,
          stream: Optional[Stream] = None, draws: Optional[Dict] = None):
    """Single-problem Algorithm 1 (``match_batch`` at P = 1) with one draw
    ``stream`` (seed 0 if None). ``draws`` hold (T, N, n, m), (T, K, N,
    3)[, (T, N, n, m)]. Returns the ``match_batch`` dict without the
    problem axis."""
    d1 = None if draws is None else {
        k: (None if v is None else v[:, None]) for k, v in draws.items()}
    outs = match_batch(Q[None], G[None], mask[None], cfg,
                       None if carry0 is None else _batch1(carry0),
                       streams=None if stream is None else [stream],
                       draws=d1)
    return {k: (v if k == "host_syncs" else
                v[:, 0] if k in PER_EPOCH else v[0])
            for k, v in outs.items()}


def best_feasible(outs) -> Optional[np.ndarray]:
    """Highest-fitness feasible mapping of an epoch trace, or None. The
    select runs on the device; one scalar and one (n, m) mapping cross
    to the host."""
    feas = outs["feasible"].reshape(-1)
    fit = outs["fitness"].reshape(-1).float()
    maps = outs["mappings"].reshape(-1, *outs["mappings"].shape[-2:])
    fmin = torch.finfo(torch.float32).min
    fmax = torch.finfo(torch.float32).max
    score = torch.where(feas, torch.nan_to_num(fit, neginf=fmin, posinf=fmax),
                        torch.full_like(fit, _NEG_INF))
    idx = score.argmax()
    any_feasible, best = feas.any().cpu(), maps[idx].cpu()
    if not bool(any_feasible):
        return None
    return best.numpy()
