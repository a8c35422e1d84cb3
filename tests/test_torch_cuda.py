"""Card-only: every hand-written CUDA kernel of the port against its plain
PyTorch version on the same inputs (integers bit for bit, floats within
rtol 1e-5 / atol 1e-4). Skips without a card; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import pso, split_epoch
from repro_torch.kernels import _build, cases, ref
from repro_torch.kernels.argmax_project import (greedy_project_cuda,
                                                masked_argmax_cuda)
from repro_torch.kernels.epoch_fused import epoch_fused_cuda
from repro_torch.kernels.finish_fused import epoch_finish_cuda
from repro_torch.kernels.prune_fixpoint import (prune_fixpoint_cuda,
                                                prune_fixpoint_reference)
from repro_torch.kernels.pso_update import pso_update_cuda
from repro_torch.kernels.ullmann_refine import ullmann_refine_step_cuda

pytestmark = pytest.mark.cuda

# (P, N, n, m, K): the JAX backend sweep's shapes and the main path's
SHAPES = [(1, 8, 8, 16, 3), (2, 16, 40, 72, 3), (8, 64, 56, 144, 12)]
MODES = [(False, 0.0), (True, 0.0), (False, 0.3), (True, 0.3)]
# n and m off every multiple of 4 and 8 (the kernels' scalar tails and
# padded rows), in shared memory and past it
ODD_SHAPES = [(2, 16, 13, 37, 3), (2, 16, 10, 70, 3), (1, 16, 203, 233, 2)]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("quantized,tau", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_card(device, shape, quantized, tau):
    P, N, n, m, K = shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 1))
    x = cases.swarm_inputs(Q, G, mask, N, K, seed=2)
    pairs = cases.kernel_pairs(Q, G, mask, x, quantized=quantized,
                               gumbel_tau=tau, elite_k=max(1, N // 4))
    for name, (kernel, plain) in pairs.items():
        got = kernel()
        torch.cuda.synchronize()
        try:
            cases.compare(got, plain())
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from e


def _assert_prune_bitwise(mask, Q, G, max_iters):
    from repro_torch.kernels import prune_fixpoint
    prune_fixpoint.launches.reset()
    got = prune_fixpoint_cuda(mask, Q, G, max_iters)
    torch.cuda.synchronize()
    assert prune_fixpoint.launches.count == 1
    want = prune_fixpoint_reference(mask, Q, G, max_iters)
    for name, g, w in zip(("mask", "sweeps"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))


@pytest.mark.parametrize("max_iters", [0, 1, 2])
@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("shape", [(3, 1, 40, 72, 1)] + ODD_SHAPES + [
    (1, 1, 256, 256, 1), (1, 1, 56, 144, 1)])
def test_prune_kernel_mask_dtypes_on_card(device, shape, mask_dtype,
                                          max_iters):
    """Masks and sweeps bit for bit, for both mask dtypes, at n, m off
    every multiple of 8, up to 256 x 256 (8 rows a warp), and for a single
    problem (P = 1)."""
    P, _, n, m, _ = shape
    Q, G, mask = (t.to(device) for t in
                  cases.random_problem(P, n, m, 5, mask_dtype))
    _assert_prune_bitwise(mask, Q, G, max_iters)


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("n,m", [(13, 37), (40, 72), (203, 233)])
def test_prune_fixpoint_long_chain_on_card(device, n, m, mask_dtype):
    """A path-shaped Q on a path-shaped G: n sweeps from the all-ones
    mask, each changing a shrinking set of rows, so that only some rows'
    supports are rebuilt in each iteration; and the same budget cut
    short."""
    Q, G, mask = (t.to(device) for t in
                  cases.chain_problem(3, n, m, 42, mask_dtype))
    for max_iters in (0, n // 2):
        _assert_prune_bitwise(mask, Q, G, max_iters)
    _, sweeps = prune_fixpoint_cuda(mask, Q, G)
    assert int(sweeps[0]) == n


def _dtype_cases(device, n, m, mask_dtype, seed):
    Q, G, mask = (t.to(device) for t in
                  cases.random_problem(1, n, m, seed, mask_dtype))
    x = cases.swarm_inputs(Q, G, mask, 16, 1, seed=seed)
    return Q[0], G[0], mask[0], x


@pytest.mark.parametrize("n,m", [(8, 16), (56, 144), (256, 256)])
@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32,
                                        torch.bool])
def test_split_path_kernels_on_card(device, n, m, mask_dtype):
    """pso_update, ullmann_refine_step, greedy_project and masked_argmax
    against their plain versions for every mask dtype, up to 256 x 256
    (where greedy_project reads S from global memory and pso_update
    normalises in row blocks)."""
    Q, G, mask, x = _dtype_cases(device, n, m, mask_dtype, 3)
    S, V, r = x["S"][0], x["V"][0], x["r_all"][0, 0]
    upd = (S, V, S, x["S_star"][0], x["S_bar"][0], mask, r)
    cases.compare(pso_update_cuda(*upd, **cases.HYPER),
                  ref.pso_update(*upd, **cases.HYPER))
    cand = ((S >= 0.5 * S.amax(-1, keepdim=True)) & (mask != 0)).to(
        mask_dtype)
    for Qx, Gx in ((Q, G), (Q.int(), G.int()), (Q.bool(), G.int())):
        got = ullmann_refine_step_cuda(cand, Qx, Gx)
        assert got.dtype == mask_dtype
        cases.compare(got, ref.ullmann_refine_step(cand, Qx, Gx))
    cases.compare(greedy_project_cuda(S, mask), ref.greedy_project(S, mask))
    cases.compare(masked_argmax_cuda(x["S_star"][0], mask),
                  ref.masked_argmax(x["S_star"][0], mask))
    empty = torch.zeros_like(mask)
    cases.compare(masked_argmax_cuda(x["S_star"][0], empty),
                  ref.masked_argmax(x["S_star"][0], empty))


def test_split_path_kernels_reject_what_they_do_not_take(device):
    """No fallback: per-problem shared operands and n, m > 256 raise."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(3, 20, 40, 6))
    x = cases.swarm_inputs(Q, G, mask, 8, 1, seed=6)
    with pytest.raises(ValueError):
        greedy_project_cuda(x["S"], mask[:, None])
    with pytest.raises(ValueError):
        ullmann_refine_step_cuda((x["S"] > 0).to(torch.uint8), Q[:, None],
                                 G[:, None])
    with pytest.raises(ValueError):
        pso_update_cuda(x["S"][0], x["V"][0], x["S"][0], x["S_star"][:1],
                        x["S_bar"][0], mask[0], x["r_all"][0, 0],
                        **cases.HYPER)
    big = torch.zeros(2, 257, 8, device=device)
    with pytest.raises(ValueError):
        greedy_project_cuda(big, big[0] > 0)
    with pytest.raises(ValueError):
        masked_argmax_cuda(big[0], big[0] > 0)


@pytest.mark.parametrize("quantized", [False, True])
def test_split_epoch_equals_fused_epoch_on_card(device, quantized):
    P, N, n, m, K = 2, 16, 40, 72, 3
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 8))
    x = cases.swarm_inputs(Q, G, mask, N, K, seed=8)
    cfg = pso.PSOConfig(num_particles=N, inner_steps=K, quantized=quantized,
                        backend="cuda")
    keys = ("S", "V", "S", "f_local", "S_star", "f_star", "S_bar")
    S, star, fstar, trace, f_last = epoch_fused_cuda(
        *(x[k] for k in keys), mask, Q, G, x["r_all"], quantized=quantized,
        **cases.HYPER)
    tail = epoch_finish_cuda(S, f_last, None, mask, Q, G, gumbel_tau=0.0,
                             refine_threshold=cfg.refine_threshold,
                             refine_iters=cfg.refine_iters,
                             elite_k=pso.elite_k_for(cfg),
                             consensus_temp=cfg.consensus_temp)
    want = (S, star, fstar, trace, f_last) + tuple(tail)
    for p in range(P):
        got = split_epoch.split_epoch(*(x[k][p] for k in keys), mask[p],
                                      Q[p], G[p], x["r_all"][p], cfg)
        for k in range(7):
            assert torch.equal(got[k], want[k][p]), k
        cases.compare(got[7], want[7][p])


def _epoch_args(x, mask, Q, G):
    keys = ("S", "V", "S", "f_local", "S_star", "f_star", "S_bar")
    return (*(x[k] for k in keys), mask, Q, G, x["r_all"])


def _assert_epoch_bitwise(args, quantized):
    from repro_torch.kernels import epoch_fused
    from repro_torch.kernels.epoch_fused import epoch_inner_reference
    K = args[-1].shape[1]
    epoch_fused.launches.reset()
    epoch_fused.launches_float.reset()
    got = epoch_fused_cuda(*args, quantized=quantized, **cases.HYPER)
    torch.cuda.synchronize()
    assert epoch_fused.launches.count == (K + 1 if K else 0)
    assert epoch_fused.launches_float.count == (
        0 if quantized else epoch_fused.launches.count)
    want = epoch_inner_reference(*args, quantized=quantized, **cases.HYPER)
    names = ("S_final", "S_star", "f_star", "f_trace", "f_last")
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape",
                         SHAPES + [(1, 64, 256, 256, 2)] + ODD_SHAPES)
def test_epoch_fused_bitwise_on_card(device, shape, quantized):
    """Every output of epoch_fused equals the plain version bit for bit,
    up to 256 x 256 (where the tiles live in device scratch), and at n, m
    that are no multiple of 4."""
    P, N, n, m, K = shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 11))
    x = cases.swarm_inputs(Q, G, mask, N, K, seed=12)
    _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("K", [0, 1])
def test_epoch_fused_short_epochs_on_card(device, K, quantized):
    Q, G, mask = (t.to(device) for t in cases.random_problem(2, 40, 72, 13))
    x = cases.swarm_inputs(Q, G, mask, 16, K, seed=13)
    _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


@pytest.mark.parametrize("quantized", [False, True])
def test_epoch_fused_empty_mask_row_on_card(device, quantized):
    """A mask row with no candidate takes the uniform fallback (and the
    quantized one its integer fallback)."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(2, 40, 72, 14))
    x = cases.swarm_inputs(Q, G, mask, 16, 3, seed=14)
    mask = mask.clone()
    mask[:, 5] = 0
    _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


@pytest.mark.parametrize("quantized", [False, True])
def test_epoch_fused_selection_ties_on_card(device, quantized):
    """Equal local bests across particles: the first index wins the
    global best, as in argmax."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(2, 40, 72, 15))
    x = cases.swarm_inputs(Q, G, mask, 16, 2, seed=15)
    x["f_local"] = torch.zeros_like(x["f_local"])     # above any fitness
    args = _epoch_args(x, mask, Q, G)
    _assert_epoch_bitwise(args, quantized)
    _, star, _, _, _ = epoch_fused_cuda(*args, quantized=quantized,
                                        **cases.HYPER)
    assert torch.equal(star, x["S"][:, 0])


def _assert_argmax_bitwise(X, mask):
    got = masked_argmax_cuda(X, mask)
    want = ref.masked_argmax(X, mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("n,m", [(1, 1), (56, 144), (256, 256)])
@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32,
                                        torch.bool])
def test_masked_argmax_bitwise_on_card(device, n, m, mask_dtype):
    """Aligned and unaligned X (16-byte loads and the scalar scan), an
    all-masked input, and exact ties (the first index wins)."""
    g = torch.Generator().manual_seed(n * 1000 + m)
    X = torch.randn(n, m, generator=g).to(device)
    mask = (torch.rand(n, m, generator=g) < 0.7).to(device).to(mask_dtype)
    _assert_argmax_bitwise(X, mask)
    buf = torch.randn(n * m + 3, generator=g).to(device)
    _assert_argmax_bitwise(buf[1:1 + n * m].view(n, m), mask)   # unaligned
    _assert_argmax_bitwise(X, torch.zeros_like(mask))
    ties = torch.randint(0, 3, (n, m), generator=g).float().to(device)
    _assert_argmax_bitwise(ties, mask)
    _assert_argmax_bitwise(ties, torch.ones_like(mask))


def _finish_case(device, P, N, n, m, seed, tie_values=None):
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, seed))
    x = cases.swarm_inputs(Q, G, mask, N, 1, seed=seed)
    S = x["S"]
    if tie_values is not None:      # many exact ties: values from a set
        g = torch.Generator().manual_seed(seed)
        pick = torch.randint(0, len(tie_values), S.shape, generator=g)
        S = torch.tensor(tie_values)[pick].to(device) * (mask[:, None] != 0)
    return S, x["f_local"], x["gum"], mask, Q, G


def _assert_finish_bitwise(S, f, gum, mask, Q, G, *, tau, refine_iters=6,
                           elite_k=None):
    """M_hat and feasible bit for bit, S_bar within the tolerance, and two
    launches a call."""
    from repro_torch.kernels import finish_fused
    from repro_torch.kernels.finish_fused import epoch_finish_reference
    N = S.shape[1]
    kw = dict(gumbel_tau=tau, refine_threshold=0.5,
              refine_iters=refine_iters,
              elite_k=max(1, N // 4) if elite_k is None else elite_k,
              consensus_temp=25.0)
    finish_fused.launches.reset()
    got = epoch_finish_cuda(S, f, gum if tau > 0 else None, mask, Q, G, **kw)
    torch.cuda.synchronize()
    assert finish_fused.launches.count == 2
    want = epoch_finish_reference(S, f, gum if tau > 0 else None, mask, Q,
                                  G, **kw)
    for name, g, w in zip(("M_hat", "feasible"), got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))
    cases.compare(got[2], want[2])


@pytest.mark.parametrize("tau", [0.0, 0.3])
@pytest.mark.parametrize("shape", SHAPES + ODD_SHAPES)
def test_epoch_finish_bitwise_on_card(device, shape, tau):
    """At the sweep's and the main path's shapes, and at n, m off every
    multiple of 8, up to (203, 233) where S is read from device memory."""
    P, N, n, m, _ = shape
    _assert_finish_bitwise(*_finish_case(device, P, N, n, m, 21), tau=tau)


@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_epoch_finish_ties_and_empty_rows_on_card(device, tau):
    """S from a set of 4 values (every argmax meets exact ties, which go
    to the lower index) with an all-zero mask row."""
    S, f, gum, mask, Q, G = _finish_case(device, 2, 16, 40, 72, 22,
                                         tie_values=[0.1, 0.2, 0.3, 0.4])
    mask = mask.clone()
    mask[:, 7] = 0
    S = S * (mask[:, None] != 0)
    _assert_finish_bitwise(S, f, gum, mask, Q, G, tau=tau)


def test_epoch_finish_greedy_rescans_on_card(device):
    """Every row ranks the columns alike, so each greedy round takes the
    cached column of every row left and all of them are rescanned."""
    P, N, n, m = 2, 8, 24, 40
    _, f, gum, mask, Q, G = _finish_case(device, P, N, n, m, 23)
    i = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    j = torch.arange(m, device=device, dtype=torch.float32)[None]
    S = ((m - j) + i / (4 * n)).expand(P, N, n, m).contiguous()
    ones = torch.ones_like(mask)
    _assert_finish_bitwise(S, f, gum, ones, Q, G, tau=0.0)
    _assert_finish_bitwise(S, f, gum, mask, Q, G, tau=0.0)


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_epoch_finish_short_refinement_on_card(device, refine_iters):
    _assert_finish_bitwise(*_finish_case(device, 2, 16, 40, 72, 24), tau=0.0,
                           refine_iters=refine_iters)


@pytest.mark.parametrize("elite_k", [1, 16])
def test_epoch_finish_elite_sizes_on_card(device, elite_k):
    """elite_k = 1 and elite_k = N (every particle in the consensus)."""
    _assert_finish_bitwise(*_finish_case(device, 2, 16, 40, 72, 25), tau=0.0,
                           elite_k=elite_k)


def _assert_fitness_u8_bitwise(S_q, Q, G):
    from repro_torch.kernels import pso_fitness
    from repro_torch.kernels.pso_fitness import (
        edge_fitness_cuda, edge_fitness_quantized_reference)
    pso_fitness.launches_quantized.reset()
    got = edge_fitness_cuda(S_q, Q, G, quantized=True)
    torch.cuda.synchronize()
    assert pso_fitness.launches_quantized.count == 2
    want = edge_fitness_quantized_reference(S_q, Q, G)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.parametrize("shape", SHAPES + ODD_SHAPES)
def test_edge_fitness_quantized_bitwise_on_card(device, shape):
    P, N, n, m, _ = shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 31))
    x = cases.swarm_inputs(Q, G, mask, N, 1, seed=31)
    _assert_fitness_u8_bitwise(x["S_q"], Q, G)


def test_edge_fitness_quantized_projection_tile_on_card(device):
    """The Tier-0 call: N = 1 on the 0/255 tile of a projection."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(8, 56, 144, 32))
    x = cases.swarm_inputs(Q, G, mask, 1, 1, seed=32)
    M = ref.greedy_project(x["S"][:, 0], mask)
    _assert_fitness_u8_bitwise(ref.quantize_s(M.float()[:, None]), Q, G)


def test_edge_fitness_quantized_largest_sums_on_card(device):
    """m = 256, an all-255 tile and a dense G: S G S^T reaches its largest
    value (~4.3e9, past 2^31) and the squared residuals wrap in 64 bits as
    the plain version's int64 arithmetic does."""
    P, N, n, m = 1, 2, 16, 256
    Q, _, _ = (t.to(device) for t in cases.random_problem(P, n, m, 33))
    G = torch.ones(P, m, m, dtype=torch.uint8, device=device)
    S_q = torch.full((P, N, n, m), 255, dtype=torch.uint8, device=device)
    _assert_fitness_u8_bitwise(S_q, Q, G)
    _assert_fitness_u8_bitwise(S_q[:, :, :3].contiguous(), Q[:, :3, :3], G)


def _assert_fitness_f32_bitwise(S, Q, G):
    from repro_torch.kernels import pso_fitness
    from repro_torch.kernels.pso_fitness import (edge_fitness_cuda,
                                                 edge_fitness_reference)
    pso_fitness.launches.reset()
    got = edge_fitness_cuda(S, Q, G)
    torch.cuda.synchronize()
    assert pso_fitness.launches.count == 2
    want = edge_fitness_reference(S, Q, G)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.parametrize("shape", SHAPES + ODD_SHAPES + [(1, 64, 256, 256, 2)])
def test_edge_fitness_float_bitwise_on_card(device, shape):
    """Every n, m <= 256 the port accepts: the tiles in shared memory at
    the main path's shapes and in device scratch past the limit of a
    block, at (203, 233) and (256, 256)."""
    P, N, n, m, _ = shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 34))
    x = cases.swarm_inputs(Q, G, mask, N, 1, seed=34)
    _assert_fitness_f32_bitwise(x["S"], Q, G)


def test_edge_fitness_float_projection_tile_on_card(device):
    """The float Tier-0 call: N = 1 on the 0/1 tile of a projection."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(8, 56, 144, 35))
    x = cases.swarm_inputs(Q, G, mask, 1, 1, seed=35)
    M = ref.greedy_project(x["S"][:, 0], mask)
    _assert_fitness_f32_bitwise(M.float()[:, None], Q, G)


# -- the matcher service on the card ----------------------------------------

def _service_specs():
    """Planted problems in two shape buckets, (8, 16) and (8, 32)."""
    import numpy as np
    from repro_torch.core import graphs
    out = []
    for n, m in ((6, 12), (5, 24)):
        for s in range(6):
            rng = np.random.default_rng(s)
            q = graphs.random_dag(rng, n, 0.35)
            out.append(((n, m, s), q, graphs.embed_query_in_target(rng, q, m)))
    return out


def _drain(svc, specs):
    for (n, m, s), q, g in specs:
        svc.submit(q, g, key=s, workload_key=(f"w{n}x{m}", s))
    return svc.drain()


def test_service_all_warm_drain_makes_one_sync_on_card(device):
    """An all-warm two-bucket drain under
    ``torch.cuda.set_sync_debug_mode("error")``: any blocking transfer
    but ``_sync_fetch``'s one wait raises, and the census counts one."""
    from repro_torch.core.service import MatcherService
    cfg = pso.PSOConfig(num_particles=24, epochs=3, inner_steps=8,
                        quantized=True)
    svc = MatcherService(cfg, device="cuda")
    specs = _service_specs()
    _drain(svc, specs)
    warm = _drain(svc, specs)
    served = [sp for sp, r in zip(specs, warm) if r.tier == 0 and r.found]
    assert {sp[0][:2] for sp in served} == {(6, 12), (5, 24)}
    served = served[:3] + served[-2:]           # new batch classes and rows
    syncs0 = svc.stats.host_syncs
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        results = _drain(svc, served)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert svc.stats.host_syncs - syncs0 == 1
    assert all(r.tier == 0 and r.found for r in results)


@pytest.mark.parametrize("quantized", [False, True])
def test_service_cuda_suite_matches_ref_suite_on_card(device, quantized):
    """The same drains (cold, warm, then one more) through a ``cuda``-suite
    and a ``ref``-suite service on the card, same seeds: the same tiers,
    found and epochs_run, and the mappings bit for bit."""
    from repro_torch.core.service import MatcherService
    cfg = pso.PSOConfig(num_particles=24, epochs=3, inner_steps=8,
                        quantized=quantized)
    svcs = [MatcherService(cfg.replace(backend=b), device="cuda")
            for b in ("cuda", "ref")]
    specs = _service_specs()
    for _round in range(2):
        got, want = (_drain(s, specs) for s in svcs)
        for a, b in zip(got, want):
            assert (a.tier, a.found, a.epochs_run) == \
                (b.tier, b.found, b.epochs_run)
            assert (a.mapping is None) == (b.mapping is None)
            if a.mapping is not None:
                assert (a.mapping == b.mapping).all()


# -- the scheduler on the card ------------------------------------------------

def test_real_mode_simulation_cuda_suite_matches_ref_suite_on_card(
        device, monkeypatch):
    """The reference tests' urgent burst (EDGE, window_stages=2) through
    the simulator in real mode, with IMMSched's service on the card: the
    ``cuda`` suite gives the ``ref`` suite's ``SimResult`` (wall clocks
    and the suite's name aside) and the same mappings, bit for bit."""
    import dataclasses
    from repro_torch.accel.platform import EDGE
    from repro_torch.core.service import MatcherService
    from repro_torch.sched import SimConfig, Simulator, get_scheduler
    from repro_torch.sched.tasks import make_burst_scenario
    served = []
    orig = MatcherService.match_many

    def match_many(self, problems, **kw):
        res = orig(self, problems, **kw)
        served[-1].extend(res)
        return res
    monkeypatch.setattr(MatcherService, "match_many", match_many)

    def run(backend):
        served.append([])
        cfg = SimConfig(platform=EDGE, matcher_mode="real", window_stages=2,
                        pso_cfg=pso.PSOConfig(num_particles=32, epochs=2,
                                              inner_steps=6, backend=backend),
                        device="cuda", validate=True)
        r = Simulator(cfg, get_scheduler("immsched")).run(make_burst_scenario(
            "simple", rate_hz=30, horizon=0.25, burst_size=3,
            burst_frac=0.8, urgent_frac=0.7, seed=5))
        d = dataclasses.asdict(r)
        d["matcher_stats"] = {k: v for k, v in d["matcher_stats"].items()
                              if not k.endswith("wall_s")
                              and k not in ("fe_wait_s", "epoch_backend")}
        return d

    got, want = run("cuda"), run("ref")
    assert got["finished"] == got["total"] > 0
    assert got["matcher_stats"]["tier2_launches"] > 0
    assert got == want
    assert len(served[0]) == len(served[1]) > 0
    for a, b in zip(*served):
        assert (a.tier, a.found, a.epochs_run) == \
            (b.tier, b.found, b.epochs_run)
        assert (a.mapping is None) == (b.mapping is None)
        if a.mapping is not None:
            assert (a.mapping == b.mapping).all()
