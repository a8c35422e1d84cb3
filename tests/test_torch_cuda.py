"""Card-only: every hand-written CUDA kernel of the port against its plain
PyTorch version on the same inputs (integers bit for bit, floats within
rtol 1e-5 / atol 1e-4). Skips without a card; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The LM serve and train paths (no hand kernel) are held card against
CPU here too (``-k "lm_serve or lm_train"``).
"""
import numpy as np
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
# past n, m = 256, the main path's five kernels' wide instantiations: bit
# planes in shared memory, partly in device scratch ((312, 528) and
# (300, 400)), m past 1,024 (two planes a lane) and all in device scratch
# (1,000 x 1,100)
WIDE_SHAPES = [(2, 8, 300, 400, 2), (1, 8, 512, 512, 2), (2, 4, 257, 771, 2),
               (1, 2, 1000, 1100, 2)]
MAIN = ("prune_fixpoint", "edge_fitness", "edge_fitness_quantized",
        "epoch_fused", "epoch_finish")
#: the split path's four past n, m = 256, (lead, n, m): WIDE_SHAPES's
#: problems with their particles as the leading dim
SPLIT_WIDE = [((N,), n, m) for _, N, n, m, _ in WIDE_SHAPES]
#: epoch_finish's S̄ against its plain version (another summation order)
SBAR_ATOL = 1.19e-7


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


def _assert_main_bitwise(pairs, what):
    """The five main-path entries of ``pairs`` bit for bit against their
    plain versions, S̄ within ``SBAR_ATOL``."""
    for name in MAIN:
        kernel, plain = pairs[name]
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want), (what, name)
        for k, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, (what, name, k)
            if name == "epoch_finish" and k == 2:
                assert float((g - w).abs().max()) <= SBAR_ATOL, (what, name)
            else:
                assert torch.equal(g, w), (what, name, k,
                                           int((g != w).sum()))


@pytest.mark.parametrize("quantized,tau", MODES)
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_main_path_kernels_past_256_bitwise(device, shape, quantized, tau):
    """The five main-path kernels past n, m = 256 against their plain
    versions: every output bit for bit but S̄, within 1.19e-7."""
    P, N, n, m, K = shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 7))
    x = cases.swarm_inputs(Q, G, mask, N, K, seed=8)
    pairs = cases.kernel_pairs(Q, G, mask, x, quantized=quantized,
                               gumbel_tau=tau, elite_k=max(1, N // 4))
    _assert_main_bitwise(pairs, shape)


def _wide(n, m):
    """Whether (n, m) takes the kernels' wide instantiations."""
    return n > 256 or m > 256


def test_main_path_kernels_take_257(device):
    """n = m = 257, one past the narrow instantiations: the five run
    (no ValueError) and agree bit for bit (the split path's four:
    ``test_split_path_kernels_take_257``)."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(1, 257, 257,
                                                             9))
    x = cases.swarm_inputs(Q, G, mask, 4, 1, seed=9)
    pairs = cases.kernel_pairs(Q, G, mask, x, quantized=True,
                               gumbel_tau=0.0, elite_k=1)
    _assert_main_bitwise(pairs, (257, 257))


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
    (1, 1, 256, 256, 1), (1, 1, 56, 144, 1)] + WIDE_SHAPES)
def test_prune_kernel_mask_dtypes_on_card(device, shape, mask_dtype,
                                          max_iters):
    """Masks and sweeps bit for bit, for both mask dtypes, at n, m off
    every multiple of 8, up to 256 x 256 (8 rows a warp) and past it (the
    wide instantiation), and for a single problem (P = 1)."""
    P, _, n, m, _ = shape
    Q, G, mask = (t.to(device) for t in
                  cases.random_problem(P, n, m, 5, mask_dtype))
    _assert_prune_bitwise(mask, Q, G, max_iters)


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("n,m", [(13, 37), (40, 72), (203, 233),
                                 (270, 300)])
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
    normalises in row blocks; past it:
    ``test_split_path_kernels_past_256_bitwise``)."""
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


def test_split_path_kernels_refuse_per_problem_operands(device):
    """No fallback: operands that differ a problem, where the four take
    one (n, m) operand shared by every matrix, raise."""
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


def test_split_path_kernels_take_257(device):
    """n = 257 (the calls that raised before the wide instantiations): an
    all-zero S, mask, M, Q and G, and the same shapes drawn at random,
    bit for bit against the plain versions."""
    big = torch.zeros(2, 257, 8, device=device)
    _assert_greedy_bitwise(big, big[0] > 0)
    _assert_argmax_bitwise(big[0], big[0] > 0)
    _assert_refine_bitwise(big.to(torch.uint8),
                           torch.zeros(257, 257, dtype=torch.uint8,
                                       device=device),
                           torch.zeros(8, 8, dtype=torch.uint8,
                                       device=device))
    _assert_update_bitwise((big, big, big, big[0], big[0], big[0] > 0,
                            torch.zeros(2, 3, device=device)))
    _assert_update_bitwise(_update_case(device, (2,), 257, 8, 257))
    _assert_greedy_bitwise(*_greedy_case(device, (2,), 257, 8, 257))
    _assert_refine_bitwise(*_refine_case(device, 2, 257, 8, 257))
    S, mask = _greedy_case(device, (1,), 257, 8, 258)
    _assert_argmax_bitwise(S[0], mask)


@pytest.mark.parametrize("lead,n,m", SPLIT_WIDE)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.bool])
def test_split_path_kernels_past_256_bitwise(device, lead, n, m, dtype):
    """The four past n, m = 256 (WIDE_SHAPES: the sweep's and the
    projection's bit planes in shared memory, the operands packed in
    device scratch, and all in device scratch at 1,000 x 1,100) bit for
    bit against their plain versions: pso_update and greedy_project with
    a mask of this dtype, ullmann_refine_step with an M of this dtype
    (entries 0..3 kept) under every Q / G dtype, masked_argmax with ties
    and with an empty mask."""
    _assert_update_bitwise(_update_case(device, lead, n, m, n + m, dtype))
    _assert_refine_bitwise(*_refine_case(device, lead[0], n, m, n + m,
                                         dtype))
    S, mask = _greedy_case(device, lead, n, m, n + m, mask_dtype=dtype)
    _assert_greedy_bitwise(S, mask)
    _assert_argmax_bitwise(S[0], mask)
    _assert_argmax_bitwise(S[0], torch.zeros_like(mask))
    S, mask = _greedy_case(device, lead, n, m, n + m + 1,
                           values=[0.0, -0.0, 0.25, 0.5], mask_dtype=dtype)
    _assert_greedy_bitwise(S, mask)
    _assert_argmax_bitwise(S[0], mask)


# -- pso_update and greedy_project bit for bit --------------------------------

def _update_case(device, lead, n, m, seed, mask_dtype=torch.uint8):
    """Particles of shape ``lead`` on one (n, m) problem: a 0.8-dense mask
    with row 0 empty (the uniform fallback with no candidate), row 1's
    particles pushed below zero (clamped sum 0: the uniform row) and row
    2's at 1e-11 an entry (a positive clamped sum at or below 1e-9, at
    m <= 100)."""
    g = torch.Generator().manual_seed(seed)
    S = torch.rand(*lead, n, m, generator=g)
    V = 0.3 * torch.randn(*lead, n, m, generator=g)
    Sl = torch.rand(*lead, n, m, generator=g)
    star, bar = torch.rand(n, m, generator=g), torch.rand(n, m, generator=g)
    mask = torch.rand(n, m, generator=g) < 0.8
    r = torch.rand(*lead, 3, generator=g)
    if n > 2:
        mask[0] = False
        S[..., 1, :], V[..., 1, :], Sl[..., 1, :] = 0.0, -1.0, 0.0
        star[1], bar[1] = 0.0, 0.0
        S[..., 2, :] = Sl[..., 2, :] = 1e-11
        V[..., 2, :] = 0.0
        star[2] = bar[2] = 1e-11
    return tuple(t.to(device) for t in (S, V, Sl, star, bar,
                                        mask.to(mask_dtype), r))


def _assert_update_bitwise(args):
    from repro_torch.kernels import pso_update
    pso_update.launches.reset()
    got = pso_update_cuda(*args, **cases.HYPER)
    torch.cuda.synchronize()
    assert pso_update.launches.count == 1      # narrow or wide: one launch
    want = ref.pso_update(*args, **cases.HYPER)
    for name, g, w in zip(("S_new", "V_new"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), (name, int((g != w).sum()))


@pytest.mark.parametrize("lead,n,m", [
    ((64,), 56, 144), ((16,), 13, 57), ((16,), 13, 143), ((8,), 1, 1),
    ((8,), 6, 1), ((8,), 1, 40), ((3, 5), 24, 40), ((3, 5), 7, 31),
    ((2,), 3, 257), ((3, 2), 5, 1100), ((2,), 3, 15000)])
def test_pso_update_bitwise_on_card(device, lead, n, m):
    """S_new and V_new equal ref.pso_update bit for bit: at the main
    path's shape, odd m (the 4-byte path), m = 1 and n = 1, two leading
    dims, empty mask rows and rows whose clamped sum is at most 1e-9;
    past m = 256 (the wide instantiation), its rows in shared memory and,
    at m = 15,000, in S_out."""
    _assert_update_bitwise(_update_case(device, lead, n, m, n * 1000 + m))


@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32,
                                        torch.bool])
def test_pso_update_largest_and_every_mask_dtype_on_card(device,
                                                         mask_dtype):
    _assert_update_bitwise(_update_case(device, (16,), 256, 256, 31,
                                        mask_dtype))
    _assert_update_bitwise(_update_case(device, (64,), 56, 144, 32,
                                        mask_dtype))


def test_pso_update_misaligned_slices_on_card(device):
    """Operands that start 4 bytes past a 16-byte boundary (storage offset
    1) at m % 4 == 0 take the 4-byte path and give the same bits."""
    args = _update_case(device, (8,), 56, 144, 33)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    for k in (0, 1, 2, 3, 4, 6):
        moved = list(args)
        moved[k] = shifted(args[k])
        assert moved[k].storage_offset() == 1
        _assert_update_bitwise(tuple(moved))
    _assert_update_bitwise(tuple(shifted(t) for t in args))


def _assert_greedy_bitwise(S, mask):
    from repro_torch.kernels import argmax_project
    argmax_project.launches_greedy.reset()
    got = greedy_project_cuda(S, mask)
    torch.cuda.synchronize()
    # the wide instantiation packs the mask in a launch of its own
    assert argmax_project.launches_greedy.count == (
        2 if _wide(*S.shape[-2:]) else 1)
    want = ref.greedy_project(S, mask)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())


def _greedy_case(device, lead, n, m, seed, values=None,
                 mask_dtype=torch.uint8, density=0.8):
    """S (lead, n, m) uniform, or drawn from ``values`` (exact ties), and
    an (n, m) mask of the given density."""
    g = torch.Generator().manual_seed(seed)
    if values is None:
        S = torch.rand(*lead, n, m, generator=g)
    else:
        pick = torch.randint(0, len(values), (*lead, n, m), generator=g)
        S = torch.tensor(values, dtype=torch.float32)[pick]
    mask = (torch.rand(n, m, generator=g) < density).to(mask_dtype)
    return S.to(device), mask.to(device)


@pytest.mark.parametrize("lead,n,m", [
    ((64,), 56, 144), ((4,), 256, 256), ((4,), 203, 233), ((2,), 200, 220),
    ((2,), 200, 224), ((3, 5), 24, 40), ((8,), 1, 1), ((8,), 13, 37)])
@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32,
                                        torch.bool])
def test_greedy_project_bitwise_on_card(device, lead, n, m, mask_dtype):
    """M-hat equals ref.greedy_project bit for bit: at the main path's
    shape, at two leading dims and odd shapes, for every mask dtype. S is
    in shared memory up to (200, 220), 228,800 of the block's 232,448
    bytes, and in device memory from (200, 224), 232,800 bytes, through
    (203, 233) and 256 x 256."""
    _assert_greedy_bitwise(*_greedy_case(device, lead, n, m, n + m,
                                         mask_dtype=mask_dtype))


def test_greedy_project_rescans_and_ties_on_card(device):
    """The tie-rich S of test_epoch_finish_greedy_rescans_on_card (every
    row ranks the columns alike, so each round rescans every row left),
    and S from a few values with +0.0 and -0.0 among them (exact ties, to
    the lowest flat index)."""
    n, m = 24, 40
    i = torch.arange(n, device=device, dtype=torch.float32)[:, None]
    j = torch.arange(m, device=device, dtype=torch.float32)[None]
    S = ((m - j) + i / (4 * n)).expand(16, n, m).contiguous()
    _, mask = _greedy_case(device, (1,), n, m, 40)
    _assert_greedy_bitwise(S, torch.ones_like(mask))
    _assert_greedy_bitwise(S, mask)
    for lead, n, m in (((16,), 40, 72), ((64,), 56, 144)):
        _assert_greedy_bitwise(*_greedy_case(
            device, lead, n, m, 41, values=[0.0, -0.0, 0.25, 0.5]))
        _assert_greedy_bitwise(*_greedy_case(
            device, lead, n, m, 42, values=[-0.0, 0.0]))


def test_greedy_project_never_takes_f32_min_or_minus_inf_on_card(device):
    """Entries at finfo(float32).min or -inf are never taken: rows made
    only of them stay empty, and a matrix made only of them is all
    zeros."""
    neg = torch.finfo(torch.float32).min
    S, mask = _greedy_case(device, (16,), 40, 72, 43,
                           values=[neg, float("-inf"), 0.1, 0.2])
    S[:, 3] = neg
    S[:, 4] = float("-inf")
    _assert_greedy_bitwise(S, mask)
    S, mask = _greedy_case(device, (8,), 24, 40, 44,
                           values=[neg, float("-inf")])
    _assert_greedy_bitwise(S, mask)
    assert int(greedy_project_cuda(S, mask).sum()) == 0


def test_greedy_project_more_rows_than_columns_and_empty_rows_on_card(
        device):
    """n > m leaves n - m rows empty; an all-zero mask row stays empty;
    an all-zero mask gives an all-zero M-hat."""
    S, mask = _greedy_case(device, (16,), 40, 24, 45)
    _assert_greedy_bitwise(S, mask)
    _assert_greedy_bitwise(S, torch.ones_like(mask))
    S, mask = _greedy_case(device, (16,), 56, 144, 46)
    mask = mask.clone()
    mask[::5] = 0
    _assert_greedy_bitwise(S, mask)
    _assert_greedy_bitwise(S, torch.zeros_like(mask))
    S, mask = _greedy_case(device, (8,), 30, 60, 47, density=0.05)
    _assert_greedy_bitwise(S, mask)


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


@pytest.mark.parametrize("n,m", [(1, 1), (56, 144), (256, 256),
                                 (300, 400), (257, 771), (1000, 1100)])
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


# -- ullmann_refine_step bit for bit -------------------------------------------

def _refine_case(device, B, n, m, seed, dtype=torch.uint8, fill=None,
                 q_edges=True):
    """B candidate matrices of one (n, m) problem with entries 0..3 (M's
    own values must survive), or all ``fill``; Q a random DAG (no edges
    without ``q_edges``), G a sparse DAG of mean degree ~4."""
    g = torch.Generator().manual_seed(seed)
    if fill is None:
        M = torch.randint(0, 4, (B, n, m), generator=g) * (
            torch.rand(B, n, m, generator=g) < 0.6)
    else:
        M = torch.full((B, n, m), fill)
    Q = torch.triu(torch.rand(n, n, generator=g) < min(0.3, 3.0 / n), 1)
    G = torch.triu(torch.rand(m, m, generator=g) < min(0.4, 4.0 / m), 1)
    if not q_edges:
        Q = torch.zeros_like(Q)
    M = (M != 0) if dtype == torch.bool else M.to(dtype)
    return M.to(device), Q.to(torch.uint8).to(device), \
        G.to(torch.uint8).to(device)


def _assert_refine_bitwise(M, Q, G):
    from repro_torch.kernels import ullmann_refine
    want = ref.ullmann_refine_step(M, Q, G)
    for Qx, Gx in ((Q, G), (Q.int(), G.int()), (Q.bool(), G.int()),
                   (Q.int(), G)):
        ullmann_refine.launches.reset()
        got = ullmann_refine_step_cuda(M, Qx, Gx)
        torch.cuda.synchronize()
        # the wide instantiation packs Q and G in a launch of their own
        assert ullmann_refine.launches.count == (
            2 if _wide(*M.shape[-2:]) else 1)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("B,n,m", [
    (64, 56, 144), (1, 1, 1), (5, 13, 37), (7, 31, 64), (3, 203, 233),
    (2, 256, 256), (9, 40, 72)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.bool])
def test_ullmann_refine_bitwise_on_card(device, B, n, m, dtype):
    """One sweep equals ref.ullmann_refine_step bit for bit for every M
    dtype (M's entries 0..3 kept as they are), every Q / G dtype, at the
    main path's shape, (1, 1, 1), n < 32, odd n and m (the scalar
    write-out), (203, 233) and (256, 256)."""
    _assert_refine_bitwise(*_refine_case(device, B, n, m, B + n + m, dtype))


@pytest.mark.parametrize("fill,q_edges", [(0, True), (1, True), (1, False),
                                          (None, False)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
def test_ullmann_refine_edge_cases_on_card(device, fill, q_edges, dtype):
    """All-zero and all-one M, and a Q with no edges (nothing changes)."""
    for B, n, m in ((8, 56, 144), (3, 13, 37)):
        _assert_refine_bitwise(*_refine_case(device, B, n, m, 7, dtype,
                                             fill=fill, q_edges=q_edges))


def test_ullmann_refine_misaligned_and_sliced_on_card(device):
    """M starting one entry past a 16-byte boundary (the scalar
    write-out at m % 16 == 0), and two leading dims."""
    M, Q, G = _refine_case(device, 6, 56, 144, 41)
    buf = torch.empty(M.numel() + 1, dtype=M.dtype, device=device)
    buf[1:] = M.reshape(-1)
    moved = buf[1:].view(M.shape)
    assert moved.storage_offset() == 1
    _assert_refine_bitwise(moved, Q, G)
    got = ullmann_refine_step_cuda(M.view(2, 3, 56, 144), Q, G)
    assert torch.equal(got.view(M.shape), ref.ullmann_refine_step(M, Q, G))


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


# -- past n, m = 256: epoch_fused's cluster step, epoch_finish's staged
# particle kernel ----------------------------------------------------------

#: (P, N, n, m, K): rows a rank that do not divide n and m % 4 != 0
#: (301, 417); m % 4 == 2 and m % 32 != 0 (300, 530); phase 4f's bucket;
#: the scheduler's window-8 bucket on the 512-engine platform (56, 528),
#: on clusters at 32 particles
REDESIGNED = [(1, 8, 301, 417, 2), (2, 8, 300, 530, 2), (1, 8, 312, 528, 2),
              (2, 16, 56, 528, 3)]


def _boundary(takes, n, m0):
    """The largest m >= m0 at which ``takes(n, m)`` holds and the first
    past it (m0 must take it)."""
    assert takes(n, m0), (n, m0)
    m = m0
    while takes(n, m + 1):
        m += 1
    return m, m + 1


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", REDESIGNED)
def test_epoch_fused_redesigned_shapes_bitwise_on_card(device, shape,
                                                       quantized):
    """Every output bit for bit at the shapes of the cluster path's edge
    cases, whichever step kernel each takes."""
    from repro_torch.kernels import epoch_fused
    P, N, n, m, K = shape
    if n > 256:
        assert epoch_fused.path(P, N, n, m, quantized) > 0, shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 31))
    x = cases.swarm_inputs(Q, G, mask, N, K, seed=32)
    _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


@pytest.mark.parametrize("quantized", [False, True])
def test_epoch_fused_cluster_path_edge_on_card(device, quantized):
    """The largest m at n = 312 that the cluster path takes and the first
    it does not (no cluster there), bit for bit."""
    from repro_torch.kernels import epoch_fused
    last, first = _boundary(
        lambda n, m: epoch_fused.path(1, 4, n, m, quantized) > 0, 312, 528)
    assert epoch_fused.path(1, 4, 312, first, quantized) <= 0
    for m in (last, first):
        Q, G, mask = (t.to(device) for t in cases.random_problem(1, 312, m,
                                                                 33))
        x = cases.swarm_inputs(Q, G, mask, 4, 2, seed=33)
        _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


#: (n, m) at which the rule takes clusters of 2, 4 and 8, by branch
CLUSTER_SIZES = {True: {2: (128, 400), 4: (300, 400), 8: (312, 528)},
                 False: {2: (56, 528), 4: (128, 528), 8: (300, 400)}}


@pytest.mark.parametrize("quantized", [False, True])
def test_epoch_fused_every_cluster_size_on_card(device, quantized):
    """Clusters of 2, 4 and 8, each at a shape where the rule picks it:
    bit for bit each."""
    from repro_torch.kernels import epoch_fused
    for C, (n, m) in CLUSTER_SIZES[quantized].items():
        assert epoch_fused.path(2, 8, n, m, quantized) == C, (n, m)
        Q, G, mask = (t.to(device) for t in cases.random_problem(2, n, m,
                                                                 34))
        x = cases.swarm_inputs(Q, G, mask, 8, 2, seed=34)
        _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


#: (P, N, n, m, quantized, path): each side of the rule between the
#: cluster step and step_kernel (clusters where step_kernel's tiles fit in
#: shared memory only up to 64 particles and from n = 40; quantized with
#: the tiles in scratch below n = 128 only up to 128 particles)
RULE_CASES = [(1, 64, 56, 528, True, 2), (2, 64, 56, 528, True, 0),
              (1, 64, 8, 400, True, 0), (2, 64, 96, 528, True, 2),
              (4, 64, 96, 528, True, 0), (1, 64, 40, 400, False, 2),
              (2, 64, 40, 400, False, 0)]


@pytest.mark.parametrize("case", RULE_CASES)
def test_epoch_fused_rule_by_particles_on_card(device, case):
    """The step kernel the rule picks by the launch's particles, bit for
    bit either way."""
    from repro_torch.kernels import epoch_fused
    P, N, n, m, quantized, want = case
    assert epoch_fused.path(P, N, n, m, quantized) == want, case
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 41))
    x = cases.swarm_inputs(Q, G, mask, N, 2, seed=41)
    _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("K", [0, 1])
def test_epoch_fused_cluster_short_epochs_on_card(device, K, quantized):
    Q, G, mask = (t.to(device) for t in cases.random_problem(2, 300, 400,
                                                             35))
    x = cases.swarm_inputs(Q, G, mask, 8, K, seed=35)
    _assert_epoch_bitwise(_epoch_args(x, mask, Q, G), quantized)


@pytest.mark.parametrize("quantized", [False, True])
def test_epoch_fused_cluster_empty_row_and_ties_on_card(device, quantized):
    """On the cluster path: a mask row with no candidate (the uniform and
    integer fallbacks), then equal local bests (the first index wins)."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(2, 301, 417,
                                                             36))
    x = cases.swarm_inputs(Q, G, mask, 8, 3, seed=36)
    empty = mask.clone()
    empty[:, 150] = 0
    _assert_epoch_bitwise(_epoch_args(x, empty, Q, G), quantized)
    x["f_local"] = torch.zeros_like(x["f_local"])     # above any fitness
    args = _epoch_args(x, mask, Q, G)
    _assert_epoch_bitwise(args, quantized)
    _, star, _, _, _ = epoch_fused_cuda(*args, quantized=quantized,
                                        **cases.HYPER)
    assert torch.equal(star, x["S"][:, 0])


@pytest.mark.parametrize("tau", [0.0, 0.3])
@pytest.mark.parametrize("shape", REDESIGNED)
def test_epoch_finish_staged_bitwise_on_card(device, shape, tau):
    """The staged particle kernel at the redesigned shapes, with and
    without Gumbel noise."""
    from repro_torch.kernels import finish_fused
    P, N, n, m, _ = shape
    assert finish_fused.path(n, m) == 1, shape
    _assert_finish_bitwise(*_finish_case(device, P, N, n, m, 37), tau=tau)


@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_epoch_finish_staged_edge_on_card(device, tau):
    """The largest n at m = 528 that the staged kernel takes and the
    first it does not (the wide kernel there)."""
    from repro_torch.kernels import finish_fused
    last, first = _boundary(lambda m, n: finish_fused.path(n, m) == 1, 528,
                            312)
    assert finish_fused.path(first, 528) == 2
    for n in (last, first):
        _assert_finish_bitwise(*_finish_case(device, 1, 4, n, 528, 38),
                               tau=tau)


@pytest.mark.parametrize("tau", [0.0, 0.3])
def test_epoch_finish_staged_ties_empty_rows_and_rescans_on_card(device,
                                                                 tau):
    """On the staged kernel: S from a set of 4 values with an all-zero
    mask row, then every row ranking the columns alike (each greedy
    round rescans every row left)."""
    S, f, gum, mask, Q, G = _finish_case(device, 2, 8, 300, 530, 39,
                                         tie_values=[0.1, 0.2, 0.3, 0.4])
    mask = mask.clone()
    mask[:, 7] = 0
    S = S * (mask[:, None] != 0)
    _assert_finish_bitwise(S, f, gum, mask, Q, G, tau=tau)
    i = torch.arange(300, device=device, dtype=torch.float32)[:, None]
    j = torch.arange(530, device=device, dtype=torch.float32)[None]
    S = ((530 - j) + i / 1200).expand(2, 8, 300, 530).contiguous()
    _assert_finish_bitwise(S, f, gum, torch.ones_like(mask), Q, G, tau=tau)


@pytest.mark.parametrize("elite_k", [1, 5, 8])
@pytest.mark.parametrize("shape", [(2, 8, 56, 528), (2, 8, 300, 400),
                                   (1, 8, 1000, 1100)])
def test_epoch_finish_wide_consensus_bitwise_on_card(device, shape,
                                                     elite_k):
    """Past 256 S̄ takes the plain version's order of operations on the
    card, so it equals it bit for bit (planted singleton rows hold 1.0
    in every particle, where another order drifts by an ulp)."""
    from repro_torch.kernels.finish_fused import epoch_finish_reference
    P, N, n, m = shape
    S, f, _, mask, Q, G = _finish_case(device, P, N, n, m, 0)
    kw = dict(gumbel_tau=0.0, refine_threshold=0.5, refine_iters=1,
              elite_k=elite_k, consensus_temp=25.0)
    got = epoch_finish_cuda(S, f, None, mask, Q, G, **kw)[2]
    want = epoch_finish_reference(S, f, None, mask, Q, G, **kw)[2]
    assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.parametrize("refine_iters", [0, 1])
def test_epoch_finish_staged_short_refinement_on_card(device, refine_iters):
    _assert_finish_bitwise(*_finish_case(device, 2, 8, 301, 417, 40),
                           tau=0.0, refine_iters=refine_iters)


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


# -- past n, m = 256: the two fitness bodies split by rows ------------------

#: (P, N, n, m): WIDE_SHAPES's problems, wide by n alone (257, 200), n not
#: a multiple of 16 with m not of 32 (301, 417), m not of 4 (299, 530),
#: and the wide bucket's swarm (312, 528)
FITNESS_ROW_SPLIT = [(P, N, n, m) for P, N, n, m, _ in WIDE_SHAPES] + [
    (1, 8, 257, 200), (2, 8, 301, 417), (1, 6, 299, 530), (1, 64, 312, 528)]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("shape", FITNESS_ROW_SPLIT)
def test_fitness_row_split_bitwise_on_card(device, shape, quantized):
    """Both wide bodies bit for bit on a random swarm; the quantized one
    also on uniform uint8 tiles (S G past 2^8: two byte planes)."""
    P, N, n, m = shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 51))
    x = cases.swarm_inputs(Q, G, mask, N, 1, seed=51)
    if not quantized:
        _assert_fitness_f32_bitwise(x["S"], Q, G)
        return
    _assert_fitness_u8_bitwise(x["S_q"], Q, G)
    gen = torch.Generator(device=device).manual_seed(52)
    _assert_fitness_u8_bitwise(
        torch.randint(0, 256, x["S_q"].shape, dtype=torch.uint8,
                      device=device, generator=gen), Q, G)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("n,m", [(312, 528), (56, 528)])
def test_fitness_row_split_projection_tile_on_card(device, n, m, quantized):
    """The Tier-0 call past 256: N = 1 on a projection's 0/255 tile (0/1
    for the float body)."""
    Q, G, mask = (t.to(device) for t in cases.random_problem(2, n, m, 53))
    x = cases.swarm_inputs(Q, G, mask, 1, 1, seed=53)
    tile = ref.greedy_project(x["S"][:, 0], mask).float()[:, None]
    if quantized:
        _assert_fitness_u8_bitwise(ref.quantize_s(tile), Q, G)
    else:
        _assert_fitness_f32_bitwise(tile, Q, G)


@pytest.mark.parametrize("n", [16, 33, 312])
def test_fitness_row_split_largest_sums_on_card(device, n):
    """m = 528, a dense G: the all-255 tile (S G = 134,640, three byte
    planes; S G S^T ~1.8e10; the squares wrap in 64 bits as the plain
    version's int64 arithmetic does), and the all-one float tile."""
    m = 528
    Q = cases.random_problem(1, n, m, 54)[0].to(device)
    G = torch.ones(1, m, m, dtype=torch.uint8, device=device)
    _assert_fitness_u8_bitwise(
        torch.full((1, 2, n, m), 255, dtype=torch.uint8, device=device), Q, G)
    _assert_fitness_f32_bitwise(torch.ones(1, 2, n, m, device=device), Q, G)


#: (P, N, n, m, quantized, path, name): each wide body the rule picks,
#: with the name ``pso_fitness.instantiation`` gives it: the quantized
#: row split at 16 and 32 rows a CTA, the float one at small and large n,
#: and in each mode one CTA a particle past the split's shared memory
FITNESS_RULE_CASES = [
    (1, 1, 312, 528, True, 16, "fitness_u8_rows_kernel<1>"),
    (1, 64, 312, 528, True, 32, "fitness_u8_rows_kernel<2>"),
    (1, 2, 8, 7300, True, -1, "fitness_u8_wide_kernel"),
    (1, 1, 312, 528, False, 12, "fitness_rows_kernel"),
    (1, 2, 512, 512, False, 8, "fitness_rows_kernel"),
    (8, 64, 8, 528, False, 8, "fitness_rows_kernel"),
    (2, 64, 40, 528, False, 32, "fitness_rows_kernel"),
    (1, 2, 8, 7300, False, -1, "fitness_wide_kernel<*>")]


@pytest.mark.parametrize("case", FITNESS_RULE_CASES)
def test_fitness_row_split_every_instantiation_on_card(device, case):
    """Each body the rule can pick past 256, named, bit for bit."""
    from repro_torch.kernels import pso_fitness
    P, N, n, m, quantized, want, name = case
    assert pso_fitness.path(P, N, n, m, quantized) == want, case
    assert pso_fitness.instantiation(P, N, n, m,
                                     quantized).startswith(name), case
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 55))
    x = cases.swarm_inputs(Q, G, mask, N, 1, seed=55)
    if quantized:
        _assert_fitness_u8_bitwise(x["S_q"], Q, G)
    else:
        _assert_fitness_f32_bitwise(x["S"], Q, G)


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


def test_service_snapshot_roundtrip_on_card(device, tmp_path, monkeypatch):
    """A warm service's snapshot: its save makes exactly one host sync
    (one ``persist.to_host`` with the pooled carries, under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    other blocking transfer); a fresh service restores it into its pool
    on the card, the round trip is bitwise, and the restored service
    serves the warm requests at Tier 0 with the same mappings."""
    from repro_torch.core import persist
    from repro_torch.core.service import MatcherService
    cfg = pso.PSOConfig(num_particles=24, epochs=3, inner_steps=8,
                        quantized=True)
    svc = MatcherService(cfg, device="cuda", persist_dir=str(tmp_path))
    specs = _service_specs()
    _drain(svc, specs)
    warm = _drain(svc, specs)
    waits = []
    to_host = persist.to_host

    def counted(leaves):
        waits.append(sum(torch.is_tensor(x) and x.is_cuda
                         for x in leaves.values()))
        return to_host(leaves)
    monkeypatch.setattr(persist, "to_host", counted)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step = svc.save_snapshot()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(waits) == 1 and waits[0] == 3 * (
        len(svc._carries) + svc._carries.sim_entries)
    fresh = MatcherService(cfg, device="cuda", persist_dir=str(tmp_path))
    assert fresh.restore_snapshot(step) == {}
    assert fresh.stats.restored_carries == len(svc._carries)
    assert all(slab["S"].is_cuda for slab in fresh._pool._slabs.values())
    monkeypatch.setattr(persist, "to_host", to_host)
    assert fresh.verify_snapshot_roundtrip()
    served = [(sp, r) for sp, r in zip(specs, warm)
              if r.tier == 0 and r.found]
    assert served
    again = _drain(fresh, [sp for sp, _ in served])
    for (_, r), a in zip(served, again):
        assert a.tier == 0 and a.found
        assert (a.mapping == r.mapping).all()


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


# ------------------------- the distributed matcher -------------------------

MESH_SCRIPT = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.core import pso
from repro_torch.core.matcher import (build_distributed_match,
                                      build_distributed_match_batch)
from repro_torch.kernels import cases
from repro_torch.launch import mesh as mesh_lib

mode, rank, world, store, out_path = sys.argv[1:6]
rank, world = int(rank), int(world)
torch.backends.cuda.matmul.allow_tf32 = False
Qb, Gb, Mb = (t.cuda() for t in cases.random_problem(4, 20, 40, 3))
cfg = pso.PSOConfig(num_particles=32, epochs=3, inner_steps=6,
                    quantized=True, early_exit=True)
out = {}
if mode == "world1":
    for backend in ("nccl", "gloo"):
        mesh_lib.init_group(backend, init_method=f"file://{store}.{backend}",
                            rank=0, world_size=1, device="cuda",
                            timeout_s=60)
        mesh = mesh_lib.make_host_mesh(1, 1, backend=backend, device="cuda")
        fn = build_distributed_match((20, 40), mesh, cfg, ("data",))
        for b in range(4):
            for k, v in fn([10 + b], Qb[b], Gb[b], Mb[b]).items():
                out[f"{backend}.{b}.{k}"] = np.asarray(
                    v.cpu() if torch.is_tensor(v) else v)
        dist.destroy_process_group()
else:
    mesh_lib.init_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world, device="cuda", timeout_s=60)
    mesh = mesh_lib.make_host_mesh(world, 1, backend="gloo", device="cuda")
    fn = build_distributed_match_batch((20, 40), mesh, cfg, ("data",), 4)
    for k, v in fn([10 + b for b in range(4)], Qb, Gb, Mb).items():
        out[k] = np.asarray(v.cpu() if torch.is_tensor(v) else v)
np.savez(out_path, **out)
print("MESH-OK")
"""


def _mesh_run(tmp_path, mode, world):
    import os
    import subprocess
    import sys
    from repro_torch.launch import mesh as mesh_lib
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmds = [[sys.executable, "-c", MESH_SCRIPT, mode, str(r), str(world),
             str(tmp_path / "store"), str(tmp_path / f"r{r}.npz")]
            for r in range(world)]
    for _, so, se in mesh_lib.run_ranks(cmds, timeout_s=300, env=env):
        assert "MESH-OK" in so, se[-4000:]
    import numpy as np
    return [dict(np.load(tmp_path / f"r{r}.npz")) for r in range(world)]


def _single_batch(device):
    Qb, Gb, Mb = (t.to(device) for t in cases.random_problem(4, 20, 40, 3))
    cfg = pso.PSOConfig(num_particles=32, epochs=3, inner_steps=6,
                        quantized=True, early_exit=True)
    return pso.match_batch(Qb, Gb, Mb, cfg, streams=[10 + b for b in range(4)])


def test_mesh_world_of_one_nccl_equals_gloo_on_card(device, tmp_path):
    """A world of one over NCCL and over gloo on CUDA tensors gives the
    same bits, and the single-device ``match_batch``'s outcomes."""
    out = _mesh_run(tmp_path, "world1", 1)[0]
    for k in (k for k in out if k.startswith("nccl.")):
        assert (out[k] == out["gloo." + k[5:]]).all(), k
    want = _single_batch(device)
    for b in range(4):
        assert int(out[f"nccl.{b}.epochs_run"]) == int(want["epochs_run"][b])
        assert bool(out[f"nccl.{b}.feasible"].any()) == \
            bool(want["feasible"][:, b].any())


def test_mesh_problem_axis_batch_on_card(device, tmp_path):
    """Two ranks on the one card (gloo on CUDA tensors): the problem-axis
    ``match_batch`` is the single-device one bit for bit, on both."""
    outs = _mesh_run(tmp_path, "batch", 2)
    want = _single_batch(device)
    for out in outs:
        for k, v in want.items():
            if k != "host_syncs":
                assert (out[k] == v.cpu().numpy()).all(), k


def test_lm_serve_on_card_equals_the_cpu(device):
    """qwen2.5-3b at the reference smoke tests' size (4 query heads over 2
    KV heads, QKV bias, float32), served on the card and on the CPU with
    the same weights: every step's logits within rtol 2e-4 / atol 2e-4,
    the same greedy tokens, and the same train logits."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prompt_batch, serve
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import (build_model, params_from_numpy,
                                    params_to_numpy)
    cfg = tiny_config(get_config("qwen2.5-3b"))
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = params_from_numpy(build_model(cfg, device=device),
                             params_to_numpy(cpu))
    want = serve(cpu, batch=4, prompt_len=16, gen=9, seed=1)
    got = serve(card, batch=4, prompt_len=16, gen=9, seed=1)
    assert torch.equal(got["tokens"].cpu(), want["tokens"])
    for g, w in zip(got["logits"], want["logits"]):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=2e-4)
    batch = prompt_batch(cpu, 4, 16, seed=2)
    with torch.no_grad():
        torch.testing.assert_close(
            card.train_logits({k: v.to(device) for k, v in
                               batch.items()}).cpu(),
            cpu.train_logits(batch), rtol=2e-4, atol=2e-4)


def test_lm_train_step_on_card_equals_the_cpu(device):
    """qwen2-vl-7b at the reference smoke tests' size (patches, M-RoPE
    positions, float32): one adamw step of two microbatches on the card
    and on the CPU from the same weights and batch: loss and grad norm
    within rtol 1e-5, every gradient leaf within 1e-4 of its largest
    |g|, every parameter within 2e-6 after the step but where Adam
    flipped a near-zero gradient's sign (within 2·lr, at most 1e-3 of
    them)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import tiny_config
    from repro_torch.models import (build_model, params_from_numpy,
                                    params_to_numpy)
    from repro_torch.optim.adamw import at
    from repro_torch.runtime.train_loop import (make_train_state,
                                                make_train_step)
    cfg = tiny_config(get_config("qwen2-vl-7b"))
    weights = params_to_numpy(build_model(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, 256, (4, 16), generator=gen),
             "labels": torch.randint(-1, 256, (4, 16), generator=gen),
             "patches": torch.randn((4, 8, 64), generator=gen),
             "positions3": torch.arange(24).expand(3, 4, 24).clone()}
    tcfg = TrainConfig(microbatches=2, learning_rate=1e-3, warmup_steps=1,
                       total_steps=10)
    runs = {}
    for dev in ("cpu", device):
        model = params_from_numpy(build_model(cfg, device=dev), weights)
        step = make_train_step(model, tcfg)
        _, m = step(make_train_state(model, tcfg),
                    {k: v.to(dev) for k, v in batch.items()})
        runs[str(dev)] = (m, [g.cpu() for g in step.grads],
                          params_to_numpy(model), step.leaves)
    (mw, gw, pw, leaves), (mg, gg, pg, _) = runs["cpu"], runs[str(device)]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(mg[k]), float(mw[k]), rtol=1e-5)
    flips = total = 0
    for leaf, a, b in zip(leaves, gg, gw):
        assert float((a - b).abs().max()) <= \
            1e-4 * float(b.abs().max()) + 1e-6, leaf.path
        d = np.abs(at(pg, leaf.path) - at(pw, leaf.path))
        assert d.max() <= 2 * tcfg.learning_rate + 2e-6, leaf.path
        flips += int((d > 2e-6).sum())
        total += d.size
    assert flips <= 1e-3 * total
