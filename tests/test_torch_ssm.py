"""The port's recurrent blocks (``repro_torch.models.ssm``) against the
JAX package's on the same inputs and weights, on the CPU: the
chunkwise gated-linear-attention core with and without a carried state,
its one-step form, the causal conv, and the Mamba2, mLSTM and sLSTM
blocks with and without caches, at the reference smoke tests' reduced
configs (``tests/test_smoke_archs.py`` ``reduce_config``: d_model 64,
chunk 8, Mamba2 state 8), float32 within rtol 1e-5 / atol 1e-5 (the
blocks' outputs rtol 1e-4 / atol 1e-5: they sum many products),
bfloat16 states within one rounding. One case a block at the configs'
bfloat16 compute, within ``BF16_TOL``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from test_smoke_archs import reduce_config
from test_torch_models import TOL, B, close, port_cfg
from test_torch_moe import BF16_CACHE, pair
from test_torch_serve import BF16_TOL

jax.config.update("jax_platform_name", "cpu")

BLOCK_TOL = dict(rtol=1e-4, atol=1e-5)
H, DK, DV = 4, 8, 6
#: the reference's core, jitted (eager, its scan compiles at every call)
jchunked_gla = jax.jit(jssm.chunked_gla, static_argnums=4)


def gla_inputs(seed, S, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, S, H, DK)).astype(dtype)
            for _ in range(2))
    v = rng.standard_normal((B, S, H, DV)).astype(dtype)
    # log forget gates ≤ 0, some near 0 (long memory), some large
    log_f = -np.logaddexp(0, rng.standard_normal((B, S, H)) * 3)
    return q, k, v, log_f.astype(np.float32)


def j(*xs):
    return [jnp.asarray(x) for x in xs]


def t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


# ---------------------------------------------------------------------------
# the core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24), (16, 64)])
def test_chunked_gla_without_state(S, chunk):
    q, k, v, log_f = gla_inputs(0, S)
    want, wstate = jchunked_gla(*j(q, k, v, log_f), chunk)
    got, gstate = tssm.chunked_gla(*t(q, k, v, log_f), chunk)
    close(got, want)
    close(gstate, wstate)
    assert gstate.dtype == torch.float32


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_chunked_gla_with_state(state_dtype):
    """The carried state enters at the compute dtype and leaves at its
    own (a bfloat16 cache)."""
    q, k, v, log_f = gla_inputs(1, 32)
    s0 = np.random.default_rng(2).standard_normal((B, H, DK, DV))
    js0 = jnp.asarray(s0, jnp.float32).astype(state_dtype)
    ts0 = torch.from_numpy(s0.astype(np.float32)).to(getattr(torch,
                                                             state_dtype))
    want, wstate = jchunked_gla(*j(q, k, v, log_f), 8, js0)
    got, gstate = tssm.chunked_gla(*t(q, k, v, log_f), 8, ts0)
    close(got, want)
    assert gstate.dtype == ts0.dtype
    close(gstate, wstate, TOL if state_dtype == "float32" else BF16_CACHE)


def test_chunked_gla_raises_where_the_reference_asserts():
    q, k, v, log_f = gla_inputs(3, 12)
    with pytest.raises(AssertionError):
        jssm.chunked_gla(*j(q, k, v, log_f), 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.chunked_gla(*t(q, k, v, log_f), 8)


def test_chunked_gla_masks_the_decay_before_it_multiplies():
    """Forget gates of −200 a step: the decay above the diagonal is
    exp(+…) = inf, and an unmasked inf·0 would make NaNs."""
    q, k, v, _ = gla_inputs(4, 16)
    log_f = np.full((B, 16, H), -200.0, np.float32)
    want, _ = jchunked_gla(*j(q, k, v, log_f), 16)
    got, _ = tssm.chunked_gla(*t(q, k, v, log_f), 16)
    assert torch.isfinite(got).all()
    close(got, want)


def test_chunked_gla_gradient_is_finite_where_the_decay_overflows():
    """Forget gates of −6 a step over a chunk of 32: the decay above the
    diagonal overflows to inf, and the reference's gradient there is NaN
    (exp's backward meets 0·inf). The port masks the decay before the
    exp: its gradients (q, k, v and the gates) equal the reference's at
    a chunk of 8, where nothing overflows (the same function)."""
    q, k, v, _ = gla_inputs(5, 32)
    log_f = np.full((B, 32, H), -6.0, np.float32)

    def ref(*xs):
        return jchunked_gla(*xs, 8)[0].sum()
    want = jax.grad(ref, argnums=(0, 1, 2, 3))(*j(q, k, v, log_f))
    ins = [x.requires_grad_() for x in t(q, k, v, log_f)]
    tssm.chunked_gla(*ins, 32)[0].sum().backward()
    for x, w in zip(ins, want):
        assert torch.isfinite(x.grad).all()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_gla_step_is_one_step_of_chunked_gla():
    q, k, v, log_f = gla_inputs(5, 1)
    s0 = np.random.default_rng(6).standard_normal(
        (B, H, DK, DV)).astype(np.float32)
    one, one_state = tssm.chunked_gla(*t(q, k, v, log_f, s0[None])[:4], 8,
                                      torch.from_numpy(s0))
    got, gstate = tssm.gla_step(*t(s0, q[:, 0], k[:, 0], v[:, 0],
                                   log_f[:, 0]))
    want, wstate = jssm.gla_step(*j(s0, q[:, 0], k[:, 0], v[:, 0],
                                    log_f[:, 0]))
    close(got, want)
    close(gstate, wstate)
    close(got, one[:, 0])
    close(gstate, one_state)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv(with_cache):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    cache = rng.standard_normal((B, 3, 12)).astype(np.float32) \
        if with_cache else None
    want, wc = jssm._causal_conv(*j(x, w, b), None if cache is None
                                 else jnp.asarray(cache))
    got, gc = tssm._causal_conv(*t(x, w, b), None if cache is None
                                else torch.from_numpy(cache))
    close(got, want)
    if with_cache:
        close(gc, wc)
    else:
        assert gc is None and wc is None


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

#: kind → (arch, reference init, reference block, port module, reference
#: cache init, port cache init)
BLOCKS = {
    "mamba2": ("zamba2-7b", jssm.init_mamba2, jssm.mamba2_block,
               tssm.Mamba2, jssm.init_mamba2_cache, tssm.init_mamba2_cache),
    "mlstm": ("xlstm-1.3b", jssm.init_mlstm, jssm.mlstm_block, tssm.MLSTM,
              jssm.init_mlstm_cache, tssm.init_mlstm_cache),
    "slstm": ("xlstm-1.3b", jssm.init_slstm, jssm.slstm_block, tssm.SLSTM,
              lambda cfg, b: jssm.init_slstm_cache(cfg, b),
              lambda cfg, b: tssm.init_slstm_cache(cfg, b)),
}


def block_pair(kind, seed=0, **overrides):
    """(reference config, params and block (jitted), the port's module,
    both cache initialisers), the float32 constants of the init
    perturbed."""
    arch, init_j, block_j, cls, jcache, tcache = BLOCKS[kind]
    block_j = jax.jit(block_j, static_argnums=1)
    jcfg, jp, m = pair(arch, init_j, cls, **overrides)
    rng = np.random.default_rng(seed)
    for name in ("A_log", "D", "dt_bias", "if_bias", "bias"):
        if name in jp:
            jp[name] = jnp.asarray(
                np.asarray(jp[name]) + 0.3 * rng.standard_normal(
                    jp[name].shape).astype(np.float32))
            with torch.no_grad():
                getattr(m, name).copy_(torch.from_numpy(np.array(
                    jp[name])).reshape(getattr(m, name).shape))
    return jcfg, jp, m, block_j, jcache, tcache


def check_cache(got, want, tol):
    assert set(got) == set(want)
    for k in got:
        g, w = got[k], want[k]
        assert g.dtype == getattr(torch, str(w.dtype)), k
        close(g, w, BF16_CACHE if g.dtype == torch.bfloat16 else tol)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_without_cache(kind):
    jcfg, jp, m, block_j, _, _ = block_pair(kind)
    x = np.random.default_rng(8).standard_normal(
        (B, 16, jcfg.d_model)).astype(np.float32)
    want, wc = block_j(jp, jcfg, jnp.asarray(x))
    got, gc = m(torch.from_numpy(x))
    assert gc is None and wc is None
    close(got, want, BLOCK_TOL)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_prefill_then_decode(kind):
    """16 positions into fresh caches (the chunked form, two chunks),
    then two single steps (the recurrent form), each fed the reference's
    cache of the step before."""
    jcfg, jp, m, block_j, jcache_init, tcache_init = block_pair(kind, 1)
    rng = np.random.default_rng(9)
    jc = jcache_init(jcfg, B)
    for s in (16, 1, 1):
        x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
        tc = {k: torch.from_numpy(np.array(v, np.float32)).to(
            tcache_init(m.cfg, B)[k].dtype) for k, v in jc.items()}
        want, jc = block_j(jp, jcfg, jnp.asarray(x), jc)
        got, gc = m(torch.from_numpy(x), tc)
        assert gc is tc
        close(got, want, BLOCK_TOL)
        check_cache(gc, jc, BLOCK_TOL)


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_bfloat16_compute(kind):
    """The configs' own bfloat16 compute (parameters float32): prefill
    and one step, each side on its own caches, within ``BF16_TOL``."""
    jcfg, jp, m, block_j, jcache_init, tcache_init = block_pair(
        kind, 2, compute_dtype="bfloat16")
    rng = np.random.default_rng(10)
    jc, tc = jcache_init(jcfg, B), tcache_init(m.cfg, B)
    for s in (16, 1):
        x = rng.standard_normal((B, s, jcfg.d_model)).astype(np.float32)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        want, jc = block_j(jp, jcfg, xb, jc)
        got, tc = m(torch.from_numpy(x).to(torch.bfloat16), tc)
        assert got.dtype == torch.bfloat16
        close(got, want, BF16_TOL)
