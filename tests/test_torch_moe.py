"""The port's MoE FFN and MLA (``repro_torch.models.moe`` and
``repro_torch.models.attention.MLA``) against the JAX package's on the
same inputs and weights, on the CPU, float32, at the reference smoke
tests' reduced configs (``tests/test_smoke_archs.py`` ``reduce_config``:
d_model 64, 8 experts top-2, expert width 32, MLA ranks 16 / 24):
outputs within rtol 1e-5 / atol 1e-5, bfloat16 caches within one
rounding. Weights go across as numpy arrays through
``params_from_numpy``; inputs are made from a numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models.model import params_from_numpy
from test_smoke_archs import reduce_config
from test_torch_models import TOL, B, close, port_cfg

jax.config.update("jax_platform_name", "cpu")

#: a bfloat16 cache entry: equal, or one rounding apart
BF16_CACHE = dict(rtol=2 ** -7, atol=1e-6)


def perturb(tree, rng):
    """Norm scales away from their init's ones, so that they count."""
    for k, v in tree.items():
        if isinstance(v, dict):
            perturb(v, rng)
        elif k == "scale":
            tree[k] = (1 + 0.1 * rng.standard_normal(v.shape)
                       ).astype(np.float32)
    return tree


def pair(arch, init_j, cls, **overrides):
    """(reference config, reference params, the port's module) on the
    same weights."""
    jcfg = reduce_config(jget_config(arch)).replace(**overrides)
    tree = perturb(jax.tree.map(np.array, init_j(jax.random.PRNGKey(3),
                                                 jcfg)),
                   np.random.default_rng(3))
    m = cls(port_cfg(jcfg), generator=torch.Generator().manual_seed(0))
    params_from_numpy(m, tree)
    return jcfg, jax.tree.map(jnp.asarray, tree), m


def dropped_by_the_reference(jp, jcfg, x):
    """Assignments past capacity, counted in numpy from the reference's
    router: each token's top-k experts in token order, every expert's
    count past C."""
    m = jcfg.moe
    xf = np.asarray(x).reshape(-1, x.shape[-1])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(xf) @ jp["router"], -1))
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :m.top_k]
    counts = np.bincount(top_e.reshape(-1), minlength=m.num_experts)
    C = jmoe._capacity(xf.shape[0], m)
    return int(np.maximum(counts - C, 0).sum())


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [
    "deepseek-v2-236b",                        # a shared expert
    "arctic-480b",                             # the dense residual
])
def test_moe_ffn(arch):
    jcfg, jp, m = pair(arch, jmoe.init_moe, tmoe.MoE)
    assert m.router.dtype == torch.float32
    x = np.random.default_rng(4).standard_normal(
        (B, 16, jcfg.d_model)).astype(np.float32)
    want = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    got = m(torch.from_numpy(x))
    close(got, want)
    assert int(m.last_dropped) == dropped_by_the_reference(jp, jcfg, x) == 0


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "arctic-480b"])
def test_moe_ffn_with_overflow_drops(arch):
    """Capacity factor 0.25: C = 8 slots an expert for 64 tokens top-2,
    so assignments overflow and are dropped, as the reference drops
    them."""
    moe = reduce_config(jget_config(arch)).moe
    jcfg, jp, m = pair(arch, jmoe.init_moe, tmoe.MoE,
                       moe=dataclasses.replace(moe, capacity_factor=0.25))
    x = np.random.default_rng(5).standard_normal(
        (B, 32, jcfg.d_model)).astype(np.float32)
    assert jmoe._capacity(B * 32, jcfg.moe) == tmoe._capacity(
        B * 32, m.cfg.moe) == 8
    want = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x))
    got = m(torch.from_numpy(x))
    close(got, want)
    dropped = dropped_by_the_reference(jp, jcfg, x)
    assert dropped > 0 and int(m.last_dropped) == dropped


@pytest.mark.parametrize("tokens", [1, 4, 36, 64, 1000])
def test_capacity(tokens):
    for arch in ("deepseek-v2-236b", "arctic-480b"):
        jm = jget_config(arch).moe
        tm = port_cfg(jget_config(arch)).moe
        assert tmoe._capacity(tokens, tm) == jmoe._capacity(tokens, jm)


def test_router_aux_loss():
    jcfg, jp, m = pair("deepseek-v2-236b", jmoe.init_moe, tmoe.MoE)
    x = np.random.default_rng(6).standard_normal(
        (B, 16, jcfg.d_model)).astype(np.float32)
    want = jmoe.router_aux_loss(jp, jcfg, jnp.asarray(x))
    close(tmoe.router_aux_loss(m, torch.from_numpy(x)), want)


def test_expert_init_draws_the_dense_init_distribution():
    """Drawn an expert at a time: each slice a truncated normal of
    σ = 1/√fan_in on its own fan-in axis."""
    g = torch.Generator().manual_seed(0)
    w = tmoe._expert_init((4, 256, 64), torch.float32, 1, generator=g)
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-7
    assert abs(float(w.std()) - 0.8796 / 16) < 2e-3
    assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def positions(s, offset=0):
    return np.ascontiguousarray(np.broadcast_to(
        np.arange(offset, offset + s, dtype=np.int32), (B, s)))


def test_mla_without_cache():
    jcfg, jp, m = pair("deepseek-v2-236b", jattn.init_mla, tattn.MLA)
    x = np.random.default_rng(7).standard_normal(
        (B, 12, jcfg.d_model)).astype(np.float32)
    want, _ = jattn.mla_attention(jp, jcfg, jnp.asarray(x),
                                  jnp.asarray(positions(12)))
    got, cache = m(torch.from_numpy(x), torch.from_numpy(positions(12)))
    assert cache is None
    close(got, want)


def test_mla_with_cache_prefill_then_decode():
    """Twelve positions into an empty buffer at 0, then one at 12: the
    latents cached in bfloat16, K and V expanded from the whole buffer."""
    jcfg, jp, m = pair("deepseek-v2-236b", jattn.init_mla, tattn.MLA)
    rng = np.random.default_rng(8)
    jcache = jattn.init_mla_cache(jcfg, B, 20)
    tcache = tattn.init_mla_cache(m.cfg, B, 20)
    for x, at, s in ((rng.standard_normal((B, 12, jcfg.d_model)), 0, 12),
                     (rng.standard_normal((B, 1, jcfg.d_model)), 12, 1)):
        x = x.astype(np.float32)
        want, jcache = jattn.mla_attention(jp, jcfg, jnp.asarray(x),
                                           jnp.asarray(positions(s, at)),
                                           jcache, at)
        got, tcache = m(torch.from_numpy(x),
                        torch.from_numpy(positions(s, at)), tcache, at)
        close(got, want)
        for k in ("ckv", "k_rope"):
            assert tcache[k].dtype == torch.bfloat16
            close(tcache[k], jcache[k], BF16_CACHE)
