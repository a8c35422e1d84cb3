"""The port's LM modules (``repro_torch.models``) against the JAX
package's on the same inputs and weights, on the CPU: the primitives and
the GQA attention within rtol 1e-5 / atol 1e-5, the whole decoder-only
model (train logits, prefill logits and caches) within rtol 2e-4 /
atol 2e-4, at the reference's reduced configs
(``tests/test_smoke_archs.py`` ``reduce_config``: d_model 64, 2 layers,
vocab 256, float32). Weights go across as numpy arrays through
``params_from_numpy``; inputs are made from a numpy seed."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig)
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel
from repro_torch.models.ffn import MLP
from test_smoke_archs import reduce_config

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=2e-4, atol=2e-4)
#: dense: MHA with QKV bias and tied embeddings; GQA untied; the vlm
#: backbone (GQA, bias, M-RoPE, patches)
ARCHS = ("qwen1.5-0.5b", "llama3-8b", "qwen2-vl-7b")
B, S = 2, 32


def port_cfg(jcfg) -> ModelConfig:
    """The port's twin of a reference config, its nested MoE, MLA and
    SSM configs included."""
    kw = dataclasses.asdict(jcfg)
    for name, cls in (("moe", MoEConfig), ("mla", MLAConfig),
                      ("ssm", SSMConfig)):
        if kw[name] is not None:
            kw[name] = cls(**kw[name])
    return ModelConfig(**kw)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def close(got, want, tol=TOL):
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def perturbed_tree(jmodel, seed=0):
    """The reference's initial weights with non-trivial norm scales and
    QKV biases (its init makes them ones and zeros), as numpy arrays."""
    tree = jax.tree.map(np.array, jmodel.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    blocks = tree["blocks"]
    for ln in ("ln1", "ln2"):
        s = blocks[ln]["scale"]
        blocks[ln]["scale"] = (1 + 0.1 * rng.standard_normal(s.shape)
                               ).astype(np.float32)
    tree["final_ln"]["scale"] = (
        1 + 0.1 * rng.standard_normal(tree["final_ln"]["scale"].shape)
    ).astype(np.float32)
    for b in ("bq", "bk", "bv"):
        if b in blocks["attn"]:
            blocks["attn"][b] = (0.1 * rng.standard_normal(
                blocks["attn"][b].shape)).astype(np.float32)
    return tree


def model_pair(arch, **overrides):
    """(reference model, its params, the port's model) on the same
    weights."""
    jcfg = reduce_config(jget_config(arch)).replace(**overrides)
    jm = jbuild_model(jcfg)
    tree = perturbed_tree(jm)
    tm = tmodel.build_model(port_cfg(jcfg), device="cpu")
    tmodel.params_from_numpy(tm, tree)
    return jm, jax.tree.map(jnp.asarray, tree), tm


def make_batch(cfg, seed, s=S):
    """The reference's prefill batch: tokens (+ 8 patches and equal
    M-RoPE streams for a vlm), numpy."""
    rng = np.random.default_rng(seed)
    n_patch = 8 if cfg.family == "vlm" else 0
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s - n_patch),
                                    dtype=np.int32)}
    if n_patch:
        batch["patches"] = rng.standard_normal(
            (B, n_patch, cfg.d_model)).astype(np.float32)
    if cfg.mrope:
        batch["positions3"] = np.broadcast_to(
            np.arange(s, dtype=np.int32)[None, None], (3, B, s)).copy()
    return batch


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jcommon.rmsnorm({"scale": jnp.asarray(scale)},
                           jnp.asarray(x).astype(jcommon.dt(dtype)), 1e-6)
    got = tcommon.rmsnorm(torch.from_numpy(scale),
                          torch.from_numpy(x).to(tcommon.dt(dtype)), 1e-6)
    assert got.dtype == tcommon.dt(dtype)
    close(got, want, TOL if dtype == "float32" else dict(rtol=0, atol=0))


@pytest.mark.parametrize("theta", [1e6, 5e5, 1e4])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 7), dtype=np.int32)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    close(got, want)
    close(tcommon.rope_freqs(16, theta), jcommon.rope_freqs(16, theta))


def test_apply_mrope_with_distinct_streams():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos3 = rng.integers(0, 500, (3, 2, 7), dtype=np.int32)
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), (2, 3, 3))
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                              (2, 3, 3))
    close(got, want)
    with pytest.raises(ValueError):
        tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                            (2, 3, 4))


@pytest.mark.parametrize("q_len,kv_len,offset", [(5, 9, 3), (1, 12, 11),
                                                  (8, 8, 0)])
def test_causal_mask(q_len, kv_len, offset):
    np.testing.assert_array_equal(
        tcommon.causal_mask(q_len, kv_len, offset).numpy(),
        np.asarray(jcommon.causal_mask(q_len, kv_len, offset)))


def test_initialisers_draw_the_reference_distributions():
    """Truncated normal in ±2σ with σ = 1/√fan_in, and an embedding
    table of σ = 1/√d: the moments of a large draw."""
    g = torch.Generator().manual_seed(0)
    w = tcommon.dense_init((256, 4, 64), torch.float32, generator=g)
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-7
    assert abs(float(w.std()) - 0.8796 / 16) < 2e-3   # std of N(0,1)|±2
    wo = tcommon.dense_init((4, 64, 256), torch.float32, (0, 1), generator=g)
    assert float(wo.abs().max()) <= 2.0 / 16 + 1e-7
    e = tcommon.embed_init(1024, 64, torch.bfloat16, generator=g)
    assert e.dtype == torch.bfloat16
    assert abs(float(e.float().std()) - 1 / 8) < 2e-3


def test_mlp():
    rng = np.random.default_rng(3)
    d, f = 64, 128
    params = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
              for k, s in (("gate", (d, f)), ("up", (d, f)),
                           ("down", (f, d)))}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    want = jffn.mlp({k: jnp.asarray(v) for k, v in params.items()},
                    jnp.asarray(x), jnp.float32)
    m = MLP(d, f, torch.float32, torch.float32,
            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in params.items():
            getattr(m, k).copy_(torch.from_numpy(v))
    close(m(torch.from_numpy(x)), want)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attn_pair(arch):
    jcfg = reduce_config(jget_config(arch))
    rng = np.random.default_rng(4)
    p = jax.tree.map(np.array, jattn.init_gqa(jax.random.PRNGKey(1), jcfg))
    for b in ("bq", "bk", "bv"):
        if b in p:
            p[b] = (0.1 * rng.standard_normal(p[b].shape)).astype(np.float32)
    cfg = port_cfg(jcfg)
    m = tattn.GQA(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, v in p.items():
            getattr(m, k).copy_(torch.from_numpy(v).reshape(
                getattr(m, k).shape))
    return jcfg, jax.tree.map(jnp.asarray, p), m


def positions(cfg, s, offset=0):
    pos = np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32),
                          (B, s))
    if cfg.mrope:   # distinct streams, so that every band counts
        pos = np.stack([pos, pos // 2, pos // 3])
    return np.ascontiguousarray(pos)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "llama3-8b", "qwen2-vl-7b"])
def test_gqa_attention_without_cache(arch):
    jcfg, jp, m = attn_pair(arch)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 12, jcfg.d_model)).astype(np.float32)
    pos = positions(jcfg, 12)
    want, _ = jattn.gqa_attention(jp, jcfg, jnp.asarray(x),
                                  jnp.asarray(pos))
    got, cache = m(torch.from_numpy(x), torch.from_numpy(pos))
    assert cache is None
    close(got, want)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-vl-7b"])
def test_gqa_attention_with_cache_prefill_then_decode(arch):
    """Sq > 1 into an empty buffer at index 0, then Sq = 1 at index 12
    (the grouped path); the bfloat16 caches equal bit for bit."""
    jcfg, jp, m = attn_pair(arch)
    rng = np.random.default_rng(6)
    max_len = 20
    jcache = jattn.init_gqa_cache(jcfg, B, max_len)
    tcache = tattn.init_gqa_cache(m.cfg, B, max_len)
    x = rng.standard_normal((B, 12, jcfg.d_model)).astype(np.float32)
    want, jcache = jattn.gqa_attention(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(positions(jcfg, 12)),
                                       jcache, 0)
    got, tcache = m(torch.from_numpy(x),
                    torch.from_numpy(positions(jcfg, 12)), tcache, 0)
    close(got, want)
    for k in ("k", "v"):
        close(tcache[k], jcache[k], dict(rtol=0, atol=0))
    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    want, jcache = jattn.gqa_attention(jp, jcfg, jnp.asarray(x1),
                                       jnp.asarray(positions(jcfg, 1, 12)),
                                       jcache, 12)
    got, tcache = m(torch.from_numpy(x1),
                    torch.from_numpy(positions(jcfg, 1, 12)), tcache, 12)
    close(got, want)
    for k in ("k", "v"):
        close(tcache[k], jcache[k], dict(rtol=0, atol=0))


def test_gqa_cache_write_clamps_like_the_reference():
    """A write past the buffer's end lands at its last slot, as
    ``dynamic_update_slice`` clamps; the mask keeps the true index."""
    jcfg, jp, m = attn_pair("qwen2.5-3b")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    jcache = jattn.init_gqa_cache(jcfg, B, 6)
    tcache = tattn.init_gqa_cache(m.cfg, B, 6)
    want, jcache = jattn.gqa_attention(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(positions(jcfg, 1, 9)),
                                       jcache, 9)
    got, tcache = m(torch.from_numpy(x),
                    torch.from_numpy(positions(jcfg, 1, 9)), tcache, 9)
    close(got, want)
    close(tcache["k"], jcache["k"], dict(rtol=0, atol=0))


def test_query_chunking_matches_the_unchunked_path(monkeypatch):
    """With ``_Q_CHUNK`` = 8, a 32-query prefill is attended in four
    chunks: the same output as the unchunked path and the reference."""
    jcfg, jp, m = attn_pair("qwen2.5-3b")
    rng = np.random.default_rng(8)
    x = rng.standard_normal((B, 32, jcfg.d_model)).astype(np.float32)
    pos = torch.from_numpy(positions(jcfg, 32))
    whole, _ = m(torch.from_numpy(x), pos)
    calls = []
    real_att = torch.softmax

    def counting_softmax(*a, **kw):
        calls.append(a[0].shape)
        return real_att(*a, **kw)

    monkeypatch.setattr(tattn, "_Q_CHUNK", 8)
    monkeypatch.setattr(tattn.torch, "softmax", counting_softmax)
    chunked, _ = m(torch.from_numpy(x), pos)
    monkeypatch.undo()
    assert [c[-2] for c in calls] == [8, 8, 8, 8]
    close(chunked, whole)
    want, _ = jattn.gqa_attention(jp, jcfg, jnp.asarray(x),
                                  jnp.asarray(pos.numpy()))
    close(chunked, want)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_weights_round_trip_through_numpy():
    jm, jp, tm = model_pair("qwen2-vl-7b")
    back = tmodel.params_to_numpy(tm)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert tm.num_params() == jm.num_params(jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_the_reference(arch):
    jm, jp, tm = model_pair(arch)
    batch = make_batch(tm.cfg, seed=11)
    want = jax.jit(jm.train_logits)(jp, as_jax(batch))
    got = tm.train_logits(as_torch(batch))
    assert got.shape == want.shape == (B, S, tm.cfg.vocab_size)
    assert got.dtype == torch.float32
    close(got, want, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_the_reference(arch):
    jm, jp, tm = model_pair(arch)
    batch = make_batch(tm.cfg, seed=12)
    max_len = S + 8
    want, jcaches = jax.jit(jm.prefill, static_argnames=("max_len",))(
        jp, as_jax(batch), max_len=max_len)
    got, tcaches = tm.prefill(as_torch(batch), max_len)
    assert got.shape == want.shape == (B, 1, tm.cfg.vocab_size)
    close(got, want, MODEL_TOL)
    for k in ("k", "v"):
        t, j = tcaches["blocks"][k], jcaches["blocks"][k]
        assert t.dtype == torch.bfloat16 and t.shape == j.shape
        # bfloat16 entries: equal, or one rounding apart
        close(t, j, dict(rtol=2 ** -7, atol=1e-6))


@pytest.mark.parametrize("arch", JARCHS)
def test_tiny_config_is_the_reference_tests_reduction(arch):
    """The card checks' size is the reference smoke tests' own."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    assert (dataclasses.asdict(tiny_config(get_config(arch)))
            == dataclasses.asdict(reduce_config(jget_config(arch))))


@pytest.mark.parametrize("arch", JARCHS)
def test_build_model_builds_every_config(arch):
    """Every family builds at ``tiny_config`` on the CPU, with the
    reference's parameter count; an unknown family raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import tiny_config
    cfg = tiny_config(get_config(arch))
    tm = tmodel.build_model(cfg, device="cpu")
    jm = jbuild_model(reduce_config(jget_config(arch)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert tm.num_params() == sum(int(np.prod(a.shape))
                                  for a in jax.tree.leaves(shapes))
    with pytest.raises(ValueError, match="unknown family"):
        tmodel.build_model(cfg.replace(family="rnn"), device="cpu")
