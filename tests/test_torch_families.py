"""The port's MoE (with MLA and deepseek's dense first block, and with
arctic's dense residual), xLSTM, Mamba2-hybrid and encoder-decoder
models against the JAX package's, whole, on the CPU, on the reference's
weights carried through ``params_from_numpy``, at the reference smoke
tests' reduced configs (``tests/test_smoke_archs.py`` ``reduce_config``,
float32): train logits, prefill logits and caches, and 8 greedy decode
steps within rtol 2e-4 / atol 2e-4 with the tokens equal, and the
weights' round trip through numpy.

The caches are bfloat16 at float32 compute too, as the reference's
(``CACHE_DTYPE``). A float32 difference of a few ulps (2–4e-7 relative
between the two packages' blocks) that lands on a rounding boundary
moves a cache entry by one bfloat16 unit; prefill reads K/V back from
its buffers, and the Mamba2 and mLSTM states are rounded again at every
step, so such flips reach the logits (up to ~2e-3 over 8 steps here).
So the algorithm is held with float32 caches in both packages (both
``CACHE_DTYPE``s set for the run), where every logit must agree within
2e-4, decode included; and the shipped bfloat16 caches are held entry
by entry within one rounding, each decode step run from a copy of the
reference's caches within 2e-4, and the greedy tokens of two runs that
each keep their own caches equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models import model as jmodel
from repro_torch.models import model as tmodel
from test_smoke_archs import reduce_config
from test_torch_models import B, MODEL_TOL, S, as_jax, as_torch, close, \
    port_cfg
from test_torch_moe import BF16_CACHE

jax.config.update("jax_platform_name", "cpu")

FAMILIES = ("deepseek-v2-236b", "arctic-480b", "xlstm-1.3b", "zamba2-7b",
            "seamless-m4t-medium")
STEPS = 8
#: float32 leaves that the reference initialises to constants
_CONSTANTS = ("A_log", "D", "dt_bias", "if_bias", "bias", "conv_b")


def perturbed(tree, rng):
    """The reference's initial weights with norm scales and the float32
    constants moved off their init values, so that they count."""
    for k, v in tree.items():
        if isinstance(v, dict):
            perturbed(v, rng)
        elif k == "scale":
            tree[k] = (1 + 0.1 * rng.standard_normal(v.shape)
                       ).astype(np.float32)
        elif k in _CONSTANTS:
            tree[k] = (v + 0.1 * rng.standard_normal(v.shape)
                       ).astype(np.float32)
    return tree


def to_port(caches):
    """The reference's caches as fresh tensors of the same dtypes."""
    if isinstance(caches, dict):
        return {k: to_port(v) for k, v in caches.items()}
    return torch.from_numpy(np.array(caches, np.float32)).to(
        getattr(torch, str(caches.dtype)))


def clone(caches):
    return {k: clone(v) for k, v in caches.items()} \
        if isinstance(caches, dict) else caches.clone()


def check_caches(got, want, values=True):
    """The reference's layout and dtypes, and with ``values`` bfloat16
    entries within one rounding and float32 ones within 2e-4."""
    assert set(got) == set(want)
    for k in got:
        if isinstance(got[k], dict):
            check_caches(got[k], want[k], values)
            continue
        g, w = got[k], want[k]
        assert g.dtype == getattr(torch, str(w.dtype)), k
        assert tuple(g.shape) == w.shape, k
        if values:
            close(g, w, BF16_CACHE if g.dtype == torch.bfloat16
                  else MODEL_TOL)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """Both models on the same weights, a prompt, and the reference's
    train logits."""
    jcfg = reduce_config(jget_config(request.param))
    jm = jbuild_model(jcfg)
    tree = perturbed(jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0))),
                     np.random.default_rng(0))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = tmodel.params_from_numpy(
        tmodel.build_model(port_cfg(jcfg), device="cpu"), tree)
    rng = np.random.default_rng(31)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if jcfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, 16, jcfg.d_model)).astype(np.float32)
    train = jax.jit(jm.train_logits)(jp, as_jax(batch))
    return dict(jm=jm, jp=jp, tree=tree, tm=tm, batch=batch, train=train,
                served={})


def served(pair, cache_dtype: str):
    """Prefill and 8 greedy decode steps with caches of ``cache_dtype``
    in both packages: the reference's logits, tokens and caches before
    and after each step, and the port's own run (its prefill logits and
    caches, then each step on its own tokens and caches)."""
    if cache_dtype in pair["served"]:
        return pair["served"][cache_dtype]
    jm, jp, tm = pair["jm"], pair["jp"], pair["tm"]
    max_len = S + STEPS
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmodel, "CACHE_DTYPE", getattr(jnp, cache_dtype))
        mp.setattr(tmodel, "CACHE_DTYPE", getattr(torch, cache_dtype))
        # fresh functions, so that jit traces them anew under this dtype
        logits, caches = jax.jit(
            lambda p, b: jm.prefill(p, b, max_len=max_len))(
            jp, as_jax(pair["batch"]))
        run = dict(prefill=(logits, caches), steps=[])
        decode = jax.jit(lambda *a: jm.decode(*a))
        for i in range(STEPS):
            tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
            before = caches
            logits, caches = decode(jp, {"tokens": tok[:, None]}, caches,
                                    jnp.int32(S + i))
            run["steps"].append(dict(tok=np.array(tok), before=before,
                                     logits=logits, after=caches))
        tl, tc = tm.prefill(as_torch(pair["batch"]), max_len)
        run["port_prefill"] = (tl, clone(tc))
        run["port_steps"] = []
        for i in range(STEPS):
            tok = torch.argmax(tl[:, -1], -1).to(torch.int32)
            tl, tc = tm.decode({"tokens": tok[:, None]}, tc, S + i)
            run["port_steps"].append((tok, tl))
    pair["served"][cache_dtype] = run
    return run


def test_train_logits_match_the_reference(pair):
    got = pair["tm"].train_logits(as_torch(pair["batch"]))
    assert got.shape == pair["train"].shape == (B, S, 256)
    close(got, pair["train"], MODEL_TOL)


def test_prefill_logits_and_caches_match_the_reference(pair):
    """With float32 caches: the prefill's logits and every cache entry
    within 2e-4."""
    run = served(pair, "float32")
    (want, jcaches), (got, tcaches) = run["prefill"], run["port_prefill"]
    assert got.shape == want.shape == (B, 1, 256)
    close(got, want, MODEL_TOL)
    check_caches(tcaches, jcaches)


def test_decode_steps_match_the_reference(pair):
    """With float32 caches, each side on its own tokens and caches: 8
    steps' logits within 2e-4 and the greedy tokens equal."""
    run = served(pair, "float32")
    for st, (tok, got) in zip(run["steps"], run["port_steps"]):
        np.testing.assert_array_equal(tok.numpy(), st["tok"])
        close(got, st["logits"], MODEL_TOL)


def test_bfloat16_caches_match_the_reference(pair):
    """The shipped bfloat16 caches: the prefill's in the reference's
    layout and dtypes (their values are held with float32 caches: past a
    flip in one layer's bfloat16 K/V the later layers' entries move by
    more than a rounding); then each of the 8 steps from a copy of the
    reference's caches of the step before, fed the reference's token:
    logits within 2e-4, and the caches it writes within one rounding."""
    run = served(pair, "bfloat16")
    check_caches(run["port_prefill"][1], run["prefill"][1], values=False)
    for i, st in enumerate(run["steps"]):
        tok = torch.from_numpy(st["tok"])[:, None]
        got, tcaches = pair["tm"].decode({"tokens": tok},
                                         to_port(st["before"]), S + i)
        close(got, st["logits"], MODEL_TOL)
        check_caches(tcaches, st["after"])


def test_greedy_tokens_match_the_reference(pair):
    """With the shipped bfloat16 caches, each side on its own tokens and
    caches: the same greedy tokens at every step."""
    run = served(pair, "bfloat16")
    for st, (tok, _) in zip(run["steps"], run["port_steps"]):
        np.testing.assert_array_equal(tok.numpy(), st["tok"])


def test_weights_round_trip_through_numpy(pair):
    back = tmodel.params_to_numpy(pair["tm"])
    assert jax.tree.structure(back) == jax.tree.structure(pair["tree"])
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(pair["tree"])):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert pair["tm"].num_params() == pair["jm"].num_params(pair["tree"])
