"""The port's data pipeline, learning-rate schedule, optimizers and int8
gradient compression against the JAX package's, on the CPU, inputs made
from a numpy seed:

* ``DataPipeline`` batches equal the reference's bit for bit for several
  (index, shard, num_shards), the memmap backend's too; the reference's
  cursor-resume and elastic-reshard tests ported;
* ``warmup_cosine`` equals the reference's at every step 0…total, in
  float32: bit for bit in the warmup, and within two float32 units
  after it, where the two packages' float32 cosines can round an ulp
  apart;
* ``adamw`` and ``adafactor`` (float32 and bfloat16 states) fed the
  reference's own gradients for 3 updates on a tiny model's leaves
  (deepseek at 3 layers: stacked (2, d) norm scales beside the
  unstacked ones of its ``block0`` and final norm): parameters and
  float32 states within rtol 1e-6 / atol 1e-7 (the products and means
  round apart by an ulp); AdamW's bfloat16 moments equal, Adafactor's
  bfloat16 factors equal but for at most ``BF16_FLIP_SHARE`` one unit
  off (a mean an ulp apart that lands on a rounding boundary, which
  the reduction order of the host's threads decides), and its
  parameters then within 2^-7 of the leaf's largest move; treating
  each of the port's parameters as a leaf instead (as a loop over
  ``model.parameters()`` would) misses the reference; the reference's
  quadratic-problem, bfloat16-state and factored-shape tests ported;
* ``compressed_psum`` on gloo worlds of 2 and 4 ranks against the
  reference's under ``jax.vmap(..., axis_name="data")``, mean and error
  bit for bit over 8 rounds of error feedback."""
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import build_model as jbuild_model
from repro.optim.grad_compress import compressed_psum as jcompressed_psum
from repro.optim.schedule import warmup_cosine as jwarmup_cosine
from repro.runtime import train_loop as jtrain
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import model as tmodel
from repro_torch.optim import adafactor, adamw, warmup_cosine
from repro_torch.optim.adamw import at
from test_smoke_archs import reduce_config
from test_torch_families import perturbed
from test_torch_models import port_cfg

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
#: Adafactor's bfloat16 factors: at most this share of all their elements
#: one bfloat16 unit off
BF16_FLIP_SHARE = 0.01


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index,shard,num_shards",
                         [(0, 0, 1), (5, 0, 1), (3, 1, 2), (7, 3, 4),
                          (2 ** 20, 2, 4)])
def test_pipeline_batches_are_the_reference_s(index, shard, num_shards):
    kw = dict(vocab_size=50000, seq_len=32, seed=9)
    got = tpipe.DataPipeline(tpipe.SyntheticLMDataset(**kw), 16, shard,
                             num_shards, start_index=index)
    want = jpipe.DataPipeline(jpipe.SyntheticLMDataset(**kw), 16, shard,
                              num_shards, start_index=index)
    for _ in range(2):
        g, w = got.next(), want.next()
        assert set(g) == set(w) == {"tokens", "labels"}
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
    assert got.state_dict() == want.state_dict()


def test_file_dataset_batches_are_the_reference_s(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, 5000).astype(
        np.int32).tofile(path)
    for index, shard in ((0, 0), (4, 1), (31, 2)):
        g = tpipe.FileLMDataset(str(path), 1000, 16).batch(index, shard, 3,
                                                           4)
        w = jpipe.FileLMDataset(str(path), 1000, 16).batch(index, shard, 3,
                                                           4)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_pipeline_deterministic_and_resumable():
    ds = tpipe.SyntheticLMDataset(vocab_size=100, seq_len=16, seed=7)
    p1 = tpipe.DataPipeline(ds, global_batch=8)
    batches = [p1.next() for _ in range(5)]
    p2 = tpipe.DataPipeline(ds, global_batch=8)
    p2.load_state_dict({"index": 3, "global_batch": 8})
    np.testing.assert_array_equal(p2.next()["tokens"], batches[3]["tokens"])


def test_pipeline_shards_disjoint_and_cover():
    ds = tpipe.SyntheticLMDataset(vocab_size=1000, seq_len=8, seed=1)
    s0 = tpipe.DataPipeline(ds, global_batch=8, shard=0, num_shards=2).next()
    s1 = tpipe.DataPipeline(ds, global_batch=8, shard=1, num_shards=2).next()
    assert s0["tokens"].shape == (4, 8)
    assert not np.array_equal(s0["tokens"], s1["tokens"])


def test_pipeline_elastic_reshard():
    ds = tpipe.SyntheticLMDataset(vocab_size=100, seq_len=8, seed=2)
    p = tpipe.DataPipeline(ds, global_batch=16, shard=0, num_shards=4)
    p.next()
    state = p.state_dict()
    p2 = tpipe.DataPipeline(ds, global_batch=16, shard=0, num_shards=2)
    p2.load_state_dict(state, shard=1, num_shards=2)
    assert p2.local_batch == 8 and p2.index == 1


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base,warmup,total", [(1e-3, 10, 100),
                                               (3e-4, 100, 1000),
                                               (3e-4, 5, 8), (2e-2, 0, 7)])
def test_warmup_cosine_equals_the_reference_s(base, warmup, total):
    lr, jlr = warmup_cosine(base, warmup, total), jwarmup_cosine(base,
                                                                 warmup,
                                                                 total)
    for step in range(total + 2):
        got = lr(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        got, want = got.numpy(), np.asarray(jlr(jnp.int32(step)))
        if step < warmup:
            assert got == want, step
        else:   # float32 cosines (libm's, XLA's) may differ by an ulp,
            # which 1 + cos(·) near −1 keeps as an absolute error
            tol = base * 2.0 ** -23 + 2 * np.spacing(want)
            assert abs(got - want) <= tol, (step, got - want)


def test_warmup_cosine_schedule():
    lr = warmup_cosine(1e-3, 10, 100)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1e-3) < 1e-9
    assert float(lr(100)) < float(lr(50)) < float(lr(10))


# ---------------------------------------------------------------------------
# the optimizers fed the reference's gradients
# ---------------------------------------------------------------------------

_SETUPS = {}


def setup(arch):
    """A tiny model's weights (the reference's tree) and the reference's
    gradients of 3 batches at them. deepseek at 3 layers: its unstacked
    dense ``block0`` and a stack of 2 MoE blocks ((2, d) norm scales)."""
    if arch not in _SETUPS:
        jcfg = reduce_config(jget_config(arch)).replace(num_layers=3)
        cfg = port_cfg(jcfg)
        weights = perturbed(tmodel.params_to_numpy(
            tmodel.build_model(cfg, device="cpu")), np.random.default_rng(2))
        jm = jbuild_model(jcfg)
        grad = jax.jit(jax.grad(lambda p, b: jtrain.cross_entropy_loss(
            jm.train_logits(p, b), b["labels"])))
        rng = np.random.default_rng(3)
        grads = []
        for _ in range(3):
            toks = rng.integers(0, cfg.vocab_size, (2, 17)).astype(np.int32)
            grads.append(jax.tree.map(np.asarray, grad(
                weights, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})))
        _SETUPS[arch] = (cfg, weights, grads)
    return _SETUPS[arch]


#: name → the optimizer from a package's ``optim`` module
OPTIMIZERS = {
    "adamw": lambda m: m.adamw(state_dtype="float32"),
    "adamw_bf16": lambda m: m.adamw(state_dtype="bfloat16"),
    "adafactor": lambda m: m.adafactor(weight_decay=0.1),
    "adafactor_bf16": lambda m: m.adafactor(state_dtype="bfloat16",
                                            weight_decay=0.1),
}


def _tree_leaves(tree):
    return [(tuple(k.key if hasattr(k, "key") else k for k in path), v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)]


def _run_both(arch, name, per_parameter=False):
    cfg, weights, grads = setup(arch)
    import repro.optim as jpkg
    import repro_torch.optim as tpkg
    jopt, topt = OPTIMIZERS[name](jpkg), OPTIMIZERS[name](tpkg)
    params = jax.tree.map(jnp.asarray, weights)
    jstate = jopt.init(params)
    # AdamW is elementwise: eagerly (no fusion), the reference rounds as
    # the port does, and bfloat16 moments come out equal. Adafactor's
    # row and column means sum in another order than PyTorch's (an ulp
    # apart), so it is jitted, which is quicker
    jupdate = jopt.update if name.startswith("adamw") else \
        jax.jit(jopt.update)
    model = tmodel.params_from_numpy(tmodel.build_model(cfg, device="cpu"),
                                     weights)
    stacked = tmodel.ref_leaves(model)
    leaves = stacked
    if per_parameter:     # each of the port's parameters its own leaf
        leaves = [tmodel.RefLeaf(l.path + (str(i),), [p], tuple(p.shape))
                  for l in stacked for i, p in enumerate(l.params)]
    tstate = topt.init(leaves)
    for g in grads:
        params, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate,
                                 params, 1e-2)
        tg = [torch.from_numpy(np.array(at(g, l.path))) for l in stacked]
        if per_parameter:
            tg = [s for l, t in zip(stacked, tg) for s in l.slices(t)]
        tstate = topt.update(tg, tstate, leaves, 1e-2)
    return model, tstate, params, jstate


ARCH = "deepseek-v2-236b"


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_the_reference_given_its_grads(name):
    model, tstate, params, jstate = _run_both(ARCH, name)
    got = tmodel.params_to_numpy(model)
    bf16 = name.endswith("bf16")
    for path, want in _tree_leaves(params):
        want = np.asarray(want)
        if bf16 and name.startswith("adafactor"):
            # a factor one bfloat16 unit off scales its rows' or
            # columns' steps by up to 2^-8
            moved = np.abs(want - at(setup(ARCH)[1], path)).max()
            assert np.abs(at(got, path) - want).max() <= \
                2.0 ** -7 * moved + OPT_TOL["atol"], path
        else:
            np.testing.assert_allclose(at(got, path), want,
                                       err_msg=str(path), **OPT_TOL)
    off = total = 0
    for path, want in _tree_leaves(jstate):
        g = at(tstate, path)
        assert tuple(g.shape) == want.shape, path
        if path == ("count",):
            assert g.dtype == torch.int32 and int(g) == 3
        elif bf16:
            assert g.dtype == torch.bfloat16, path
            got32 = g.float().numpy()
            want32 = np.asarray(want.astype(jnp.float32))
            if name.startswith("adamw"):
                np.testing.assert_array_equal(got32, want32,
                                              err_msg=str(path))
            else:   # a mean an ulp apart may round to the next bfloat16
                off += int((got32 != want32).sum())
                total += got32.size
                np.testing.assert_allclose(got32, want32, rtol=2 ** -7,
                                           atol=0, err_msg=str(path))
        else:
            assert g.dtype == torch.float32, path
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       err_msg=str(path), **OPT_TOL)
    assert off <= BF16_FLIP_SHARE * total, (off, total)


@pytest.mark.parametrize("name", ("adamw", "adafactor"))
def test_a_per_parameter_optimizer_misses_the_reference(name):
    """The stacked leaves matter: with each layer's parameter a leaf of
    its own, AdamW stops decaying the stacked norm scales and Adafactor
    factors and clips them per layer, and the result leaves the
    reference's tolerance."""
    model, _, params, _ = _run_both(ARCH, name, per_parameter=True)
    got = tmodel.params_to_numpy(model)
    want = np.asarray(params["blocks"]["ln1"]["scale"])
    assert not np.allclose(got["blocks"]["ln1"]["scale"], want, **OPT_TOL)


def _quad_problem():
    target = torch.tensor([1.0, -2.0, 3.0])
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.zeros(3, 4))
    model.b = torch.nn.Parameter(torch.zeros(3))

    def loss():
        return torch.sum((model.w.sum(-1) + model.b - target) ** 2)
    return model, loss


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
def test_optimizers_reduce_loss(opt_name):
    model, loss = _quad_problem()
    opt = adamw(weight_decay=0.0) if opt_name == "adamw" else \
        adafactor(weight_decay=0.0)
    leaves = tmodel.ref_leaves(model)
    state = opt.init(leaves)
    l0 = float(loss().detach())
    for _ in range(200):
        gs = torch.autograd.grad(loss(), [l.params[0] for l in leaves])
        state = opt.update(list(gs), state, leaves, 0.05)
    assert float(loss().detach()) < l0 * 0.01


def test_adamw_bf16_states():
    model, loss = _quad_problem()
    opt = adamw(state_dtype="bfloat16")
    leaves = tmodel.ref_leaves(model)
    state = opt.init(leaves)
    assert state["m"]["w"].dtype == torch.bfloat16
    before = model.w.detach().clone()
    gs = torch.autograd.grad(loss(), [l.params[0] for l in leaves])
    state = opt.update(list(gs), state, leaves, 0.01)
    assert state["v"]["w"].dtype == torch.bfloat16
    assert not torch.allclose(model.w, before)


def test_adafactor_state_is_factored():
    model = torch.nn.Module()
    model.big = torch.nn.Parameter(torch.zeros(64, 32))
    st = adafactor().init(tmodel.ref_leaves(model))
    assert st["f"]["big"]["vr"].shape == (64,)
    assert st["f"]["big"]["vc"].shape == (32,)


# ---------------------------------------------------------------------------
# int8 gradient compression on gloo
# ---------------------------------------------------------------------------

ROUNDS = 8

WORKER = r"""
import sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.optim import (compressed_psum, compressed_psum_tree,
                               init_compression)
rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                *sys.argv[3:6])
dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                        world_size=world)
gs = np.load(inp)[f"g{world}"]
g = torch.from_numpy(gs[rank])
tree = {"a": g, "b": [g[:10] * 3]}
comp = init_compression(tree)
res = {}
for r in range(int(sys.argv[6])):
    mean, err = compressed_psum(g, comp["a"].error, None, world)
    tree_out, comp = compressed_psum_tree(tree, comp, None, world)
    assert torch.equal(tree_out["a"], mean)
    assert torch.equal(comp["a"].error, err)
    res[f"mean{r}"], res[f"err{r}"] = mean.numpy(), err.numpy()
    res[f"bmean{r}"] = tree_out["b"][0].numpy()
    res[f"berr{r}"] = comp["b"][0].error.numpy()
np.savez(out, **res)
dist.barrier()
dist.destroy_process_group()
print("WORKER-OK")
"""


def test_compressed_psum_matches_the_reference_on_gloo(tmp_path):
    rng = np.random.default_rng(5)
    gs = {f"g{w}": rng.standard_normal((w, 256)).astype(np.float32)
          for w in (2, 4)}
    np.savez(tmp_path / "inp.npz", **gs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    cmds = [[sys.executable, "-c", WORKER, str(r), str(w),
             str(tmp_path / f"store{w}"), str(tmp_path / "inp.npz"),
             str(tmp_path / f"w{w}r{r}.npz"), str(ROUNDS)]
            for w in (2, 4) for r in range(w)]
    results = mesh_lib.run_ranks(cmds, timeout_s=240, env=env)
    assert all("WORKER-OK" in so for _, so, _ in results)
    for w in (2, 4):
        fn = jax.vmap(lambda g, e: jcompressed_psum(g, e, "data", w),
                      axis_name="data")
        for key, g in (("", gs[f"g{w}"]), ("b", gs[f"g{w}"][:, :10] * 3)):
            g = jnp.asarray(g)
            err = jnp.zeros_like(g)
            outs = [np.load(tmp_path / f"w{w}r{r}.npz") for r in range(w)]
            for rnd in range(ROUNDS):
                mean, err = fn(g, err)
                for r in range(w):
                    np.testing.assert_array_equal(
                        outs[r][f"{key}mean{rnd}"], np.asarray(mean[r]))
                    np.testing.assert_array_equal(
                        outs[r][f"{key}err{rnd}"], np.asarray(err[r]))
