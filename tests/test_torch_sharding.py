"""The port's sharding rules (``repro_torch.runtime.sharding``) and
``constrain``'s resolution (``runtime.mesh_ctx.constrain_spec``) against
the JAX package's, bit for bit, in process: the reference's functions on
``jax.sharding.AbstractMesh`` shapes (no devices), the port's on the
same axis names and sizes.

For every mesh shape of ``MESHES`` and both profiles:

* every parameter leaf of all ten configs at full size (the
  reference's ``jax.eval_shape`` of ``init``; the port's ``ref_leaves``
  of the model built on the ``meta`` device), AdamW's and Adafactor's
  state trees (the reference's ``opt.init`` under ``eval_shape``; the
  port's on the meta leaves), and ``state_specs``;
* each arch's ``input_specs`` batches and its caches at the decode
  cell's shape, ``logits_spec``, and ``constrain``'s symbols on the
  activations ``_sdpa`` pins;
* the two cases of ``tests/test_sharding.py`` (spec rules, the
  divisibility fallback), ported.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS, get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs.base import ALL_SHAPES as JALL_SHAPES
from repro.configs.base import TrainConfig as JTrainConfig
from repro.models import build_model as jbuild_model
from repro.optim import get_optimizer as jget_optimizer
from repro.runtime import mesh_ctx as jmesh_ctx
from repro.runtime import sharding as jshd
from repro_torch.configs import get_config, input_specs
from repro_torch.configs.base import ALL_SHAPES, TrainConfig
from repro_torch.models.model import build_model, nest, ref_leaves
from repro_torch.optim import get_optimizer
from repro_torch.runtime import mesh_ctx, sharding as shd
from repro_torch.runtime.train_loop import state_specs

jax.config.update("jax_platform_name", "cpu")

MESHES = [((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((8, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PROFILES = ("2d", "fsdp_only")
MESH_IDS = ["x".join(map(str, s)) for s, _ in MESHES]


def _abstract(shape, names):
    return AbstractMesh(shape, names)


def _named(shape, names):
    return dict(zip(names, shape))


def _specs_equal(ref_tree, port_tree, path=""):
    """Walk two spec trees (the reference's of PartitionSpecs, the
    port's of tuples) and return the leaves that differ."""
    if isinstance(ref_tree, dict):
        assert set(ref_tree) == set(port_tree), (path, set(ref_tree),
                                                set(port_tree))
        return [bad for k in ref_tree
                for bad in _specs_equal(ref_tree[k], port_tree[k],
                                        f"{path}/{k}")]
    if tuple(ref_tree) != port_tree:
        return [(path, tuple(ref_tree), port_tree)]
    return []


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    """The reference's parameter shapes (eval_shape of init)."""
    model = jbuild_model(jget_config(arch))
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_leaves(arch):
    return ref_leaves(build_model(get_config(arch), device="meta",
                                  generator=torch.Generator()))


def _port_params(arch):
    return nest((l.path, torch.empty(l.shape, device="meta"))
                for l in _port_leaves(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_of_every_config(arch):
    """Every leaf of the published config, every mesh and profile: the
    port's specs (on its meta leaves' shapes, which are the reference's)
    equal the reference's."""
    ref = _ref_params(arch)
    port = _port_params(arch)
    assert jax.tree.map(lambda x: tuple(x.shape), ref) == jax.tree.map(
        lambda x: tuple(x.shape), port, is_leaf=torch.is_tensor)
    for (shape, names) in MESHES:
        for profile in PROFILES:
            want = jshd.infer_param_specs(ref, _abstract(shape, names),
                                          profile)
            got = shd.infer_param_specs(port, _named(shape, names), profile)
            assert not _specs_equal(want, got), (shape, profile)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_optimizer_state_specs(arch, optimizer):
    """AdamW's m/v and Adafactor's f/vr/vc/v inherit their parameter's
    rule (minus a dim) as the reference's do; ``state_specs`` too."""
    ref = _ref_params(arch)
    jopt = jget_optimizer(JTrainConfig(optimizer=optimizer))
    jstate = jax.eval_shape(jopt.init, ref)
    opt = get_optimizer(TrainConfig(optimizer=optimizer))
    with torch.device("meta"):
        pstate = opt.init(_port_leaves(arch))
    for (shape, names) in MESHES:
        for profile in PROFILES:
            am, nm = _abstract(shape, names), _named(shape, names)
            want = jshd.infer_param_specs(jstate, am, profile)
            got = shd.infer_param_specs(pstate, nm, profile)
            assert not _specs_equal(want, got), (shape, profile)
            both = state_specs({"params": _port_params(arch),
                                "opt": pstate, "step": None}, nm, profile)
            assert both["step"] == ()
            assert not _specs_equal(
                jshd.infer_param_specs(ref, am, profile), both["params"])


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs(arch):
    """Every shape cell's ``input_specs`` batch, the caches of a decode
    cell (the reference's ``init_caches`` under ``eval_shape``, the
    port's on the meta device; batch 1 shards the sequence) and
    ``logits_spec``."""
    jmodel = jbuild_model(jget_config(arch))
    tmodel = build_model(get_config(arch), device="meta",
                         generator=torch.Generator())
    for (shape, names) in MESHES:
        am, nm = _abstract(shape, names), _named(shape, names)
        for profile in PROFILES:
            for js, ps in zip(JALL_SHAPES, ALL_SHAPES):
                want = jshd.infer_batch_specs(jinput_specs(arch, js), am,
                                              profile)
                got = shd.infer_batch_specs(input_specs(arch, ps), nm,
                                            profile)
                assert not _specs_equal(want, got), (js.name, shape)
            assert shd.logits_spec(nm, profile) == tuple(
                jshd.logits_spec(am, profile))
    for B, S in ((128, 4096), (1, 8192), (4, 96)):
        jc = jax.eval_shape(functools.partial(jmodel.init_caches, B, S))
        pc = tmodel.init_caches(B, S)
        for (shape, names) in MESHES:
            am, nm = _abstract(shape, names), _named(shape, names)
            for profile in PROFILES:
                want = jshd.infer_cache_specs(jc, am, profile)
                got = shd.infer_cache_specs(pc, nm, profile)
                assert not _specs_equal(want, got), (B, S, shape, profile)


# the activations _sdpa pins, as (shape, symbols)
_CONSTRAINED = [((8, 1, 4096, 8, 128), ()),
                ((8, 1, 8, 128), ("batch", "tensor", None, None)),
                ((8, 4096, 32, 128), ("batch", None, "tensor", None)),
                ((1, 4096, 8, 128), ("batch", None, "tensor", None)),
                ((8, 32, 4096, 4096), ("batch", "tensor", None, None)),
                ((6, 3, 5), ("batch", "tensor", None)),
                ((16, 12), (None, "tensor"))]


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("mesh_shape", MESHES, ids=MESH_IDS)
def test_constrain_resolution(mesh_shape, profile):
    """``constrain``'s symbols resolve as the reference's: "batch" → the
    FSDP/data axes, "tensor" → the model axis, an indivisible (or
    size-1 batch) dim → None. The reference's spec is read from its
    ``with_sharding_constraint`` call."""
    shape, names = mesh_shape
    seen = []

    def record(x, sharding):
        seen.append(tuple(sharding.spec))
        return x
    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = record
    try:
        with jmesh_ctx.mesh_context(_abstract(shape, names), profile):
            for xshape, symbols in _CONSTRAINED:
                jmesh_ctx.constrain(np.zeros(xshape, np.float32), *symbols)
    finally:
        jax.lax.with_sharding_constraint = orig
    nm = _named(shape, names)
    got = [mesh_ctx.constrain_spec(xs, *sy, mesh=nm, profile=profile)
           for xs, sy in _CONSTRAINED]
    assert got == seen
    with mesh_ctx.mesh_context(nm, profile):
        assert mesh_ctx.constrain_spec(*_CONSTRAINED[2][:1],
                                       *_CONSTRAINED[2][1]) == seen[2]
        x = torch.zeros(3)
        assert mesh_ctx.constrain(x, "batch") is x
    assert mesh_ctx.current_mesh() is None


def test_param_spec_rules():
    """``tests/test_sharding.py::test_param_spec_rules``, ported."""
    mesh = {"data": 4, "model": 2}
    params = {
        "embed": np.zeros((1024, 64)),
        "blocks": {"attn": {"wq": np.zeros((8, 64, 8, 16)),
                            "wo": np.zeros((8, 8, 16, 64))},
                   "ffn": {"experts": {"gate": np.zeros((8, 4, 64, 32))},
                           "router": np.zeros((8, 64, 4))}},
        "final_ln": {"scale": np.zeros((64,))},
    }
    specs = shd.infer_param_specs(params, mesh)
    assert specs["embed"] == ("model", "data"), specs["embed"]
    # stacked leading layer dim stays unsharded
    assert specs["blocks"]["attn"]["wq"] == (None, "data", "model", None)
    assert specs["blocks"]["attn"]["wo"] == (None, "model", None, "data")
    assert specs["blocks"]["ffn"]["experts"]["gate"] == \
        (None, "model", "data", None)
    assert specs["blocks"]["ffn"]["router"] == (None, "data", None)
    assert specs["final_ln"]["scale"] == (None,)


def test_divisibility_fallback():
    """``tests/test_sharding.py::test_divisibility_fallback``, ported."""
    mesh = {"data": 4, "model": 2}
    # kv head dim 3 not divisible by model=2 → replicated
    params = {"wk": np.zeros((64, 3, 16))}
    specs = shd.infer_param_specs(params, mesh)
    assert specs["wk"] == ("data", None, None), specs["wk"]
    # batch 1 cache → sequence gets the data axis (context parallel)
    cache = {"k": np.zeros((4, 1, 64, 8, 16))}
    cspecs = shd.infer_cache_specs(cache, mesh)
    assert cspecs["k"][1] is None and cspecs["k"][2] == "data"


def test_mesh_shape_forms():
    """A mapping, an ``AbstractMesh``-like object and the profiles; an
    unknown profile raises."""
    am = _abstract((2, 16, 16), ("pod", "data", "model"))
    assert shd.mesh_shape(am) == {"pod": 2, "data": 16, "model": 16}
    assert shd.mesh_axes(am) == (("pod", "data"), "model")
    assert shd.mesh_axes(am, "fsdp_only") == (("pod", "data", "model"),
                                              None)
    with pytest.raises(ValueError):
        shd.mesh_axes(am, "3d")
    assert shd.local_shape((8, 64, 8, 16), (None, "data", "model", None),
                           {"data": 4, "model": 2}) == (8, 16, 4, 16)
