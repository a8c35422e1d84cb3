"""The port's dry run (``repro_torch.launch.dryrun``), its production
meshes and the fake process group (``repro_torch.launch.mesh``), on the
CPU, against the JAX package's ``launch/dryrun.py`` and sharding rules:

  (i)   ``model_flops`` equals the reference's for every arch and shape
        (the reference's from ``jax.eval_shape``, nothing allocated);
  (ii)  each rank's parameter bytes on the (16, 16) and (2, 16, 16)
        meshes equal, leaf for leaf, what the reference's
        ``infer_param_specs`` gives on an ``AbstractMesh`` of that shape;
  (iii) qwen2.5-3b at full width on a fake (1, 4) mesh makes the
        collectives and moves the bytes that the card's four-rank run of
        the same steps counted (``chip_smoke.py`` phase 10 (e)), which do
        not depend on the device;
  (iv)  each family at its published widths, one pattern unit deep
        (the reference's probe at k = 1), runs each of its production
        shapes to its end on both production meshes;
  (v)   the matcher cell on a fake (2, 4) mesh makes the collectives of
        rank 0 of a real gloo (2, 4) world on the same call;
  (vi)  the ten configs as published lay out and pass
        ``check_serve_layout`` on model axes that do not divide their
        heads ((1, 3), (2, 3), (1, 6), (1, 12), (4, 32), (4, 64)), and
        deepseek-v2-236b's and zamba2-7b's parameter and cache bytes a
        rank on (2, 3) and (4, 64) equal the reference's specs', leaf
        for leaf, with a train step, a prefill and a decode step run to
        their end there on ``meta``;

and the dry run's ``StepRecorder`` memo changes no record, its flops are
``FlopCounterMode``'s, and a 3-axis mesh orders its ranks pod-major.

Every fake group is torn down when its block ends, so that the worker
can build other groups after this file.
"""
import dataclasses
import importlib
import json
import os
import pathlib
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import arch_shapes as jarch_shapes
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.runtime import sharding as jshd
from repro_torch.checkpoint.manager import _mesh_slice
from repro_torch.configs import ARCHS, arch_shapes, get_config
from repro_torch.configs import get_train_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import prompt_batch
from repro_torch.models import model as tmodel
from repro_torch.runtime import mesh_ctx
from repro_torch.runtime import shard as shard_lib
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import serve_loop as sl
from repro_torch.runtime import train_loop as tl

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent

PRODUCTION = {"pod-16x16": ((16, 16), ("data", "model")),
              "2pods-2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's ``launch/dryrun.py``. Importing it sets
    ``XLA_FLAGS`` for 512 host devices; the variable is put back at once,
    before JAX starts a backend here, and for the processes later tests
    start."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _production(name, rank=0):
    """A fake group of the mesh's size (this process its ``rank``) and
    the production mesh on it."""
    shape, _ = PRODUCTION[name]
    multi = len(shape) == 3

    class _Ctx:
        def __enter__(self):
            self.cm = mesh_lib.fake_group(512 if multi else 256, rank=rank)
            self.cm.__enter__()
            return mesh_lib.make_production_mesh(multi_pod=multi,
                                                 device="cpu")

        def __exit__(self, *exc):
            return self.cm.__exit__(*exc)
    return _Ctx()


# ---------------------------------------------------------------------------
# the meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [0, 309, 511])
def test_production_mesh_orders_ranks_pod_major(rank):
    pod, data, model = rank // 256, rank // 16 % 16, rank % 16
    with _production("2pods-2x16x16", rank) as mesh:
        assert tuple(mesh.mesh_dim_names) == ("pod", "data", "model")
        assert tuple(mesh.mesh.shape) == (2, 16, 16)
        fsdp = mesh_lib.mesh_axes(mesh, ("pod", "data"))
        assert (fsdp.size, fsdp.index) == (32, pod * 16 + data)
        assert dist.get_process_group_ranks(fsdp.group) == [
            p * 256 + d * 16 + model for p in range(2) for d in range(16)]
        assert mesh_lib.mesh_axes(mesh, ("pod", "data")) is fsdp
        # the first request made every multi-axis group at once, so that
        # every rank makes the same new_group calls whatever it asks first
        assert set(mesh_lib._SUBGROUPS[id(mesh)][1]) == {
            ("pod", "data"), ("pod", "model"), ("data", "model")}
        assert mesh_lib.mesh_axes(mesh, ("data", "model")).index == \
            data * 16 + model
        for name, want in (("pod", pod), ("data", data), ("model", model)):
            assert mesh_lib.mesh_axes(mesh, (name,)).index == want
        # the checkpoint's cut and the model's agree on the FSDP order
        arr = np.arange(64)
        assert _mesh_slice(arr, mesh, (("pod", "data"),)).tolist() == \
            [2 * fsdp.index, 2 * fsdp.index + 1]
        with pytest.raises(ValueError):
            mesh_lib.mesh_axes(mesh, ("data", "pod"))
    assert not dist.is_initialized()


def test_fake_group_moves_nothing_and_records_each_collective():
    with mesh_lib.fake_group(8):
        mesh = mesh_lib.make_host_mesh(2, 4, backend="fake", device="cpu")
        ax = mesh_lib.mesh_axes(mesh, ("model",))
        tally = mesh_lib.collectives
        tally.reset()
        y = mesh_lib.all_gather(torch.arange(3.0), 0, ax)
        z = mesh_lib.all_reduce(torch.ones(5), dist.ReduceOp.SUM, ax)
        mesh_lib.all_reduce(torch.empty(7, device="meta"),
                            dist.ReduceOp.MAX, ax)
        mesh_ctx.all_gather(torch.ones(2, dtype=torch.bool), 0, ax)
        mesh_ctx.gather_cache(torch.ones(3), 0, ax)
        mesh_ctx.all_reduce(torch.ones(5), ax)
        mesh_ctx.all_reduce(torch.ones(5), ax)
        assert y.tolist() == [0.0, 1.0, 2.0] * 4 and z.tolist() == [1.0] * 5
        C = mesh_lib.Collective
        assert tally.calls == {C("all-gather", 48, 4): 1,
                               C("all-reduce", 20, 4): 1,
                               C("all-reduce", 28, 4): 1,
                               C("all-gather", 8, 4, "layer"): 1,
                               C("all-gather", 48, 4, "cache"): 1,
                               C("all-reduce", 20, 4, "layer"): 2}
        assert tally.count == 7
        # the sharded layers' bytes are views of the same tally
        t = mesh_ctx.traffic
        assert (t.gathered, t.cache_gathered, t.reduced) == \
            (6 + 36, 36, 40)
        got = dryrun.collective_bytes(tally)
        assert got["counts"]["all-gather"] == 3
        assert got["bytes"] == {"all-gather": 36 + 6 + 36,
                                "all-reduce": 72 + 60,
                                "reduce-scatter": 0, "all-to-all": 0,
                                "collective-permute": 0}
        tally.reset()
        assert (tally.count, t.gathered, t.reduced) == (0, 0, 0)
        with pytest.raises(ValueError):
            mesh_lib.make_production_mesh()
    assert not dist.is_initialized()


def test_step_recorder_counts_live_bytes_until_freed():
    """Each new storage counts from the op that makes it until it is
    freed, a view adds nothing, the step's arguments and what runs
    paused are not counted, and the products' flops are summed."""
    held = torch.empty(1000, device="meta")
    with dryrun.StepRecorder(held) as rec:
        a = torch.empty(10, 10, device="meta") + 1.0     # 400 B
        view = a.t()
        with rec.paused():
            torch.zeros(1 << 20, device="meta")           # a shape only
        b = held * 2.0                                    # 4,000 B
        del a, view, b
        c = torch.empty(8, 4, device="meta") @ torch.empty(4, 2,
                                                           device="meta")
    # a and b at once; then c's operands and c, and only c stays
    assert rec.peak == 400 + 4000
    assert rec.live == 4 * 16 and c.numel() == 16
    assert rec.flops == 2 * 8 * 4 * 2


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_a_model_built_on_meta_has_the_cpu_builds_parameters(arch):
    """The initialisers draw nothing on ``meta`` (shapes only): the same
    parameters, shapes and dtypes as a build on the CPU."""
    from repro_torch.launch.train import tiny_config
    cfg = tiny_config(get_config(arch))
    meta = dryrun._meta_model(cfg)
    cpu = tmodel.build_model(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    assert [(n, p.shape, p.dtype) for n, p in meta.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in cpu.named_parameters()]
    assert all(p.is_meta for p in meta.parameters())


# ---------------------------------------------------------------------------
# (i) model flops, (ii) parameter bytes a rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch, jdryrun):
    want = {s.name: jdryrun.model_flops(arch, s) for s in jarch_shapes(arch)}
    got = {s.name: dryrun.model_flops(arch, s) for s in arch_shapes(arch)}
    assert got == want and len(got) in (3, 4)


def _ref_leaf_bytes(arch, shape, names):
    """{path: bytes a rank holds} of the reference's parameters under
    its own specs on an ``AbstractMesh`` of ``shape``."""
    params = jax.eval_shape(jbuild_model(jget_config(arch)).init,
                            jax.random.PRNGKey(0))
    specs = jshd.infer_param_specs(params, AbstractMesh(shape, names))
    sizes = dict(zip(names, shape))
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_s = jax.tree.leaves(specs,
                             is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {}
    for (path, leaf), spec in zip(flat_p, flat_s):
        cut = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                cut *= sizes[a]
        key = tuple(getattr(k, "key", getattr(k, "idx", k)) for k in path)
        out[tuple(map(str, key))] = \
            int(np.prod(leaf.shape)) * leaf.dtype.itemsize // cut
    return out


#: leaves where the port's slice differs from the reference's by design
#: (none: the port resolves the reference's rules on the reference's
#: shapes, and keeps wk/wv whole where the KV heads are fewer than the
#: model axis exactly as those rules do)
DELIBERATE = {}


@pytest.mark.parametrize("mesh_name", sorted(PRODUCTION))
def test_param_bytes_a_rank_equal_the_reference_specs(mesh_name):
    shape, names = PRODUCTION[mesh_name]
    with _production(mesh_name) as mesh:
        for arch in ARCHS:
            model = shard_lib.shard_model(dryrun._meta_model(
                get_config(arch)), mesh)
            got = {leaf.path: sum(p.numel() * p.element_size()
                                  for p in leaf.params)
                   for leaf in model.layout.leaves}
            want = _ref_leaf_bytes(arch, shape, names)
            diff = {"/".join(k): (got.get(k), want.get(k))
                    for k in set(got) | set(want)
                    if got.get(k) != want.get(k)
                    and (arch, k[-1]) not in DELIBERATE}
            assert not diff, (arch, diff)
            assert dryrun.tree_bytes(model) == sum(got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_pattern_counts_equal_the_reference(arch, jdryrun):
    assert dryrun.pattern_counts(arch) == jdryrun.pattern_counts(arch)


#: FSDP leaves that a forward gathers more than once, and why: a tied
#: embedding is gathered for the lookup and again for the logits
GATHERED_TWICE = {("qwen2.5-3b", "embed")}


def _hlo_lines(tally):
    """The tally as lines of a partitioned HLO module, one a call, each
    with its result bytes and its group size, as the reference's
    ``collective_bytes`` reads them."""
    lines = []
    for c, n in tally.calls.items():
        lines += [f"%c.{len(lines) + i} = u8[{c.nbytes}]{{0}} {c.kind}("
                  f"u8[1]{{0}} %p), replica_groups=[1,{c.group_size}]"
                  f"<=[{c.group_size}]" for i in range(n)]
    return "\n".join(lines)


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen2.5-3b", "qwen2-vl-7b",
                                  "zamba2-7b", "seamless-m4t-medium"])
def test_a_prefills_fsdp_gathers_follow_the_reference_specs(arch, jdryrun):
    """One forward (the prefill at one pattern unit) on the multi-pod
    mesh gathers each leaf that the reference's ``infer_param_specs``
    cuts over ("pod", "data") once (``GATHERED_TWICE`` names the
    exceptions), at the compute dtype, over 32 ranks: its results are
    the leaf's bytes over its model-axis cut. And the dry run's wire bytes of
    the step's tally are what the reference's ``collective_bytes`` reads
    from the same calls written as HLO."""
    shape = next(s for s in arch_shapes(arch) if s.name == "prefill_32k")
    names, sizes = PRODUCTION["2pods-2x16x16"][1], (2, 16, 16)
    cut = dict(zip(names, sizes))
    params = jax.eval_shape(
        jbuild_model(jdryrun.probe_config(arch, 1)).init,
        jax.random.PRNGKey(0))
    specs = jshd.infer_param_specs(params, AbstractMesh(sizes, names))
    item = torch.empty(0, dtype=getattr(
        torch, get_config(arch).compute_dtype)).element_size()
    want_bytes = want_calls = 0
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree.leaves(specs,
                            is_leaf=lambda x: isinstance(x, PartitionSpec))):
        axes = [a for e in spec
                for a in ((e,) if isinstance(e, str) else e or ())]
        if [a for a in axes if a != "model"] != ["pod", "data"]:
            continue
        tp = cut["model"] if "model" in axes else 1
        uses = 2 if (arch, str(getattr(path[-1], "key", path[-1]))) in \
            GATHERED_TWICE else 1
        want_bytes += uses * int(np.prod(leaf.shape)) // tp * item
        want_calls += uses
    with _production("2pods-2x16x16") as mesh:
        dryrun.run_step_abstract(arch, shape, mesh,
                                 cfg=dryrun.probe_config(arch, 1))
        tally = mesh_lib.collectives
        fsdp = [(c.nbytes, n) for c, n in tally.calls.items()
                if c.kind == "all-gather" and c.group_size == 32]
        # a leaf may travel in parts: zamba2's reference stacks a group's
        # six Mamba2 layers into one leaf, which the port gathers a layer
        # at a time
        assert sum(b * n for b, n in fsdp) == want_bytes
        assert sum(n for _, n in fsdp) >= want_calls
        got = dryrun.collective_bytes(tally)
        assert got == jdryrun.collective_bytes(_hlo_lines(tally))
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (iii) the card's counts of qwen2.5-3b on (1, 4)
# ---------------------------------------------------------------------------

SEQ_ARCH, SEQ_LAYERS, TRAIN_LAYERS = "qwen2.5-3b", 36, 4
SERVE_B, SERVE_P, SERVE_G = 4, 64, 8
TRAIN_B, TRAIN_S = 8, 256


def _counted(fn):
    mesh_lib.collectives.reset()
    out = fn()
    t = mesh_ctx.traffic
    return out, (mesh_lib.collectives.count, t.gathered, t.reduced)


def _seq_serve(mesh, dtype):
    cfg = get_config(SEQ_ARCH).replace(num_layers=SEQ_LAYERS)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, compute_dtype=dtype)
    model = dryrun._meta_model(cfg)
    whole = shard_lib.resident_bytes(model)
    shard_lib.shard_model(model, mesh)
    prompt = shard_lib.shard_batch(
        prompt_batch(model, SERVE_B, SERVE_P, 0), mesh)
    (_, caches), prefill = _counted(lambda: sl.make_prefill_step(
        model, mesh, max_len=SERVE_P + SERVE_G)(prompt))
    tok = {"tokens": torch.zeros((SERVE_B, 1), dtype=torch.int32,
                                 device="meta")}
    decode = sl.jit_decode_step(model, mesh, caches,
                                shd.infer_batch_specs(tok, mesh))
    _, token = _counted(lambda: decode(tok, caches, SERVE_P + SERVE_G - 2))
    return prefill, token, shard_lib.resident_bytes(model) / whole


def test_qwen_on_a_fake_1x4_mesh_makes_the_cards_counts(monkeypatch):
    """The card's four-rank run of ``chip_smoke.py`` phase 10 (e)
    (PERF.md): a float32 decode token 219 collectives, 3,590,144 B
    all-reduced, 884,880 B gathered (442,512 in bfloat16); the prefill
    73 collectives and 153,092,096 B all-reduced; a float32 train step
    at 4 layers 46 collectives and 385,908,780 B all-reduced; resident
    parameters 0.25921519 of the one device's."""
    with mesh_lib.fake_group(4):
        mesh = mesh_lib.make_host_mesh(1, 4, backend="fake", device="cpu")
        monkeypatch.setattr(tmodel, "CACHE_DTYPE", torch.float32)
        prefill, token, share = _seq_serve(mesh, "float32")
        assert token == (219, 884_880, 3_590_144)
        assert (prefill[0], prefill[2]) == (73, 153_092_096)
        assert round(share, 8) == 0.25921519
        monkeypatch.setattr(tmodel, "CACHE_DTYPE", torch.bfloat16)
        _, token, _ = _seq_serve(mesh, None)
        assert token[:2] == (219, 442_512)

        cfg = get_config(SEQ_ARCH).replace(
            num_layers=TRAIN_LAYERS, param_dtype="float32",
            compute_dtype="float32")
        model = shard_lib.shard_model(dryrun._meta_model(cfg), mesh)
        tcfg = dataclasses.replace(get_train_config(SEQ_ARCH),
                                   microbatches=1, total_steps=200,
                                   warmup_steps=10)
        ids = torch.zeros((TRAIN_B, TRAIN_S), dtype=torch.int32,
                          device="meta")
        batch = shard_lib.shard_batch({"tokens": ids, "labels": ids}, mesh)
        state = tl.make_train_state(model, tcfg)
        step = tl.make_train_step(model, tcfg, mesh)
        _, counts = _counted(lambda: step(state, batch))
        assert (counts[0], counts[2]) == (46, 385_908_780)
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (iv) every family on both production meshes
# ---------------------------------------------------------------------------

#: one arch of each family (dense, vlm, moe with MLA, moe with a dense
#: residual, ssm, hybrid, encdec)
FAMILIES = ("qwen2.5-3b", "qwen2-vl-7b", "deepseek-v2-236b", "arctic-480b",
            "xlstm-1.3b", "zamba2-7b", "seamless-m4t-medium")

#: the sLSTM's loop over time runs a Python step per position (~2 ms a
#: step on meta): its train_4k and prefill_32k probes run here at 512
#: positions, and at full length in the CLI's table (PERF.md)
SHORT_LOOP = 512


def _probe_shape(arch, shape):
    if get_config(arch).family == "ssm" and shape.mode != "decode":
        return ShapeConfig(shape.name, SHORT_LOOP, shape.global_batch,
                           shape.mode)
    return shape


@pytest.mark.parametrize("mesh_name", sorted(PRODUCTION))
def test_each_family_runs_each_production_shape(mesh_name):
    with _production(mesh_name) as mesh:
        for arch in FAMILIES:
            for shape in arch_shapes(arch):
                rec = dryrun.run_probe(arch, _probe_shape(arch, shape),
                                       mesh, mesh_name, 1)
                assert rec["ok"], (arch, shape.name, rec.get("traceback"))
                mem = rec["memory"]
                assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
                assert mem["temp_bytes"] == \
                    mem["peak_bytes"] - mem["argument_bytes"]
                assert rec["flops"] > 0
                assert rec["collectives"]["total_bytes"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "train_4k"),
                                        ("zamba2-7b", "prefill_32k"),
                                        ("deepseek-v2-236b", "decode_32k")])
def test_memo_changes_no_record_and_flops_are_flop_counters(arch, shape):
    sh = _probe_shape(arch, next(s for s in arch_shapes(arch)
                                 if s.name == shape))
    cfg = dryrun.probe_config(arch, 1)
    with _production("2pods-2x16x16") as mesh:
        slow = dryrun.run_step_abstract(arch, sh, mesh, cfg=cfg, fast=False)
        fast = dryrun.run_step_abstract(arch, sh, mesh, cfg=cfg)
        with FlopCounterMode(display=False) as fc:
            counted = dryrun.run_step_abstract(arch, sh, mesh, cfg=cfg,
                                               fast=False)
    assert fast == slow
    assert counted["flops"] == slow["flops"] == fc.get_total_flops() > 0


def test_cli_runs_a_cell_and_says_so(tmp_path, capsys):
    out = tmp_path / "d.json"
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--mesh", "multi", "--out", str(out)]) == 0
    assert "DRYRUN 1/1 cells OK" in capsys.readouterr().out
    (rec,) = json.loads(out.read_text())
    assert rec["ok"] and rec["mesh"] == "2pods-2x16x16"
    assert rec["memory"]["fits_h100_80gb"]
    assert set(rec["collectives"]) >= {"bytes", "counts", "total_bytes",
                                       "calls", "gathered", "reduced",
                                       "cache_gathered"}
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# (v) the matcher cell
# ---------------------------------------------------------------------------

#: the cell's problem, cut from 128 × 128 (22 s a rank on one CPU) so
#: that a real world of 8 gloo ranks fits the file's time
MATCH_N = 32

GLOO_MATCH = textwrap.dedent('''
    import json, sys
    from repro_torch.launch import dryrun, mesh as mesh_lib
    rank, store, out, n = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
    mesh_lib.init_group("gloo", init_method="file://" + store,
                        rank=int(rank), world_size=8, device="cpu",
                        timeout_s=120)
    mesh = mesh_lib.make_host_mesh(2, 4, backend="gloo", device="cpu")
    rec = dryrun.run_matcher(mesh, "cpu", n=int(n), m=int(n))
    with open(out, "w") as f:
        json.dump(rec["collectives"]["counts"] | {"epochs": rec["epochs_run"]},
                  f)
''')


def test_matcher_cell_counts_a_real_worlds_collectives(tmp_path):
    with mesh_lib.fake_group(8):
        mesh = mesh_lib.make_host_mesh(2, 4, backend="fake", device="cpu")
        rec = dryrun.run_matcher(mesh, "cpu", n=MATCH_N, m=MATCH_N)
    assert rec["shards"] == 8
    assert rec["mappings_shape"][1:] == [8 * 32, MATCH_N, MATCH_N]
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-c", GLOO_MATCH, str(r), str(tmp_path / "st"),
             str(tmp_path / f"r{r}.json"), str(MATCH_N)] for r in range(8)]
    mesh_lib.run_ranks(cmds, timeout_s=300, env=env)
    real = [json.loads((tmp_path / f"r{r}.json").read_text())
            for r in range(8)]
    assert all(r == real[0] for r in real)
    assert real[0] == rec["collectives"]["counts"] | {
        "epochs": rec["epochs_run"]}


# ---------------------------------------------------------------------------
# (vi) model axes that do not divide the heads
# ---------------------------------------------------------------------------

#: (data, model) shapes whose model axis divides neither MLA's 128 heads
#: nor its latent rank of 512 (3, 6, 12), or divides deepseek's but not
#: zamba2's 32 Mamba2 heads, cutting zamba2's state on N (64)
ODD_MESHES = ((1, 3), (2, 3), (1, 6), (1, 12), (4, 32), (4, 64))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", ODD_MESHES,
                         ids=[f"{d}x{m}" for d, m in ODD_MESHES])
def test_published_configs_lay_out_on_odd_model_axes(shape, arch):
    """Each config as published (its widths; one pattern unit deep, as
    a stack's depth is an axis no rule cuts) lays out on rank 0 of a
    fake group of the mesh's size, and ``check_serve_layout`` passes at
    a batch of 16 with 4,096 positions and at a batch of 1."""
    cfg = get_config(arch)
    sl.check_serve_layout(cfg, 16, 4096, dict(zip(("data", "model"),
                                                  shape)))
    sl.check_serve_layout(cfg, 1, 32768, dict(zip(("data", "model"),
                                                  shape)))
    with mesh_lib.fake_group(shape[0] * shape[1]):
        mesh = mesh_lib.make_host_mesh(*shape, backend="fake", device="cpu")
        model = shard_lib.shard_model(dryrun._meta_model(
            dryrun.probe_config(arch, 1)), mesh)
        assert model.layout.tp.size == shape[1]
    assert not dist.is_initialized()


def _ref_cache_bytes(arch, shape, batch, max_len):
    """{path: bytes a rank holds} of the reference's caches (one pattern
    unit deep) under its ``infer_cache_specs`` on an ``AbstractMesh``."""
    names = ("data", "model")
    model = jbuild_model(jdryrun_probe(arch))
    caches = jax.eval_shape(lambda: model.init_caches(batch, max_len))
    specs = jshd.infer_cache_specs(caches, AbstractMesh(shape, names))
    sizes = dict(zip(names, shape))
    out = {}
    for (path, leaf), spec in zip(
            jax.tree_util.tree_flatten_with_path(caches)[0],
            jax.tree.leaves(specs,
                            is_leaf=lambda x: isinstance(x, PartitionSpec))):
        cut = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                cut *= sizes[a]
        key = tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)
        out[key] = int(np.prod(leaf.shape)) * leaf.dtype.itemsize // cut
    return out


def jdryrun_probe(arch):
    """The reference's config at one pattern unit (``probe_config``'s
    depth)."""
    cfg = dryrun.probe_config(arch, 1)
    return jget_config(arch).replace(num_layers=cfg.num_layers,
                                     encoder_layers=cfg.encoder_layers)


def _flat_bytes(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_bytes(v, prefix + (k,))
    else:
        yield prefix, tree.numel() * tree.element_size()


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-7b"])
@pytest.mark.parametrize("shape", [(2, 3), (4, 64)], ids=["2x3", "4x64"])
def test_odd_mesh_bytes_a_rank_equal_the_reference_specs(shape, arch):
    """On (2, 3) and (4, 64): each rank's parameter bytes (the whole
    depth) and cache bytes (one pattern unit, a batch of 8 and 256
    positions) equal those of the reference's ``infer_param_specs`` /
    ``infer_cache_specs`` on an ``AbstractMesh`` of the same shape, leaf
    for leaf; then a train step (two microbatches), a prefill and a
    decode step of the unit run to their end on ``meta``."""
    names = ("data", "model")
    B, L = 8, 256
    with mesh_lib.fake_group(shape[0] * shape[1]):
        mesh = mesh_lib.make_host_mesh(*shape, backend="fake", device="cpu")
        model = shard_lib.shard_model(dryrun._meta_model(get_config(arch)),
                                      mesh)
        got = {leaf.path: sum(p.numel() * p.element_size()
                              for p in leaf.params)
               for leaf in model.layout.leaves}
        assert got == _ref_leaf_bytes(arch, shape, names), arch
        unit = shard_lib.shard_model(dryrun._meta_model(
            dryrun.probe_config(arch, 1)), mesh)
        caches = dict(_flat_bytes(unit.init_caches(B, L)))
        assert caches == _ref_cache_bytes(arch, shape, B, L), arch
        for sh in (ShapeConfig("train", 64, B, "train"),
                   ShapeConfig("prefill", 64, B, "prefill"),
                   ShapeConfig("decode", L, B, "decode")):
            rec = dryrun.run_step_abstract(arch, sh, mesh,
                                           cfg=dryrun.probe_config(arch, 1),
                                           microbatch_override=2)
            assert rec["memory"]["peak_bytes"] > 0, (arch, sh.name)
    assert not dist.is_initialized()
