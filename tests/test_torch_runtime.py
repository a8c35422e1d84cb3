"""The port's runtime layer on the CPU, against the JAX package:
``repro_torch.runtime.ft`` (the straggler watchdog, the elastic mesh
shape, engine re-matching after a failure), the elastic
``CheckpointManager.restore`` on 1, 2 and 4 gloo ranks, and the two
examples of ``repro_torch.examples``."""
import os
import pathlib
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.accel import EDGE as JEDGE
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.runtime import ft as jft
from repro.workloads import get_workload as jget_workload
from repro_torch.accel.platform import EDGE
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import pso
from repro_torch.core.matcher import IMMSchedMatcher
from repro_torch.examples import fault_tolerant_rematch, quickstart
from repro_torch.launch import mesh as mesh_lib
from repro_torch.runtime import ft
from repro_torch.workloads.zoo import get_workload

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _steps():
    rng = np.random.default_rng(0)
    return ([0.1] * 20 + [1.0] + list(0.1 + 0.02 * rng.standard_normal(40))
            + [0.5, 0.1, 3.0])


@pytest.mark.parametrize("warmup,k_sigma", [(5, 3.0), (10, 3.0), (3, 1.5)])
def test_watchdog_matches_the_jax_package(warmup, k_sigma):
    mine = ft.StepWatchdog(warmup=warmup, k_sigma=k_sigma)
    theirs = jft.StepWatchdog(warmup=warmup, k_sigma=k_sigma)
    flags = [(mine.observe(t), theirs.observe(t)) for t in _steps()]
    assert [a for a, _ in flags] == [b for _, b in flags]
    assert any(a for a, _ in flags)
    assert (mine.mean, mine.var, mine.count) == \
        (theirs.mean, theirs.var, theirs.count)


def test_watchdog_flags_straggler():
    wd = ft.StepWatchdog(warmup=5)
    assert not any(wd.observe(0.1) for _ in range(20))
    assert wd.observe(1.0)


@pytest.mark.parametrize("n", [512, 496, 256, 240, 1024, 1008, 16, 31])
def test_elastic_mesh_shape_matches_the_jax_package(n):
    assert ft.elastic_mesh_shape(n) == jft.elastic_mesh_shape(n)
    assert ft.elastic_mesh_shape(n, model_parallel=8) == \
        jft.elastic_mesh_shape(n, model_parallel=8)


def test_elastic_mesh_shape_keeps_the_model_axis():
    with pytest.raises(ValueError):
        ft.elastic_mesh_shape(8)
    assert ft.surviving_engine_mask(5, [1, 3]) == \
        jft.surviving_engine_mask(5, [1, 3])


class _Recorder:
    """A matcher that records the problem it is given and finds
    nothing."""

    def match(self, q, target):
        self.problem = (q, target)
        return type("NotFound", (), {"found": False, "mapping": None})()


@pytest.mark.parametrize("failed", [[], list(range(8)) + [21, 42],
                                    list(range(0, 64, 3))])
def test_remap_on_failure_matches_the_jax_package(failed):
    """The query and target the port's ``remap_on_failure`` hands its
    matcher are, bit for bit, those the JAX package's hands its own; the
    mapping the port then finds is feasible and avoids failed engines."""
    mine, theirs = _Recorder(), _Recorder()
    assert ft.remap_on_failure(EDGE, get_workload("resnet50"), failed,
                               matcher=mine)[0] is None
    assert jft.remap_on_failure(JEDGE, jget_workload("resnet50"), failed,
                                matcher=theirs)[0] is None
    q, target = ft.failure_problem(EDGE, get_workload("resnet50"), failed)
    for got in (mine.problem, (q, target)):
        for g, want in zip(got, theirs.problem):
            for f in ("adj", "types", "weights"):
                np.testing.assert_array_equal(getattr(g, f),
                                              getattr(want, f))
    cfg = pso.PSOConfig(num_particles=16, epochs=2, inner_steps=6,
                        quantized=True)
    mapping, target = ft.remap_on_failure(
        EDGE, get_workload("resnet50"), failed,
        matcher=IMMSchedMatcher(cfg, device="cpu"))
    assert mapping is not None
    M = mapping.astype(np.int64)
    assert (M.sum(1) == 1).all() and (M.sum(0) <= 1).all()
    assert ((M @ target.adj.astype(np.int64) @ M.T) >= q.adj).all()
    used = {int(target.weights[j]) for j in np.where(mapping)[1]}
    assert not used & set(failed)


def test_remap_on_failure_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        ft.remap_on_failure(EDGE, get_workload("resnet50"), [])


@pytest.mark.parametrize("example", [quickstart, fault_tolerant_rematch])
def test_examples_run_on_the_cpu(example, capsys):
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip()
    if example is fault_tolerant_rematch:
        assert "none failed: OK" in out
        assert "496 live devices -> mesh (31, 16)" in out
    else:
        assert "all query edges preserved: True" in out


# ----------------------------- elastic restore ----------------------------

STATE = {"params": {"w": np.arange(24.0, dtype=np.float32).reshape(6, 4),
                    "b": np.arange(8, dtype=np.int32)},
         "grid": np.arange(16.0, dtype=np.float32).reshape(4, 4),
         "step": np.int32(7)}

RESTORE = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import mesh as mesh_lib
    rank, world, store, ckpt, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    mesh_lib.init_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world, device="cpu", timeout_s=120)
    like = {"params": {"w": torch.zeros(6, 4), "b": np.zeros(8, np.int32)},
            "grid": torch.zeros(4, 4), "step": np.int32(0)}
    out = {}
    meshes = [(world, 1, ("data", None))]
    if world == 4:
        meshes.append((2, 2, (("data", "model"), None)))
    for d, mo, spec in meshes:
        mesh = mesh_lib.make_host_mesh(d, mo, backend="gloo", device="cpu")
        shardings = {"params": {"w": (mesh, spec), "b": (mesh, ("data",))},
                     "grid": (mesh, (None, "model")),
                     "step": torch.device("cpu")}
        state, extras = CheckpointManager(ckpt).restore(
            like, shardings=shardings)
        assert extras["step"] == 9, extras
        assert state["grid"].dtype == torch.float32
        assert state["params"]["b"].dtype == torch.int32
        for k, v in (("w", state["params"]["w"]), ("b", state["params"]["b"]),
                     ("grid", state["grid"]), ("step", state["step"])):
            out[f"{d}x{mo}.{k}"] = v.numpy()
    np.savez(out_path, **out)
    print("RESTORE-OK", rank)
''')


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint the JAX package's manager wrote (steps 7 and 9)."""
    d = tmp_path_factory.mktemp("ckpt")
    mgr = JCheckpointManager(str(d), async_save=False)
    state = {"params": {k: jnp.asarray(v) for k, v in
                        STATE["params"].items()},
             "grid": jnp.asarray(STATE["grid"]), "step": jnp.int32(7)}
    mgr.save(7, state, extras={"step": 7})
    mgr.save(9, state, extras={"step": 9})
    return d


@pytest.fixture(scope="module")
def restored(jax_checkpoint, tmp_path_factory):
    """The JAX checkpoint restored on worlds of 1, 2 and 4 gloo ranks,
    all at once; ``{world: [per-rank outputs]}``."""
    tmp = tmp_path_factory.mktemp("restore")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cmds = [[sys.executable, "-c", RESTORE, str(r), str(w),
             str(tmp / f"store{w}"), str(jax_checkpoint),
             str(tmp / f"w{w}r{r}.npz")]
            for w in (1, 2, 4) for r in range(w)]
    for _, so, se in mesh_lib.run_ranks(cmds, timeout_s=300, env=env):
        assert "RESTORE-OK" in so, se[-4000:]
    return {w: [dict(np.load(tmp / f"w{w}r{r}.npz")) for r in range(w)]
            for w in (1, 2, 4)}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_restore_is_elastic_over_ranks(restored, world):
    """Each rank keeps its ``np.array_split`` slice of every sharded
    leaf (uneven where the dim does not divide) and the whole of a
    replicated one."""
    for r, out in enumerate(restored[world]):
        w, b, grid = (STATE["params"]["w"], STATE["params"]["b"],
                      STATE["grid"])
        p = f"{world}x1."
        np.testing.assert_array_equal(out[p + "w"],
                                      np.array_split(w, world)[r])
        np.testing.assert_array_equal(out[p + "b"],
                                      np.array_split(b, world)[r])
        np.testing.assert_array_equal(out[p + "grid"], grid)
        assert out[p + "step"].shape == () and int(out[p + "step"]) == 7
        if world == 4:   # a (2, 2) mesh: rank = 2·d + m
            d, m = divmod(r, 2)
            np.testing.assert_array_equal(out["2x2.w"],
                                          np.array_split(w, 4)[r])
            np.testing.assert_array_equal(out["2x2.b"],
                                          np.array_split(b, 2)[d])
            np.testing.assert_array_equal(
                out["2x2.grid"], np.array_split(grid, 2, axis=1)[m])


def test_restore_reads_across_packages(jax_checkpoint, tmp_path):
    like = {"params": {"w": torch.zeros(6, 4), "b": np.zeros(8, np.int32)},
            "grid": torch.zeros(4, 4), "step": np.int32(0)}
    state, extras = CheckpointManager(str(jax_checkpoint)).restore(like)
    assert extras == {"step": 9}
    assert torch.is_tensor(state["params"]["w"])
    assert state["params"]["b"].dtype == np.int32
    np.testing.assert_array_equal(state["params"]["w"].numpy(),
                                  STATE["params"]["w"])
    state7, _ = CheckpointManager(str(jax_checkpoint)).restore(
        like, step=7, shardings={"params": {"w": torch.device("cpu"),
                                            "b": None},
                                 "grid": None, "step": None})
    assert torch.is_tensor(state7["params"]["w"])
    # the port writes, the JAX package restores
    mine = CheckpointManager(str(tmp_path), async_save=False)
    mine.save(3, {"params": {"w": torch.from_numpy(STATE["params"]["w"]),
                             "b": STATE["params"]["b"]},
                  "grid": torch.from_numpy(STATE["grid"]),
                  "step": np.int32(7)}, extras={"step": 3})
    theirs, extras = JCheckpointManager(str(tmp_path)).restore(
        {"params": {k: jnp.zeros_like(v) for k, v in
                    STATE["params"].items()},
         "grid": jnp.zeros((4, 4)), "step": jnp.int32(0)})
    assert extras == {"step": 3}
    np.testing.assert_array_equal(theirs["params"]["w"], STATE["params"]["w"])
    np.testing.assert_array_equal(theirs["grid"], STATE["grid"])
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(like)
