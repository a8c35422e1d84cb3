"""The port stands alone: it imports neither JAX nor the JAX package,
imports without nvcc or a card, runs on the card unless asked for the
CPU, and launches no kernel on CPU tensors."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s+import))", re.M)


def _modules():
    return sorted(".".join(p.relative_to(PKG.parent).with_suffix("").parts)
                  .replace(".__init__", "")
                  for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_nvcc_or_card():
    code = ("import importlib, sys\n"
            f"for name in {_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_or_repro_import_in_the_port_sources():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "kernel_ab.py"]
    assert all(f.exists() for f in files)
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


@pytest.mark.parametrize("script", [["chip_smoke.py"],
                                    ["kernel_ab.py", "."]])
def test_card_scripts_fail_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, *script], cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin",
                              "CUDA_VISIBLE_DEVICES": ""},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _tiny():
    from repro_torch.core import graphs
    rng = np.random.default_rng(4)
    q = graphs.random_dag(rng, 5, 0.4)
    return q, graphs.embed_query_in_target(rng, q, 9)


def test_matcher_defaults_to_the_card():
    from repro_torch.core import pso
    from repro_torch.core.matcher import IMMSchedMatcher
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    q, g = _tiny()
    cfg = pso.PSOConfig(num_particles=4, epochs=1, inner_steps=2)
    with pytest.raises(RuntimeError):
        IMMSchedMatcher(cfg).match(q, g)


def test_service_defaults_to_the_card():
    from repro_torch.core import pso
    from repro_torch.core.service import MatcherService
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    q, g = _tiny()
    cfg = pso.PSOConfig(num_particles=4, epochs=1, inner_steps=2)
    with pytest.raises(RuntimeError):
        MatcherService(cfg).match(q, g)


def test_simulator_and_scheduler_default_to_the_card():
    """A simulation with IMMSched builds its matcher service on
    ``SimConfig.device``, the card by default, in analytic mode too."""
    from repro_torch.accel.platform import EDGE
    from repro_torch.sched import IMMSchedScheduler, SimConfig, Simulator
    from repro_torch.sched.tasks import fixed_scenario
    from repro_torch.workloads.zoo import workload_complexity_class
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    sc = fixed_scenario(workload_complexity_class("simple")[:2])
    for mode in ("analytic", "real"):
        cfg = SimConfig(platform=EDGE, matcher_mode=mode)
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError):
            Simulator(cfg, IMMSchedScheduler()).run(sc)
    r = Simulator(SimConfig(platform=EDGE, device="cpu"),
                  IMMSchedScheduler()).run(sc)
    assert r.finished == r.total == 2


def test_cpu_runs_launch_no_kernel():
    from repro_torch.core import pso, split_epoch
    from repro_torch.core.matcher import IMMSchedMatcher
    from repro_torch.kernels import (argmax_project, backend, cases,
                                     epoch_fused, finish_fused,
                                     prune_fixpoint, pso_fitness, pso_update,
                                     ullmann_refine)
    counters = [prune_fixpoint.launches, pso_fitness.launches,
                pso_fitness.launches_quantized, epoch_fused.launches,
                epoch_fused.launches_float, finish_fused.launches,
                pso_update.launches, ullmann_refine.launches,
                argmax_project.launches_greedy,
                argmax_project.launches_argmax]
    for c in counters:
        c.reset()
    q, g = _tiny()
    for quantized in (False, True):
        cfg = pso.PSOConfig(num_particles=8, epochs=2, inner_steps=3,
                            quantized=quantized, early_exit=True)
        res = IMMSchedMatcher(cfg, device="cpu").match(
            q, g, stream=0)
        assert res.epochs_run >= 1
    # the split epoch and the masked argmax through the cuda suite
    Q, G, mask = cases.random_problem(1, 6, 10, 3)
    x = cases.swarm_inputs(Q, G, mask, 4, 2, seed=1)
    for quantized in (False, True):
        cfg = pso.PSOConfig(num_particles=4, inner_steps=2,
                            quantized=quantized, backend="cuda")
        out = split_epoch.split_epoch(
            x["S"][0], x["V"][0], x["S"][0], x["f_local"][0],
            x["S_star"][0], x["f_star"][0], x["S_bar"][0], mask[0], Q[0],
            G[0], x["r_all"][0], cfg)
        backend.for_config(cfg).masked_argmax(out[1], mask[0])
    # a real-mode simulation: IMMSched's decisions through the service
    from repro_torch.accel.platform import EDGE
    from repro_torch.sched import SimConfig, Simulator, get_scheduler
    from repro_torch.sched.tasks import fixed_scenario
    from repro_torch.workloads.zoo import get_workload
    sim_cfg = SimConfig(platform=EDGE, matcher_mode="real", window_stages=2,
                        pso_cfg=pso.PSOConfig(num_particles=8, epochs=1,
                                              inner_steps=2),
                        device="cpu")
    r = Simulator(sim_cfg, get_scheduler("immsched")).run(fixed_scenario(
        [get_workload("resnet50"), get_workload("mobilenetv2")]))
    assert r.matcher_stats["calls"] >= 1
    assert [c.count for c in counters] == [0] * len(counters)


class _StubEntry:
    """Stands in for a ``ctypes`` C function: takes argtypes/restype."""

    def __init__(self, lib, name):
        self.lib, self.name = lib, name
        self.argtypes = self.restype = None


class _StubLibrary:
    """Stands in for a loaded ``ctypes.CDLL``: one entry object per name,
    and a count of the lookups."""

    def __init__(self):
        self.lookups = 0

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        self.lookups += 1
        entry = _StubEntry(self, name)
        object.__setattr__(self, name, entry)
        return entry


def test_bindings_follow_a_swapped_library(monkeypatch):
    """``bind`` looks an entry up once per loaded library, and a library
    swapped into ``_libs`` (as kernel_ab.py does) is the one bound."""
    from repro_torch.kernels import _build as kb
    a, b = _StubLibrary(), _StubLibrary()
    types = [kb.P_, kb.I_]
    monkeypatch.setitem(kb._libs, "argmax_project", a)
    fa = kb.bind("argmax_project", "masked_argmax", types)
    assert fa.lib is a and fa.argtypes == types
    assert kb.bind("argmax_project", "masked_argmax", types) is fa
    assert a.lookups == 1
    monkeypatch.setitem(kb._libs, "argmax_project", b)
    fb = kb.bind("argmax_project", "masked_argmax", types)
    assert fb.lib is b and fb is not fa and fb.argtypes == types
    monkeypatch.setitem(kb._libs, "argmax_project", a)
    assert kb.bind("argmax_project", "masked_argmax", types) is fa
    assert (a.lookups, b.lookups) == (1, 1)
    assert kb.bind("argmax_project", "greedy_project", types).lib is a
