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
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert (ROOT / "chip_smoke.py").exists()
    for f in files:
        hits = _FORBIDDEN.findall(f.read_text())
        assert not hits, f"{f}: {hits}"


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


def test_cpu_runs_launch_no_kernel():
    from repro_torch.core import pso
    from repro_torch.core.matcher import IMMSchedMatcher
    from repro_torch.kernels import (epoch_fused, finish_fused,
                                     prune_fixpoint, pso_fitness)
    counters = [prune_fixpoint.launches, pso_fitness.launches,
                pso_fitness.launches_quantized, epoch_fused.launches,
                finish_fused.launches]
    for c in counters:
        c.reset()
    q, g = _tiny()
    for quantized in (False, True):
        cfg = pso.PSOConfig(num_particles=8, epochs=2, inner_steps=3,
                            quantized=quantized, early_exit=True)
        res = IMMSchedMatcher(cfg, device="cpu").match(
            q, g, generator=torch.Generator().manual_seed(0))
        assert res.epochs_run >= 1
    assert [c.count for c in counters] == [0, 0, 0, 0, 0]
