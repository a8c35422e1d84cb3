"""The port's three scheduling examples (``repro_torch.examples.
{online_service,interruptible_serving,schedule_multi_dnn}``) against the
JAX package's own ``examples/*.py``, on the CPU.

Each reference example runs as written (its module loaded from
``examples/``) with its matcher calls recorded; the port's runs through
its ``main(["--device", "cpu"])`` with the reference's draws injected
where the outcome depends on them (``PRNGKey(i)`` of arrival i; the
scheduler's ``PRNGKey(0)``):

  * online_service: per arrival, bucket, found, warm hit and epochs run
    are equal, and every served mapping passes the JAX
    ``ref.is_feasible``;
  * interruptible_serving: the analytic IsoSched and MoCA ``SimResult``s
    are equal bit for bit (minus wall clocks), IMMSched's real-mode
    urgent counts equal;
  * schedule_multi_dnn: the merged DAG is the reference's, both find a
    match, and the port's ILP tensors equal the reference's
    ``build_schedule_tensors`` of the port's mapping, with no violation.
    (Matches of a real problem drift with the carries, ROADMAP Queue 3,
    so the mapping itself is not compared.)
"""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.accel import platform as jplat
from repro.core import ilp as jilp
from repro.core import matcher as jmatcher
from repro.core import preemptible_dag as jpd
from repro.core import service as jservice
from repro.sched import simulator as jsim
from repro_torch.core import ilp as tilp
from repro_torch.core.service import MatcherService, shape_bucket
from repro_torch.examples import (interruptible_serving, online_service,
                                  schedule_multi_dnn)
from test_torch_sched import _comparable, _diff
from test_torch_sched_real import _record, _reference_keys
from test_torch_service import _check_mapping, _jax_stream

jax.config.update("jax_platform_name", "cpu")

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the port: its many small products can
    spend minutes in OpenMP's barriers when other processes load every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wrap(monkeypatch, owner, attr, seen):
    """Record what ``owner.attr`` returns into ``seen``."""
    orig = getattr(owner, attr)

    def wrapped(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out)
        return out
    monkeypatch.setattr(owner, attr, wrapped)


def test_online_service_equals_the_reference(monkeypatch, capsys):
    want = []
    _wrap(monkeypatch, jservice.MatcherService, "match", want)
    _reference_example("online_service").main()
    orig = MatcherService.match

    def match(self, q, g, key=None, **kw):        # PRNGKey(key)'s draws
        bucket = shape_bucket(q.n, g.n, self.n_multiple, self.m_multiple)
        return orig(self, q, g, key=_jax_stream(key, bucket, self.cfg),
                    **kw)
    monkeypatch.setattr(MatcherService, "match", match)
    got = online_service.main(["--device", "cpu"])
    assert len(got) == len(want) == 12
    assert [(r["bucket"], r["found"], r["warm"], r["epochs"])
            for r in got] == \
        [(tuple(w.bucket), bool(w.found), bool(w.warm_hit),
          int(w.epochs_run)) for w in want]
    assert any(r["warm"] for r in got) and any(r["compiled"] for r in got)
    for r in got:
        if r["found"]:
            _check_mapping(r["mapping"], r["query"], r["target"])
    assert "compile cache: " in capsys.readouterr().out


def test_interruptible_serving_equals_the_reference(monkeypatch):
    want = []
    _wrap(monkeypatch, jsim.Simulator, "run", want)
    _reference_example("interruptible_serving").main()
    served = []
    _record(monkeypatch, MatcherService, served, _reference_keys)
    got = interruptible_serving.main(["--device", "cpu"])
    assert list(got) == [n for n, _ in interruptible_serving.RUNS]
    want = dict(zip(got, want))
    for name in ("isosched", "moca"):
        assert not _diff(_comparable(got[name]), _comparable(want[name]))
    mine, theirs = got["immsched"], want["immsched"]
    assert (mine.urgent_met, mine.urgent_total) == \
        (theirs.urgent_met, theirs.urgent_total)
    assert mine.urgent_met == mine.urgent_total == 1
    assert served and all(r.found for _, r in served)
    for (q, g), r in served:
        _check_mapping(r.mapping, q, g)


def test_schedule_multi_dnn_equals_the_reference(monkeypatch):
    pdags, results = [], []
    _wrap(monkeypatch, jpd, "build_preemptible_dag", pdags)
    _wrap(monkeypatch, jmatcher.IMMSchedMatcher, "match", results)
    _reference_example("schedule_multi_dnn").main()
    (jpdag,), (jres,) = pdags, results
    pdag, res, st = schedule_multi_dnn.main(["--device", "cpu"])
    assert pdag.n == jpdag.n
    assert pdag.task_tiles == jpdag.task_tiles
    np.testing.assert_array_equal(pdag.graph.adj, jpdag.graph.adj)
    assert res.found and jres.found
    want = jilp.build_schedule_tensors(jpdag, np.asarray(res.mapping),
                                       jplat.CLOUD)
    np.testing.assert_array_equal(st.X, want.X)
    np.testing.assert_array_equal(st.Y, want.Y)
    assert (st.task_ids, st.link_ids) == (want.task_ids, want.link_ids)
    assert jilp.validate_schedule(want, jpdag) == []
    assert tilp.validate_schedule(st, pdag) == []


@pytest.mark.parametrize("example", [online_service, interruptible_serving,
                                     schedule_multi_dnn])
def test_examples_run_on_the_card_by_default(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main([])
