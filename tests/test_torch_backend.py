"""The port's kernel seam (``repro_torch.kernels.backend``): selection
precedence with ``REPRO_KERNEL_BACKEND``, ``register_backend`` and custom
suites, ported from the JAX package's ``tests/test_backend.py``. Custom
suites are held against the ``ref`` suite on CPU tensors at the shapes of
that file's ``_Problem``."""
import numpy as np
import pytest
import torch

from repro_torch.core import pso
from repro_torch.kernels import cases
from repro_torch.kernels.backend import (_REGISTRY, ENV_VAR, KernelBackend,
                                         config_digest, get_backend,
                                         register_backend,
                                         registered_backends,
                                         resolve_backend_name)


def _problem(seed, B, n, m):
    """A random row-stochastic swarm S (B, n, m) and a DAG pair (Q, G)."""
    Q, G, _ = cases.random_problem(1, n, m, seed)
    S = torch.from_numpy(np.random.default_rng(seed).random(
        (B, n, m)).astype(np.float32))
    return S / S.sum(-1, keepdim=True), Q[0], G[0]


def _assert_same(got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.shape == w.shape
        if w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-4)
        else:
            assert torch.equal(g, w)


def test_selection_precedence(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    # 4. the platform default: the card's suite
    assert resolve_backend_name() == "cuda"
    assert resolve_backend_name(config=pso.PSOConfig()) == "cuda"
    # 3. the variable beats the default (and "auto" configs)
    monkeypatch.setenv(ENV_VAR, "ref")
    assert resolve_backend_name() == "ref"
    assert resolve_backend_name(config=pso.PSOConfig(backend="auto")) \
        == "ref"
    assert get_backend(config=pso.PSOConfig()).name == "ref"
    # 2. an explicit config beats the variable
    assert resolve_backend_name(config=pso.PSOConfig(backend="cuda")) \
        == "cuda"
    # 1. an explicit argument beats everything
    assert resolve_backend_name(
        "cuda", config=pso.PSOConfig(backend="ref")) == "cuda"
    assert get_backend("ref").name == "ref"
    # an empty or "auto" variable falls through to the default
    for value in ("", "auto", "  AUTO "):
        monkeypatch.setenv(ENV_VAR, value)
        assert resolve_backend_name() == "cuda"


def test_config_digest_follows_the_variable(monkeypatch):
    """The digest covers the resolved suite: an "auto" config's digest
    moves with the variable, an explicit one's does not."""
    auto, pinned = pso.PSOConfig(), pso.PSOConfig(backend="cuda")
    monkeypatch.delenv(ENV_VAR, raising=False)
    before = config_digest(auto), config_digest(pinned)
    monkeypatch.setenv(ENV_VAR, "ref")
    assert config_digest(auto) != before[0]
    assert config_digest(pinned) == before[1]
    monkeypatch.setenv(ENV_VAR, "cuda")
    assert config_digest(auto) == before[0]


def test_unknown_backend_raises_with_registered_list():
    with pytest.raises(KeyError, match="registered"):
        get_backend("no-such-backend")


def test_register_custom_backend_roundtrip():
    class Custom(KernelBackend):
        pass

    try:
        register_backend(Custom("custom-test", ops_backend="ref"))
        assert "custom-test" in registered_backends()
        bk = get_backend("custom-test")
        assert isinstance(bk, Custom) and bk.ops_backend == "ref"
        S, Q, G = _problem(3, 1, 8, 16)
        _assert_same(bk.edge_fitness(S, Q, G),
                     get_backend("ref").edge_fitness(S, Q, G))
        # a JAX config naming the suite keeps it
        assert pso.PSOConfig.from_dict(
            {"backend": "custom-test"}).backend == "custom-test"
    finally:
        _REGISTRY.pop("custom-test", None)


def test_register_custom_backend_defaults_and_casing():
    """A suite registered with no ops_backend runs its inherited kernels
    on the platform default (the dispatch layer: on CPU tensors, the
    plain versions), and mixed-case names resolve through every
    selection route."""
    try:
        register_backend(KernelBackend("MySuite"))
        bk = get_backend("MySuite")
        assert bk.name == "mysuite" and bk.ops_backend == "cuda"
        assert get_backend(config=pso.PSOConfig(backend="MySuite")) is bk
        S, Q, G = _problem(5, 1, 8, 16)
        _assert_same(bk.edge_fitness(S, Q, G),
                     get_backend("ref").edge_fitness(S, Q, G))
        S_q = get_backend("ref").quantize_s(S)
        _assert_same(bk.edge_fitness_quantized(S_q, Q, G),
                     get_backend("ref").edge_fitness_quantized(S_q, Q, G))
    finally:
        _REGISTRY.pop("mysuite", None)
    # a dispatch tag the dispatch layer cannot honour fails loudly
    with pytest.raises(ValueError, match="dispatch tag"):
        KernelBackend("broken", ops_backend="no-such-tag")
