"""Card-only: every hand-written CUDA kernel of the port against its plain
PyTorch version on the same inputs (integers bit for bit, floats within
rtol 1e-5 / atol 1e-4). Skips without a card; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import _build, cases
from repro_torch.kernels.prune_fixpoint import (prune_fixpoint_cuda,
                                                prune_fixpoint_reference)

pytestmark = pytest.mark.cuda

# (P, N, n, m, K): the JAX backend sweep's shapes and the main path's
SHAPES = [(1, 8, 8, 16, 3), (2, 16, 40, 72, 3), (8, 64, 56, 144, 12)]
MODES = [(False, 0.0), (True, 0.0), (False, 0.3), (True, 0.3)]


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("quantized,tau", MODES)
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_card(device, shape, quantized, tau):
    P, N, n, m, K = shape
    Q, G, mask = (t.to(device) for t in cases.random_problem(P, n, m, 1))
    x = cases.swarm_inputs(Q, G, mask, N, K, seed=2)
    pairs = cases.kernel_pairs(Q, G, mask, x, quantized=quantized,
                               gumbel_tau=tau, elite_k=max(1, N // 4))
    for name, (kernel, plain) in pairs.items():
        got = kernel()
        torch.cuda.synchronize()
        try:
            cases.compare(got, plain())
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from e


@pytest.mark.parametrize("max_iters", [0, 1])
@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.int32])
def test_prune_kernel_mask_dtypes_on_card(device, mask_dtype, max_iters):
    Q, G, mask = (t.to(device) for t in
                  cases.random_problem(3, 40, 72, 5, mask_dtype))
    got = prune_fixpoint_cuda(mask, Q, G, max_iters)
    cases.compare(got, prune_fixpoint_reference(mask, Q, G, max_iters))
    assert got[0].dtype == mask_dtype
