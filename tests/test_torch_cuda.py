"""Tests that need an NVIDIA card: the hand-written CUDA kernels against
their plain PyTorch versions, on the card.

This file imports neither jax nor ``repro``, so it also runs where only
PyTorch is installed.  Without a card every test skips.  On a machine
with one, from the root of the repository:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import tolfl_combine as tc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,p,zeros", [(5, 49_680, []), (1, 49_680, []),
                                       (10, 49_680, []), (5, 1_000_003, []),
                                       (5, 49_680, [0, 1, 2, 3, 4]),
                                       (5, 49_680, [3, 4])])
def test_tolfl_combine_cuda_kernel_bitwise(cuda_device, k, p, zeros):
    """On the card the hand-written kernel equals its plain version bit
    for bit (rounded intrinsics, IEEE division, no FMA contraction)."""
    g = torch.Generator(device=cuda_device).manual_seed(k + p)
    gs = torch.randn((k, p), generator=g, device=cuda_device)
    ns = torch.rand((k,), generator=g, device=cuda_device) * 50
    ns[zeros] = 0.0
    before = tc.LAUNCHES
    got = ops.tolfl_combine(gs, ns)
    torch.cuda.synchronize()
    assert tc.LAUNCHES == before + 1
    assert torch.equal(got, tc.tolfl_combine_plain(gs, ns))
