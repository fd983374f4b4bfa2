"""The port's hand-written CUDA permutation (csrc/poseidon2.cu: the
thread-per-state kernel and, below `SMALL_BATCH` states, the lane-parallel one)
against its plain torch version and the native C++ permutation.  Tolerance:
exact.  The chain kernel's tests are in tests/test_torch_chain_kernel.py.

This file imports no jax, so it also runs on a GPU host without the JAX
package:  python -m pytest --noconftest tests/test_torch_kernels.py -m gpu
Tests marked `gpu` skip where there is no CUDA card.
"""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu_torch.ops import gf, poseidon2
from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import KERNEL, permutation_cuda
from zkevm_circuits_tpu_torch.runtime import native
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


P = gf.MODULUS


def _states(seed, n):
    st = np.random.default_rng(seed).integers(0, P, size=(n, 12), dtype=np.uint64)
    edge = np.array([0, P - 1, (1 << 32) - 1, 1 << 32], dtype=np.uint64)
    st[: len(edge)] = edge[:, None]
    return st


def test_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        permutation_cuda(gf.from_u64(_states(5, 8)))


def _launches():
    return sum(KERNEL.counts().values())


def test_dispatch_sends_cpu_tensors_to_plain_version():
    st = gf.from_u64(_states(7, 8))
    before = _launches()
    np.testing.assert_array_equal(gf.to_u64(poseidon2.permutation(st)),
                                  gf.to_u64(poseidon2.permutation_plain(st)))
    assert _launches() == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a GPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 127, 4096, 1 << 14])
def test_kernel_matches_plain_and_native(cuda_device, n):
    st_np = _states(6, n) if n >= 4 else _states(6, 4)[:n]
    st = gf.from_u64(st_np, cuda_device)
    before = _launches()
    got = permutation_cuda(st)
    torch.cuda.synchronize()
    assert _launches() == before + 1
    np.testing.assert_array_equal(gf.to_u64(got), gf.to_u64(poseidon2.permutation_plain(st)))
    np.testing.assert_array_equal(gf.to_u64(got)[:256], native.poseidon2_permute_batch(st_np[:256]))


@pytest.mark.gpu
def test_dispatch_sends_cuda_tensors_to_kernel(cuda_device):
    st = gf.from_u64(_states(8, 16).reshape(2, 8, 12), cuda_device)
    before = _launches()
    out = poseidon2.permutation(st)
    assert _launches() == before + 1 and out.shape == st.shape


@pytest.mark.gpu
def test_wrapper_refuses_bad_tensors(cuda_device):
    st = gf.from_u64(_states(9, 8), cuda_device)
    with pytest.raises(TypeError):
        permutation_cuda(st.to(torch.int32))
    with pytest.raises(ValueError, match="shape"):
        permutation_cuda(st[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        permutation_cuda(st.T.contiguous().T)


@pytest.mark.gpu
@pytest.mark.parametrize("batch,length", [((), 559), ((5,), 128), ((3, 100), 7493), ((1,), 121),
                                          ((4,), 9), ((7,), 8)])
def test_long_sponge_runs_as_one_chain_launch(cuda_device, batch, length):
    """hash_padded over a small batch with CHAIN_SPONGE_ROUNDS absorbs or more
    is one fused chain launch on the card, equal to the CPU's absorb loop."""
    rng = np.random.default_rng(length)
    vals = rng.integers(0, gf.MODULUS, size=tuple(batch) + (length,), dtype=np.uint64)
    want = gf.to_u64(poseidon2.hash_padded(gf.from_u64(vals, "cpu")))
    before = KERNEL.counts()
    got = gf.to_u64(poseidon2.hash_padded(gf.from_u64(vals, cuda_device)))
    after = KERNEL.counts()
    np.testing.assert_array_equal(got, want)
    chained = -(-length // poseidon2.RATE) >= poseidon2.CHAIN_SPONGE_ROUNDS
    assert after["chain_segmented"] - before["chain_segmented"] == int(chained)
