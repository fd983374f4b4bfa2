"""The segmented sponge-chain recompute of the torch port, and the wrappers of
its two lane-parallel CUDA kernels (csrc/poseidon2_coop.cuh).

Without a card: `check_chain_segmented` on CPU tensors against the JAX
package on the same seeded inputs (exact equality of the (S,) bools), the
plain landing-state helper against `simulate_chain` and the native strided
chains (exact u64 equality), the routing of chains to the fused kernel, and
what the wrappers refuse.  Tests marked `gpu` hold the kernels against their
plain versions bit for bit and skip where there is no CUDA card; on a GPU host
without the JAX package:
    python -m pytest --noconftest tests/test_torch_chain_kernel.py tests/test_torch_kernels.py -m gpu -q
"""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu_torch.ops import gf, poseidon2, poseidon2_cuda, queues
from zkevm_circuits_tpu_torch.ops.poseidon2_cuda import (
    KERNEL,
    SMALL_BATCH,
    chain_segmented_cuda,
    permutation_cuda,
)
from zkevm_circuits_tpu_torch.runtime import native
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

P = gf.MODULUS
SEGMENTS, STRIDE = 8, 16
N = SEGMENTS * STRIDE


def t(x):
    return gf.from_u64(x, "cpu")


def honest_chain(seed, executed=0.8):
    """encodings, execute mask, all n + 1 states and the boundary states."""
    rng = np.random.default_rng(seed)
    encs = rng.integers(0, P, size=(N, 8), dtype=np.uint64)
    init = rng.integers(0, P, size=(12,), dtype=np.uint64)
    execute = rng.random(N) < executed
    states = native.full_state_chain(encs, execute, init)
    return encs, execute, states, states[::STRIDE].copy()


def random_chain(seed, segments, stride, device, executed=1.0):
    rng = np.random.default_rng(seed)
    boundaries = gf.from_u64(rng.integers(0, P, size=(segments + 1, 12), dtype=np.uint64), device)
    encodings = gf.from_u64(rng.integers(0, P, size=(segments * stride, 8), dtype=np.uint64),
                            device)
    execute = torch.from_numpy(rng.random(segments * stride) < executed).to(device)
    return boundaries, encodings, execute


# ---------------------------------------------------------------------------
# on the CPU: against the JAX package, the step-by-step chain and the runtime
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_check():
    """the JAX package's check_chain_segmented on numpy inputs."""
    import jax.numpy as jnp

    from zkevm_circuits_tpu.ops import gf as jgf, queues as jqueues

    def check(boundaries, encs, execute):
        return np.asarray(jqueues.check_chain_segmented(
            jgf.from_u64(boundaries), jgf.from_u64(encs), jnp.asarray(execute)))

    return check


# case -> (what is changed, the segments that must fail)
TAMPERS = {
    "honest": (None, []),
    "inner_encoding": (("enc", 3 * STRIDE + 5, 2), [3]),
    "capacity_lane_of_a_boundary": (("boundary", 5, 10), [4, 5]),
    # the next segment's first absorb replaces lanes 0..7, so only the segment
    # that lands on the boundary sees a changed rate lane
    "rate_lane_of_a_boundary": (("boundary", 5, 2), [4]),
}


@pytest.mark.parametrize("case", list(TAMPERS))
def test_check_chain_segmented_matches_jax(jax_check, case):
    encs, execute, _, boundaries = honest_chain(11)
    assert execute.any() and not execute.all()  # the mask is mixed
    change, failing = TAMPERS[case]
    if change:
        which, row, lane = change
        # an executed row, so that the change is absorbed
        if which == "enc":
            row = int(np.flatnonzero(execute[row:])[0]) + row
            assert row // STRIDE == failing[0]
            encs[row, lane] ^= 1
        else:
            boundaries[row, lane] ^= 1
    want = jax_check(boundaries, encs, execute)
    before = KERNEL.counts()
    got = queues.check_chain_segmented(t(boundaries), t(encs), torch.from_numpy(execute))
    assert got.shape == (SEGMENTS,) and got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)
    assert np.flatnonzero(~got.numpy()).tolist() == failing
    landing = queues.segment_landing_states_plain(t(boundaries), t(encs), torch.from_numpy(execute))
    assert np.array_equal(got.numpy(), (gf.to_u64(landing) == boundaries[1:]).all(-1))
    assert KERNEL.counts() == before  # CPU tensors launch nothing


@pytest.mark.parametrize("executed", [1.0, 0.7])
def test_plain_landing_states_match_chain_and_native(executed):
    encs, execute, states, boundaries = honest_chain(12, executed)
    ex = torch.from_numpy(execute)
    landing = gf.to_u64(queues.segment_landing_states_plain(t(boundaries), t(encs), ex))
    assert landing.shape == (SEGMENTS, 12)
    # the step-by-step chain over the first three segments, sampled every STRIDE rows
    rows = 3 * STRIDE
    chain = gf.to_u64(queues.simulate_chain(t(states[0]), t(encs[:rows]), ex[:rows]))
    assert np.array_equal(chain, states[: rows + 1])
    assert np.array_equal(landing[:3], chain[STRIDE::STRIDE])
    strided = native.full_state_chains_strided(
        encs[None], execute[None].astype(np.uint8), states[:1], STRIDE)[0]
    assert np.array_equal(strided, boundaries)
    assert np.array_equal(landing, strided[1:])
    assert queues.check_chain_segmented(t(boundaries), t(encs), ex).all()


def test_no_execute_mask_means_every_row():
    encs, _, _, _ = honest_chain(13)
    init = np.zeros(12, dtype=np.uint64)
    boundaries = native.full_state_chain(encs, None, init)[::STRIDE]
    assert queues.check_chain_segmented(t(boundaries), t(encs)).all()
    landing = queues.segment_landing_states_plain(t(boundaries), t(encs))
    assert np.array_equal(gf.to_u64(landing), boundaries[1:])


def test_segments_must_divide_rows():
    b, e, x = random_chain(1, 3, 4, "cpu")
    for check in (queues.check_chain_segmented, queues.segment_landing_states_plain):
        with pytest.raises(ValueError, match="do not divide"):
            check(b, e[:-1], x[:-1])
        with pytest.raises(ValueError, match="do not divide"):
            check(b[:1], e, x)


def test_full_state_chains_share_a_launch_and_narrow_ones_step(monkeypatch):
    """The routing around the fused kernel, with the kernel's wrapper replaced
    by the step loop: two full-state chains go to it together, one alone, a
    narrow chain never."""
    launches = []

    def stand_in(chains):
        launches.append(len(chains))
        assert all(c[2].dtype == torch.bool for c in chains)
        return [queues.segment_landing_states_plain(*c) for c in chains]

    def plain(chain):
        return gf.equal(queues.segment_landing_states_plain(*chain), chain[0][1:]).all(-1)

    monkeypatch.setattr(poseidon2_cuda, "chain_segmented_cuda", stand_in)
    monkeypatch.setattr(queues, "_fused", lambda b, e: b.shape[-1] == 12 and e.shape[-1] == 8)
    a, b = (random_chain(s, 4, 3, "cpu") for s in (2, 3))
    a = (a[0], a[1], None)
    rng = np.random.default_rng(6)
    narrow = (t(rng.integers(0, P, size=(3, 4), dtype=np.uint64)),
              t(rng.integers(0, P, size=(4, 20), dtype=np.uint64)), None)
    for chains, launched in (([a, b], [2]), ([b], [1]), ([narrow], []), ([a, narrow], [])):
        launches.clear()
        got = queues.check_chains_segmented(chains)
        assert launches == launched
        for chain, ok in zip(chains, got):
            assert torch.equal(ok, plain(chain))


def test_only_full_state_chains_on_the_card_are_fused():
    b, e, _ = random_chain(7, 2, 2, "cpu")
    assert not queues._fused(b, e)  # on the CPU
    meta = lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta")
    assert not queues._fused(meta(b), meta(e))


# ---------------------------------------------------------------------------
# what the wrappers refuse (reachable without a card: the device comes last)
# ---------------------------------------------------------------------------


def test_permutation_wrapper_refuses():
    st = torch.zeros((4, 12), dtype=torch.int64)
    before = KERNEL.counts()
    for route in (None, "thread", "small"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            permutation_cuda(st, route=route)
    with pytest.raises(TypeError, match="int64"):
        permutation_cuda(st.to(torch.int32))
    with pytest.raises(ValueError, match="shape"):
        permutation_cuda(st[:, :8].contiguous())
    with pytest.raises(ValueError, match="shape"):
        permutation_cuda(torch.zeros((), dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        permutation_cuda(st.T.contiguous().T)
    assert KERNEL.counts() == before


def test_chain_wrapper_refuses():
    b, e, x = random_chain(8, 4, 3, "cpu")
    before = KERNEL.counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        chain_segmented_cuda([(b, e, x)])
    with pytest.raises(ValueError, match="one or two chains"):
        chain_segmented_cuda([])
    with pytest.raises(ValueError, match="one or two chains"):
        chain_segmented_cuda([(b, e, x)] * 3)
    with pytest.raises(TypeError, match="int64 boundaries"):
        chain_segmented_cuda([(b.to(torch.int32), e, x)])
    with pytest.raises(TypeError, match="int64 encodings"):
        chain_segmented_cuda([(b, e.to(torch.float64), x)])
    with pytest.raises(TypeError, match="bool execute"):
        chain_segmented_cuda([(b, e, x.to(torch.uint8))])
    with pytest.raises(ValueError, match=r"\(S \+ 1, 12\)"):
        chain_segmented_cuda([(b[:, :4].contiguous(), e, x)])
    with pytest.raises(ValueError, match=r"\(S \+ 1, 12\)"):
        chain_segmented_cuda([(b[:1], e, x)])
    with pytest.raises(ValueError, match=r"\(n, 8\)"):
        chain_segmented_cuda([(b, e[:, :4].contiguous(), x)])
    with pytest.raises(ValueError, match="execute of shape"):
        chain_segmented_cuda([(b, e, x[:-1])])
    with pytest.raises(ValueError, match="do not divide"):
        chain_segmented_cuda([(b, e[:-1], x[:-1])])
    with pytest.raises(ValueError, match="one shape"):
        chain_segmented_cuda([(b, e, x), random_chain(9, 2, 3, "cpu")])
    with pytest.raises(ValueError, match="contiguous"):
        chain_segmented_cuda([(b, e.T.contiguous().T, x)])
    with pytest.raises(ValueError, match="contiguous"):
        chain_segmented_cuda([(b, e, torch.ones(2 * len(x), dtype=torch.bool)[::2])])
    assert KERNEL.counts() == before


def test_counters_reset():
    KERNEL.reset_counts()
    assert KERNEL.counts() == dict(permutation=0, permutation_small=0, chain_segmented=0)
    st = t(np.arange(24, dtype=np.uint64).reshape(2, 12))
    poseidon2.permutation(st)
    assert sum(KERNEL.counts().values()) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need a GPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 5, 2048, SMALL_BATCH - 1])
def test_small_kernel_matches_plain_and_thread_kernel(cuda_device, n):
    raw = np.random.default_rng(n).integers(0, 1 << 64, size=(n, 12), dtype=np.uint64)
    raw[0] = [0, 1, P - 1, P, (1 << 64) - 1, (1 << 32) - 1, 1 << 32, 2, 3, P - 2, P + 1, 7]
    st = torch.from_numpy(raw.view(np.int64)).to(cuda_device)
    before = KERNEL.counts()
    got = permutation_cuda(st, route="small")
    thread = permutation_cuda(st, route="thread")
    torch.cuda.synchronize()
    after = KERNEL.counts()
    assert after["permutation_small"] == before["permutation_small"] + 1
    assert after["permutation"] == before["permutation"] + 1
    assert torch.equal(got, thread)
    assert torch.equal(got, poseidon2.permutation_plain(st))


@pytest.mark.gpu
def test_dispatch_is_by_batch_size_only(cuda_device):
    before = KERNEL.counts()
    for n, counter in ((1, "permutation_small"), (SMALL_BATCH - 1, "permutation_small"),
                       (SMALL_BATCH, "permutation")):
        st = torch.zeros((n, 12), dtype=torch.int64, device=cuda_device)
        poseidon2.permutation(st)
        after = KERNEL.counts()
        assert after[counter] == before[counter] + 1
        assert sum(after.values()) == sum(before.values()) + 1
        before = after


@pytest.mark.gpu
@pytest.mark.parametrize("segments,stride", [(64, 16), (13, 5), (1, 1)])
def test_chain_kernel_matches_plain_loop(cuda_device, segments, stride):
    a = random_chain(20, segments, stride, cuda_device, executed=0.8)
    b = random_chain(21, segments, stride, cuda_device)
    cpu = lambda chain: tuple(x.cpu() for x in chain)
    want = [queues.segment_landing_states_plain(*cpu(c)) for c in (a, b)]
    before = KERNEL.counts()
    pair = chain_segmented_cuda([a, b])
    (single,) = chain_segmented_cuda([b])
    torch.cuda.synchronize()
    assert KERNEL.counts()["chain_segmented"] == before["chain_segmented"] + 2
    assert torch.equal(pair[0].cpu(), want[0]) and torch.equal(pair[1].cpu(), want[1])
    assert torch.equal(single.cpu(), want[1])


@pytest.mark.gpu
def test_check_chain_segmented_on_the_card_is_one_launch(cuda_device):
    encs, execute, _, boundaries = honest_chain(22)
    boundaries[5, 2] ^= 1  # a rate lane: one segment fails
    args = [gf.from_u64(boundaries, cuda_device), gf.from_u64(encs, cuda_device),
            torch.from_numpy(execute).to(cuda_device)]
    before = KERNEL.counts()
    got = queues.check_chain_segmented(*args)
    after = KERNEL.counts()
    assert after["chain_segmented"] == before["chain_segmented"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    assert np.flatnonzero(~got.cpu().numpy()).tolist() == [4]
    landing = queues.segment_landing_states_plain(*(x.cpu() for x in args))
    assert torch.equal(got.cpu(), gf.equal(landing, args[0][1:].cpu()).all(-1))
