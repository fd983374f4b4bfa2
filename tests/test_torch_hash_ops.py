"""The hash ops of the memory thread and the storage tree in the torch port
against the JAX package on the CPU: the batched sha256 compression, blake2s
(batched and host), keccak's `bytes_to_lanes`, and `simulate_chains` from a
given initial state.

Exact equality on seeded inputs, with words whose top bit is set; the host
references against hashlib where it has the function.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.ops import blake2s as jblake2s
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.ops import keccak as jkeccak
from zkevm_circuits_tpu.ops import queues as jqueues
from zkevm_circuits_tpu.ops import sha256 as jsha256

from zkevm_circuits_tpu_torch.ops import blake2s, gf, keccak, queues, sha256
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

CPU = "cpu"
BATCH = 64


def _words(rng, shape):
    w = rng.integers(0, 1 << 32, size=shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[::3] |= np.uint32(1 << 31)  # the top bit set in a third of them
    return w


def test_sha256_compress_equals_jax_and_host():
    rng = np.random.default_rng(1)
    state, block = _words(rng, (BATCH, 8)), _words(rng, (BATCH, 16))
    got = sha256.compress(torch.from_numpy(state.astype(np.int64)),
                          torch.from_numpy(block.astype(np.int64))).numpy()
    want = np.asarray(jsha256.compress(jnp.asarray(state), jnp.asarray(block)))
    assert np.array_equal(got, want.astype(np.int64))
    for i in range(0, BATCH, 7):
        assert got[i].tolist() == sha256.compress_ref(state[i].tolist(), block[i].tolist())
    h0 = sha256.initial_state((3, 2), device=CPU)
    assert h0.shape == (3, 2, 8)
    assert np.array_equal(h0.numpy(), np.asarray(jsha256.initial_state((3, 2))).astype(np.int64))


@pytest.mark.parametrize("length", [0, 1, 55, 56, 64, 119, 200])
def test_sha256_ref_equals_hashlib(length):
    data = np.random.default_rng(length).bytes(length)
    assert sha256.sha256_ref(data) == hashlib.sha256(data).digest() == jsha256.sha256_ref(data)


@pytest.mark.parametrize("t,last", [(64, True), (40, True), (0, True), (128, False)])
def test_blake2s_compress_equals_jax_and_host(t, last):
    rng = np.random.default_rng(t + last)
    h, m = _words(rng, (BATCH, 8)), _words(rng, (BATCH, 16))
    got = blake2s.compress(torch.from_numpy(h.astype(np.int64)),
                           torch.from_numpy(m.astype(np.int64)), t, last).numpy()
    want = np.asarray(jblake2s.compress(jnp.asarray(h), jnp.asarray(m), t, last))
    assert np.array_equal(got, want.astype(np.int64))
    for i in range(0, BATCH, 9):
        assert got[i].tolist() == blake2s.compress_ref(h[i].tolist(), m[i].tolist(), t, last)
        assert got[i].tolist() == jblake2s.compress_ref(h[i].tolist(), m[i].tolist(), t, last)
    iv = blake2s.initial_state((2,), device=CPU)
    assert np.array_equal(iv.numpy(), np.asarray(jblake2s.initial_state((2,))).astype(np.int64))


@pytest.mark.parametrize("length", [0, 40, 64, 65, 130])
def test_blake2s_ref_equals_hashlib(length):
    """the storage tree hashes 0, 40 and 64 bytes with hashlib: the same function"""
    data = np.random.default_rng(length).bytes(length)
    assert blake2s.blake2s_ref(data) == hashlib.blake2s(data).digest() == jblake2s.blake2s_ref(data)


def test_keccak_bytes_to_lanes():
    data = np.random.default_rng(3).bytes(136)
    assert keccak.bytes_to_lanes(data) == jkeccak.bytes_to_lanes(data)
    with pytest.raises(ValueError):
        keccak.bytes_to_lanes(data[:7])


@pytest.mark.parametrize("width", [12, 4])
def test_simulate_chains_from_an_initial_state(width):
    """several chains, each from its own first state (None: empty), on the
    native runtime and by the step loop, equal the JAX package's scan"""
    rng = np.random.default_rng(width)
    length = 8 if width == 12 else 20
    encs = [rng.integers(0, 1 << 63, size=(n, length), dtype=np.uint64) for n in (5, 3)]
    exs = [rng.random(e.shape[0]) < 0.8 for e in encs]
    inits = [rng.integers(0, 1 << 63, size=width, dtype=np.uint64), None]
    chains = [(gf.from_u64(e, CPU), torch.from_numpy(x)) for e, x in zip(encs, exs)]
    host = queues.simulate_chains(width, chains, "host", inits)
    step = queues.simulate_chains(width, chains, "device", [gf.from_u64(inits[0], CPU), None])
    for k, (e, x) in enumerate(zip(encs, exs)):
        start = jgf.zeros((width,)) if inits[k] is None else jgf.from_u64(inits[k])
        want = np.asarray(jqueues.simulate_chain(start, jgf.from_u64(e), jnp.asarray(x)).astype_u64())
        assert np.array_equal(gf.to_u64(host[k]), want)
        assert np.array_equal(gf.to_u64(step[k]), want)
    # the default stays the empty state
    empty = queues.simulate_chains(width, chains, "host")
    assert np.array_equal(gf.to_u64(empty[1]), gf.to_u64(host[1]))
