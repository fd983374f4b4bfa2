"""Queue chains and the ClosedFormInput protocol: the torch port against the
JAX package on the same seeded inputs (the cases of
tests/test_queues_protocol.py).  Field elements are compared as u64 and flags
as bool arrays, exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.ops import gf as jgf, queues as jqueues
from zkevm_circuits_tpu.utils import protocol as jprotocol

from zkevm_circuits_tpu_torch.ops import gf, queues
from zkevm_circuits_tpu_torch.runtime import native
from zkevm_circuits_tpu_torch.utils import protocol
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

P = gf.MODULUS


def rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def t(x):
    return gf.from_u64(x, "cpu")


@pytest.mark.parametrize("width,enc_len,execute", [
    (12, 8, [1, 1, 0, 1, 0, 1]),
    (4, 20, None),
    (4, 5, [1, 0, 1, 1]),
])
def test_simulate_chain_matches_jax_and_native(width, enc_len, execute):
    n = 6 if execute is None else len(execute)
    encs, init = rand(1, (n, enc_len)), rand(2, (width,))
    ex_np = None if execute is None else np.array(execute, dtype=bool)
    want = np.asarray(jqueues.simulate_chain(
        jgf.from_u64(init), jgf.from_u64(encs),
        None if ex_np is None else jnp.asarray(ex_np)).astype_u64())
    got = gf.to_u64(queues.simulate_chain(
        t(init), t(encs), None if ex_np is None else torch.from_numpy(ex_np)))
    assert got.shape == (n + 1, width)
    assert np.array_equal(got, want)
    chain = native.full_state_chain if width == 12 else native.narrow_chain
    assert np.array_equal(chain(encs, ex_np, init), want)
    if width == 4:
        both = native.narrow_chains(np.stack([encs, encs]),
                                    None if ex_np is None else np.stack([ex_np, ex_np]),
                                    np.stack([init, init]))
        assert np.array_equal(both[0], want) and np.array_equal(both[1], want)


@pytest.mark.parametrize("width,enc_len", [(12, 8), (4, 20)])
def test_check_chain_matches_jax(width, enc_len):
    n = 5
    encs, init = rand(3, (n, enc_len)), rand(4, (width,))
    states = gf.to_u64(queues.simulate_chain(t(init), t(encs)))
    assert queues.check_chain(t(states), t(encs)).all()
    bad = states.copy()
    bad[2, 3] ^= 1  # one intermediate state: the row that lands on it fails
    want = np.asarray(jqueues.check_chain(jgf.from_u64(bad), jgf.from_u64(encs)))
    got = queues.check_chain(t(bad), t(encs)).numpy()
    assert np.array_equal(got, want)
    assert got[0] and not got[1]


def test_check_chain_segmented_matches_jax():
    n, stride = 24, 4
    encs, init = rand(5, (n, 8)), rand(6, (12,))
    execute = np.arange(n) < 19
    states = native.full_state_chain(encs, execute, init)
    boundaries = states[::stride].copy()
    strided = native.full_state_chains_strided(
        encs[None], execute[None].astype(np.uint8), init[None], stride)[0]
    assert np.array_equal(strided, boundaries)
    ok = queues.check_chain_segmented(t(boundaries), t(encs), torch.from_numpy(execute))
    assert ok.shape == (n // stride,) and ok.all()
    boundaries[2, 10] ^= 1  # a capacity lane of one boundary: two segments fail
    want = np.asarray(jqueues.check_chain_segmented(
        jgf.from_u64(boundaries), jgf.from_u64(encs), jnp.asarray(execute)))
    got = queues.check_chain_segmented(
        t(boundaries), t(encs), torch.from_numpy(execute)).numpy()
    assert np.array_equal(got, want)
    assert np.flatnonzero(~got).tolist() == [1, 2]


def test_queue_state_helpers():
    e = queues.empty_queue_state(12, (3,), "cpu")
    assert e.width == 12 and queues.is_queue_empty(e).all()
    other = queues.QueueState(e.head, t(rand(7, (3, 12))), e.length)
    assert queues.queue_states_equal(e, e).all()
    assert not queues.queue_states_equal(e, other).any()
    enc = protocol.encode_queue_state_generic(other.head, other.tail, 9)
    want = np.asarray(jprotocol.encode_queue_state_generic(
        jgf.zeros((3, 12)), jgf.from_u64(gf.to_u64(other.tail)),
        jnp.full((3,), 9, jnp.uint32)).astype_u64())
    assert np.array_equal(gf.to_u64(enc), want)


def _compact_np(cf, to_u64):
    return [
        np.asarray(cf.start_flag), np.asarray(cf.completion_flag),
        to_u64(cf.observable_input_commitment), to_u64(cf.observable_output_commitment),
        to_u64(cf.hidden_fsm_input_commitment), to_u64(cf.hidden_fsm_output_commitment),
        to_u64(cf.encode()), to_u64(cf.commitment()),
    ]


def test_compact_form_masking_matches_jax():
    start = np.array([True, False, False])
    complete = np.array([False, False, True])
    parts = [rand(10 + i, (3, length)) for i, length in enumerate((5, 7, 11, 11))]
    jcf = jprotocol.compact_form_from_parts(
        jnp.asarray(start), jnp.asarray(complete), *[jgf.from_u64(p) for p in parts])
    cf = protocol.compact_form_from_parts(
        torch.from_numpy(start), torch.from_numpy(complete), *[t(p) for p in parts])
    want = _compact_np(jcf, lambda x: np.asarray(x.astype_u64()))
    got = _compact_np(cf, gf.to_u64)
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    z = np.zeros(4, dtype=np.uint64)
    fsm_in, fsm_out, obs_out = got[4], got[5], got[3]
    assert np.array_equal(fsm_in[0], z) and (fsm_in[1] != 0).any()
    assert np.array_equal(obs_out[0], z) and np.array_equal(obs_out[1], z)
    assert (obs_out[2] != 0).any()
    assert np.array_equal(fsm_out[2], z) and (fsm_out[0] != 0).any()
    assert got[7].shape == (3, 4)
    assert np.array_equal(gf.to_u64(protocol.input_output_commitment(cf)), got[7])


def test_single_instance_compact_form_matches_jax():
    obs_in, obs_out = rand(20, (2, 9)), rand(21, (2, 3))
    jcf = jprotocol.single_instance_compact_form(jgf.from_u64(obs_in), jgf.from_u64(obs_out))
    cf = protocol.single_instance_compact_form(t(obs_in), t(obs_out))
    assert np.array_equal(gf.to_u64(cf.commitment()), np.asarray(jcf.commitment().astype_u64()))
    z = np.zeros((2, 4), dtype=np.uint64)
    assert np.array_equal(gf.to_u64(cf.hidden_fsm_input_commitment), z)
    assert np.array_equal(gf.to_u64(cf.hidden_fsm_output_commitment), z)


@pytest.mark.parametrize("break_handoff", [False, True])
def test_instance_chaining_matches_jax(break_handoff):
    fsm_out = rand(30, (4, 4))
    fsm_in = np.roll(fsm_out, 1, axis=0)  # fsm_in[k + 1] = fsm_out[k]
    if break_handoff:
        fsm_in[2, 0] ^= 1
    start = np.array([True, False, False, False])
    complete = np.array([False, False, False, True])
    want = jprotocol.check_instance_chaining(
        jnp.asarray(start), jnp.asarray(complete), jgf.from_u64(fsm_in), jgf.from_u64(fsm_out))
    got = protocol.check_instance_chaining(
        torch.from_numpy(start), torch.from_numpy(complete), t(fsm_in), t(fsm_out))
    assert list(got) == list(want)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert bool(got["fsm_handoff"].all()) == (not break_handoff)
    assert got["first_starts"] and got["chained"].all()
