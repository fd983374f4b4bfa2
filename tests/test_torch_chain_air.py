"""The port's Poseidon2 sponge-chain AIR (prover/poseidon2_air.py) against the
JAX package's, piece by piece: the chain trace, the phase-2 RLC column, the
message RLC and the chain-AIR composition at random rows, for the full-state
(FULL) and the narrow (NARROW) chain.

Inputs come from a numpy seed; the port runs on the CPU.  Tolerance: exact
equality of the u64 field elements.  The JAX side is computed once per
module (its trace builder and its composition each compile for seconds).
"""

import numpy as np
import pytest
import torch

from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.prover import poseidon2_air as jpa
from zkevm_circuits_tpu.prover import stark as jstark
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.prover import poseidon2_air as pa
from zkevm_circuits_tpu_torch.prover import stark
from zkevm_circuits_tpu_torch.runtime import native
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

SPECS = {"full": (pa.FULL, jpa.FULL, 8, 5), "narrow": (pa.NARROW, jpa.NARROW, 20, 2)}
GAMMAS = {"random": 0x9E3779B97F4A7C15 % gf.MODULUS, "zero": 0, "one": 1}
COMPOSE_ROWS = 4


def _u64(x):
    return np.asarray(x.astype_u64(), np.uint64)


def _rand(rng, *shape):
    return rng.integers(0, gf.MODULUS, size=shape, dtype=np.uint64)


@pytest.fixture(scope="module")
def cases():
    """per spec: chunks, init, and the JAX trace, publics and phase-2 columns;
    random composition inputs and the JAX composition of them."""
    rng = np.random.default_rng(2026)
    out = {}
    for name, (spec, jspec, width, pushes) in SPECS.items():
        enc = _rand(rng, pushes, width)
        chunks = jpa.encodings_to_chunks(enc) if spec.blocks_per_push > 1 else enc
        init = _rand(rng, 4)
        jtrace, jhead, jphase2, jn = jpa.build_chain_trace(chunks, init, jspec)
        jair = jpa.chain_air(jspec)
        m = jair.total_cols
        comp_in = dict(cur=_rand(rng, COMPOSE_ROWS, m), nxt=_rand(rng, COMPOSE_ROWS, m),
                       public=_rand(rng, spec.num_public), ch=_rand(rng, 1),
                       alpha=int(_rand(rng)),
                       invs=[_rand(rng, COMPOSE_ROWS) for _ in range(4)])
        jcomp = jstark._compose_rows(
            jgf.from_u64(comp_in["cur"]), jgf.from_u64(comp_in["nxt"]),
            jgf.from_u64(comp_in["public"]), jgf.from_u64(comp_in["ch"]),
            jgf.from_u64(np.uint64(comp_in["alpha"])),
            *[jgf.from_u64(v) for v in comp_in["invs"]], air=jair)
        out[name] = dict(
            enc=enc, chunks=chunks, init=init, n=jn, trace=_u64(jtrace), head=jhead,
            phase2={g: _u64(jphase2(None, (v,))) for g, v in GAMMAS.items()},
            rlc={g: jpa.message_rlc(chunks, v) for g, v in GAMMAS.items()},
            comp_in=comp_in, comp=_u64(jcomp), num_cols=jair.num_cols,
        )
    return out


@pytest.mark.parametrize("name", list(SPECS))
def test_column_layout_matches_jax(cases, name):
    spec, jspec = SPECS[name][:2]
    air, jair = pa.chain_air(spec), jpa.chain_air(jspec)
    assert (air.num_cols, air.total_cols, air.num_public, air.max_degree) == \
        (jair.num_cols, jair.total_cols, jair.num_public, jair.max_degree)
    assert spec.cols.acc == jspec.cols.acc
    assert air.num_cols == (262 if name == "full" else 264)


@pytest.mark.parametrize("name", list(SPECS))
def test_chain_trace_matches_jax(cases, name):
    """pad rows included: 8 rows for 5 (full) and 6 (narrow) chunks"""
    c = cases[name]
    trace, head, _, n = pa.build_chain_trace(c["chunks"], c["init"], SPECS[name][0],
                                             device="cpu")
    assert n == c["n"] == 8 and c["chunks"].shape[0] < n
    np.testing.assert_array_equal(gf.to_u64(trace), c["trace"])
    np.testing.assert_array_equal(head, c["head"])


def test_full_chain_trace_from_witness_states(cases):
    """a full-state chain's trace built from the caller's states equals the
    one built from the native host chain"""
    c = cases["full"]
    init12 = np.concatenate([np.zeros(8, np.uint64), c["init"]])
    states = gf.from_u64(native.full_state_chain(c["chunks"], None, init12))
    trace, _, _, _ = pa.build_chain_trace(c["chunks"], c["init"], pa.FULL, device="cpu",
                                          states=states)
    np.testing.assert_array_equal(gf.to_u64(trace), c["trace"])


@pytest.mark.parametrize("gamma", list(GAMMAS))
@pytest.mark.parametrize("name", list(SPECS))
def test_phase2_column_matches_jax(cases, name, gamma):
    c = cases[name]
    trace, _, build_phase2, _ = pa.build_chain_trace(c["chunks"], c["init"], SPECS[name][0],
                                                     device="cpu")
    col = build_phase2(trace, (GAMMAS[gamma],))
    assert tuple(col.shape) == (1, c["n"])
    np.testing.assert_array_equal(gf.to_u64(col), c["phase2"][gamma])


@pytest.mark.parametrize("gamma", list(GAMMAS))
@pytest.mark.parametrize("name", list(SPECS))
def test_message_rlc_matches_jax(cases, name, gamma):
    c = cases[name]
    assert pa.message_rlc(c["chunks"], GAMMAS[gamma], "cpu") == c["rlc"][gamma]


@pytest.mark.parametrize("name", list(SPECS))
def test_composition_matches_jax(cases, name):
    """the chain AIR's whole composition (transitions, the folded round
    constraints, boundaries) at random rows"""
    c = cases[name]
    ci = c["comp_in"]
    comp = stark._compose_rows(
        gf.from_u64(ci["cur"]), gf.from_u64(ci["nxt"]), gf.from_u64(ci["public"]),
        gf.from_u64(ci["ch"]), ci["alpha"], *[gf.from_u64(v) for v in ci["invs"]],
        pa.chain_air(SPECS[name][0]))
    np.testing.assert_array_equal(gf.to_u64(gf.canonicalize(comp)), c["comp"])


@pytest.mark.parametrize("name", list(SPECS))
def test_trace_rows_satisfy_the_air(cases, name):
    """on the honest trace every row and transition constraint is zero"""
    c = cases[name]
    spec = SPECS[name][0]
    air = pa.chain_air(spec)
    trace, _, build_phase2, _ = pa.build_chain_trace(c["chunks"], c["init"], spec,
                                                     device="cpu")
    gamma = GAMMAS["random"]
    rows = torch.cat([trace, build_phase2(trace, (gamma,))]).T
    ch = gf.from_u64([gamma])
    acc, _ = air.compose_row(rows, ch, 12345, 1)
    assert not gf.to_u64(acc).any()
    for v in air.constraints(rows[:-1], rows[1:], ch):
        assert not gf.to_u64(gf.canonicalize(v)).any()
