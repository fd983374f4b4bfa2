"""Helpers of the circuit-AIR parity tests (demux, Horner, keccak, sha256,
blake2s, ecrecover): JAX proofs as nested ints, the small inputs of the
JAX package's own AIR tests, pinned STARK params."""

from __future__ import annotations

import numpy as np


def u64(x) -> np.ndarray:
    """A JAX GF as u64."""
    return np.asarray(x.astype_u64(), np.uint64)


def jax_proof_to_ints(proof):
    """Mirror of convert.proof_to_ints for the JAX StarkProof, whose openings
    hold (2, m) u32 [lo, hi] rows."""

    def row(r):
        r = np.asarray(r, np.uint64)
        return (r[0] | (r[1] << np.uint64(32))).tolist()

    def ints(a):
        return np.asarray(a, np.uint64).tolist()

    return dict(
        caps=[u64(c).tolist() for c in proof.caps],
        q_cap=u64(proof.q_cap).tolist(),
        ood=dict(trace_z=ints(proof.ood["trace_z"]), trace_wz=ints(proof.ood["trace_wz"]),
                 q_z=int(proof.ood["q_z"])),
        fri=jax_fri_to_ints(proof.fri_proof),
        trace_openings=[
            {tag: dict(rows=[row(r) for r in op["rows"]], paths=[ints(p) for p in op["paths"]],
                       q_row=row(op["q_row"]), q_path=ints(op["q_path"]), index=int(op["index"]))
             for tag, op in entry.items()}
            for entry in proof.trace_openings
        ],
    )


def jax_fri_to_ints(f) -> dict:
    """A JAX FriProof as nested ints (`convert.fri_proof_from_ints` takes it)."""

    def ints(a):
        return np.asarray(a, np.uint64).tolist()

    return dict(caps=[u64(c).tolist() for c in f.caps], final_poly=ints(f.final_poly),
                query_indices=[int(i) for i in f.query_indices],
                openings=[[dict(pair=ints(op["pair"]), path=ints(op["path"])) for op in q]
                          for q in f.openings])


def all_zero(res: dict) -> bool:
    return all(not v.any() for v in res.values())


def proof_digest(ints: dict) -> str:
    """sha256 of a proof as nested ints (`proof_to_ints`, `jax_proof_to_ints`)."""
    import hashlib
    import json

    return hashlib.sha256(json.dumps(ints, sort_keys=True).encode()).hexdigest()


def composition_pair(jair, air, seed: int, rows: int = 4):
    """The JAX package's `stark._compose_rows` for `jair` (its jaxpr
    evaluated with numpy: tests/torch_jaxpr_numpy.py) and the port's for
    `air`, on the same random (cur, nxt) row pairs, public vector,
    challenges, alpha and inverse zerofiers: (JAX u64, port u64), (rows,)
    each.  Random rows make every constraint non-zero, so that a constraint
    dropped, added, changed or moved to another alpha power changes the sum."""
    from torch_jaxpr_numpy import numpy_jit
    from zkevm_circuits_tpu.ops import gf as jgf
    from zkevm_circuits_tpu.prover import stark as jstark
    from zkevm_circuits_tpu_torch.ops import gf
    from zkevm_circuits_tpu_torch.prover import stark

    assert air.total_cols == jair.num_fixed_cols + jair.num_cols + jair.num_phase2_cols
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return rng.integers(0, gf.MODULUS, size=shape, dtype=np.uint64)

    cur, nxt = draw(rows, air.total_cols), draw(rows, air.total_cols)
    pub, ch = draw(max(air.num_public, 1)), draw(max(air.num_challenges, 1))
    alpha = draw(1)
    zf = [draw(rows) for _ in range(4)]
    with numpy_jit(("_compose_rows",)):
        want = jstark._compose_rows(*(jgf.from_u64(x) for x in (cur, nxt, pub, ch, alpha[0])),
                                    *(jgf.from_u64(z) for z in zf), air=jair)
    got = stark._compose_rows(*(gf.from_u64(x, "cpu") for x in (cur, nxt, pub, ch)),
                              int(alpha[0]), *(gf.from_u64(z, "cpu") for z in zf), air)
    return u64(want), gf.to_u64(gf.canonicalize(got))
