"""Shared pieces of the torch port's memory-thread and storage-tree circuit
tests: a port witness as a JAX witness (so that the JAX package's
evaluation judges a witness the port made, a negative probe's included),
and seeded call tapes for the three precompile circuits.
"""

import dataclasses

import numpy as np

from torch_log_helpers import assert_same, jax_to_numpy
from zkevm_circuits_tpu_torch.utils.convert import witness_to_numpy

COUNTS = ("n", "num_calls", "num_requests", "num_queries")
FORMS = ("observable_input_commitment", "observable_output_commitment",
         "hidden_fsm_input_commitment", "hidden_fsm_output_commitment")


def to_jax(cls, fields: dict, field_names, query_types: dict):
    """A JAX witness of class `cls` from numpy fields (`witness_to_numpy` of
    a port witness): the counts as u32 scalars, `query_types` (field name ->
    JAX query class) batches from their column dicts, the `field_names` as
    GF from u64, dicts of arrays as dicts, the rest u32 or bool arrays."""
    import jax.numpy as jnp

    from zkevm_circuits_tpu.ops import gf as jgf

    def arr(v, field):
        v = np.asarray(v)
        if field:
            return jgf.from_u64(v.astype(np.uint64))
        return jnp.asarray(v if v.dtype == np.bool_ else v.astype(np.uint32))

    out = {}
    for f in dataclasses.fields(cls):
        v, is_field = fields[f.name], f.name in field_names
        if f.name in COUNTS:
            out[f.name] = jnp.uint32(v)
        elif f.name in query_types:
            q = query_types[f.name]
            out[f.name] = q(*[arr(v[c.name], False) for c in dataclasses.fields(q)])
        elif isinstance(v, dict):
            out[f.name] = {k: arr(x, is_field) for k, x in v.items()}
        else:
            out[f.name] = arr(v, is_field)
    return cls(**out)


def assert_same_witness(port_w, jax_w, field_names):
    assert_same(witness_to_numpy(port_w, field_names), jax_to_numpy(jax_w))


def assert_same_forms(port_forms, jax_forms):
    assert_same(witness_to_numpy(port_forms, FORMS), jax_to_numpy(jax_forms))


def key(limbs) -> int:
    return sum(int(x) << (32 * k) for k, x in enumerate(limbs))


def call_row(address: int, key_value: int, timestamp: int) -> dict:
    from zkevm_circuits_tpu_torch.isa import system_params as sp

    return dict(address=address, key=key_value, read_value=0, written_value=0,
                aux_byte=sp.PRECOMPILE_AUX_BYTE, rw_flag=False, rollback=False, is_service=False,
                shard_id=0, tx_number_in_block=0, timestamp=timestamp)


def init_state(seed: int) -> np.ndarray:
    """a (12,) u64 state a memory chain continues from (canonical)."""
    return np.random.default_rng(seed).integers(0, 1 << 63, size=12, dtype=np.uint64)
