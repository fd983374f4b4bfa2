"""Shared pieces of the torch port's log- and decommit-circuit tests: JAX
witnesses as numpy and back, value-by-value comparison of witnesses and
residual dicts.
"""

import dataclasses

import numpy as np

# the fields of each witness that hold field elements (for witness_to_numpy)
CHAINS = ("chain_unsorted", "chain_sorted", "challenges", "lhs", "rhs", "result_chain")
FIELDS = dict(
    decommit=CHAINS + ("enc_unsorted", "enc_sorted"),
    demux=("encodings", "input_chain", "out_chains"),
    storage=CHAINS + ("enc_unsorted_ext", "enc_sorted_ext"),
    log_sorter=CHAINS + ("enc_unsorted", "enc_sorted"),
    hasher=("encodings", "input_chain"),
    forms=("observable_input_commitment", "observable_output_commitment",
           "hidden_fsm_input_commitment", "hidden_fsm_output_commitment"),
)


def jax_to_numpy(obj):
    """A JAX witness, compact form, query batch or dict as nested numpy:
    field elements as u64, the rest as numpy arrays, `n` as an int."""
    if hasattr(obj, "astype_u64"):
        return np.asarray(obj.astype_u64(), np.uint64)
    if isinstance(obj, dict):
        return {k: jax_to_numpy(v) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj):
        return {f.name: (int(getattr(obj, f.name)) if f.name == "n"
                         else jax_to_numpy(getattr(obj, f.name)))
                for f in dataclasses.fields(obj)}
    return np.asarray(obj)


def assert_same(got, want, path="witness"):
    """Nested dicts of arrays equal by value (u32 against int64 by value,
    u64 against u64), key order included."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
        return
    if isinstance(want, int):
        assert got == want, path
        return
    a, b = np.asarray(got), np.asarray(want)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if b.dtype == np.bool_ or a.dtype == np.bool_:
        assert a.dtype == b.dtype == np.bool_, (path, a.dtype, b.dtype)
    elif b.dtype == np.uint64 or a.dtype == np.uint64:
        assert a.dtype == b.dtype == np.uint64, (path, a.dtype, b.dtype)
    assert np.array_equal(a.astype(np.int64) if a.dtype != np.uint64 else a,
                          b.astype(np.int64) if b.dtype != np.uint64 else b), path


def assert_same_residuals(got: dict, want: dict):
    """Two residual dicts equal key by key (order too) and element by element."""
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and np.array_equal(a, b), k


def failing(residuals: dict) -> list:
    return [k for k, v in residuals.items() if not np.asarray(v).all()]


def numpy_to_jax(cls, fields: dict, field_names, query_cls):
    """The inverse of `jax_to_numpy` for a JAX witness class: `n` as a u32,
    the `field_names` (and the dicts they name) as GF from u64, column dicts
    as `query_cls` batches, the rest as u32 or bool arrays.  With it the JAX
    package's `eval_constraints` judges a witness the port made."""
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
        if f.name == "n":
            out[f.name] = jnp.uint32(v)
        elif isinstance(v, dict) and set(v) == {q.name for q in dataclasses.fields(query_cls)}:
            out[f.name] = query_cls(*[arr(v[q.name], False) for q in dataclasses.fields(query_cls)])
        elif isinstance(v, dict):
            out[f.name] = {k: arr(x, is_field) for k, x in v.items()}
        else:
            out[f.name] = arr(v, is_field)
    return cls(**out)


def jax_queries(query_cls, cols: dict):
    """a JAX query batch from numpy columns"""
    import jax.numpy as jnp

    return query_cls(*[
        jnp.asarray(np.asarray(cols[q.name]) if np.asarray(cols[q.name]).dtype == np.bool_
                    else np.asarray(cols[q.name]).astype(np.uint32))
        for q in dataclasses.fields(query_cls)
    ])


def failing_rows(res: dict) -> dict:
    """residual -> the rows where it fails (0-d residuals as row 0)."""
    return {k: np.flatnonzero(~np.asarray(v).reshape(-1)).tolist()
            for k, v in res.items() if not np.asarray(v).all()}
