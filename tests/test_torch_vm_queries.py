"""Log and decommit query packing: the torch port against the JAX package
and the python-int mirrors on the same seeded rows, as u64, exactly."""

import numpy as np

from zkevm_circuits_tpu.base_structures import decommit_query as jdq, log_query as jlq

from zkevm_circuits_tpu_torch.base_structures import decommit_query as dq, log_query as lq
from zkevm_circuits_tpu_torch.ops import gf
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401


def _log_rows(n, seed=11):
    rng = np.random.default_rng(seed)

    def big(bits):
        return int.from_bytes(rng.bytes(bits // 8), "little")

    return [
        dict(address=big(160), key=big(256), read_value=big(256), written_value=big(256),
             aux_byte=int(rng.integers(0, 256)), rw_flag=bool(rng.integers(0, 2)),
             rollback=bool(rng.integers(0, 2)), is_service=bool(rng.integers(0, 2)),
             shard_id=int(rng.integers(0, 256)),
             tx_number_in_block=int(rng.integers(0, 1 << 32)),
             timestamp=int(rng.integers(0, 1 << 32)))
        for _ in range(n)
    ]


def test_log_encoding_matches_jax_and_mirror():
    rows = _log_rows(9) + [dict(key=1)]
    q = lq.LogQueries.from_lists(rows, "cpu")
    jq = jlq.LogQueries.from_lists(rows)
    enc = gf.to_u64(lq.encode_log_queries(q))
    assert enc.shape == (10, lq.LOG_QUERY_PACKED_WIDTH)
    assert np.array_equal(enc, np.asarray(jlq.encode_log_queries(jq).astype_u64()))
    assert enc.tolist() == [lq.encode_log_query_ref(r) for r in rows]
    assert enc.tolist() == [jlq.encode_log_query_ref(r) for r in rows]
    rb = gf.to_u64(lq.encode_with_rollback_flag(q))
    assert np.array_equal(rb, np.asarray(jlq.encode_with_rollback_flag(jq).astype_u64()))
    assert (rb[:, 19] == 1).all() and np.array_equal(rb[:, :19], enc[:, :19])
    cols = {k: getattr(q, k).numpy() for k in
            ("address", "key", "read_value", "written_value", "aux_byte", "rw_flag",
             "rollback", "is_service", "shard_id", "tx_number_in_block", "timestamp")}
    assert np.array_equal(lq.encode_log_queries_np(**cols), enc)
    assert np.array_equal(gf.to_u64(lq.encode_log_queries(q[2:5])), enc[2:5])


def test_log_encoding_out_of_range_fields_match_jax():
    """Fields above the byte range: the high 32 bits wrap as the JAX
    package's u32 lane does."""
    rows = _log_rows(3, seed=12)
    rows[0]["shard_id"] = 0x12345
    rows[1]["aux_byte"] = 0x1FFFFFF
    q = lq.LogQueries.from_lists(rows, "cpu")
    jq = jlq.LogQueries.from_lists(rows)
    assert np.array_equal(gf.to_u64(lq.encode_log_queries(q)),
                          np.asarray(jlq.encode_log_queries(jq).astype_u64()))


def test_log_zeros_and_shape():
    z = lq.LogQueries.zeros((2, 3), "cpu")
    assert z.shape == (2, 3) and z.key.shape == (2, 3, 8) and z.address.shape == (2, 3, 5)
    assert not gf.to_u64(lq.encode_log_queries(z)).any()


def test_decommit_encoding_matches_jax_and_mirror():
    rng = np.random.default_rng(13)
    rows = [
        dict(code_hash=int.from_bytes(rng.bytes(32), "little"),
             page=int(rng.integers(0, 1 << 32)), is_first=bool(rng.integers(0, 2)),
             timestamp=int(rng.integers(0, 1 << 32)))
        for _ in range(8)
    ]
    q = dq.DecommitQueries.from_lists(rows, "cpu")
    enc = gf.to_u64(dq.encode_decommit_queries(q))
    want = jdq.encode_decommit_queries(jdq.DecommitQueries.from_lists(rows)).astype_u64()
    assert enc.shape == (8, dq.DECOMMIT_QUERY_PACKED_WIDTH)
    assert np.array_equal(enc, np.asarray(want))
    assert enc.tolist() == [dq.encode_decommit_query_ref(r) for r in rows]
    assert enc.tolist() == [jdq.encode_decommit_query_ref(r) for r in rows]
    assert np.array_equal(gf.to_u64(dq.encode_decommit_queries(q[3:])), enc[3:])
    z = dq.DecommitQueries.zeros((4,), "cpu")
    assert z.shape == (4,) and not gf.to_u64(dq.encode_decommit_queries(z)).any()
