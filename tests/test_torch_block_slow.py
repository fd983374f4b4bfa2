"""The whole block with its proofs, the port against the JAX package (slow:
the STARKs are proven on the CPU).

On tests/test_block2.py's program and config (the sorter STARKs with their
full chains, every compact-commitment proof), JAX's `execute_block2` and the
port's agree on every compact form per type, every residual, the JAX
handoffs (the port's own handoffs beside them all true), the STARK and
commitment verdicts, the scheduler's checks, the content hash and the
public input.  The program makes one call of each precompile, so the two
runtimes' memory-union orders agree (ROADMAP Queue 3).

A port-only block on the same program proves everything the JAX runtime
can ask for: the main_vm STARK, the hash chains (types 3, 5, 6, 13 and the
blob's 255), the demux routing, the storage paths' blake2s, the ecrecover
ladders, every compact commitment and an in-field node; every verdict is
true.  The JAX runtime cannot run this block: its type-3 writer reads
`round_call` (block2.py:732), a field the unpacker's witness does not have.
"""

import numpy as np
import pytest
import torch

from torch_block_helpers import jax_block2_program, u64
from zkevm_circuits_tpu.runtime import block2 as jblock2
from zkevm_circuits_tpu_torch.runtime import block2
from torch_test_policy import policy_per_module, policy_per_test  # noqa: F401

pytestmark = pytest.mark.slow

CPU = torch.device("cpu")
SIZES = dict(vm_limit=128, vm_instance_limit=32, sorter_limit=32, hasher_limit=8,
             unpacker_rounds=16, keccak_blocks=8, keccak_reads=16, sha_rounds=8,
             ec_calls=1, storage_rows=16, ram_limit=128)
PROOFS = dict(prove_sorter_starks=True, prove_full_sorter_chains=True, prove_commitments=True)
FORM_FIELDS = ("start_flag", "completion_flag", "observable_input_commitment",
               "observable_output_commitment", "hidden_fsm_input_commitment",
               "hidden_fsm_output_commitment")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x.astype_u64() if hasattr(x, "astype_u64") else x)


@pytest.fixture(scope="module")
def blocks():
    code, kw, _ = jax_block2_program()
    jres = jblock2.execute_block2(code, jblock2.Block2Config(**SIZES, **PROOFS), **kw)
    res = block2.execute_block2(code, block2.Block2Config(**SIZES, **PROOFS), device=CPU, **kw)
    return res, jres


def test_block_equal_to_jax(blocks):
    res, jres = blocks
    assert res.ok and jres.ok, (res.failing(), jres.failing())
    assert sorted(res.compact_forms) == sorted(jres.compact_forms) == list(range(1, 14))
    for t, cf in res.compact_forms.items():
        for f in FORM_FIELDS:
            got, want = getattr(cf, f), getattr(jres.compact_forms[t], f)
            np.testing.assert_array_equal(u64(got) if got.dtype == torch.int64 else _np(got),
                                          _np(want), err_msg=f"type {t} {f}")
    assert sorted(res.residuals) == sorted(jres.residuals)
    for name, r in res.residuals.items():
        assert sorted(r) == sorted(jres.residuals[name]), name
        for k, x in r.items():
            np.testing.assert_array_equal(_np(x), _np(jres.residuals[name][k]),
                                          err_msg=f"{name}.{k}")
    for k, x in jres.handoffs.items():
        assert res.handoffs[k] == x, k
    assert all(res.handoffs.values())
    assert res.stark_verdicts == jres.stark_verdicts
    assert sorted(res.stark_verdicts) == [2, 8, 9, 11, 12]
    assert res.commitment_verdicts == jres.commitment_verdicts
    assert sorted(res.commitment_verdicts) == list(range(1, 14))
    assert list(res.scheduler_result.checks.items()) == list(jres.scheduler_result.checks.items())
    assert res.scheduler_result.block_content_hash == jres.scheduler_result.block_content_hash
    np.testing.assert_array_equal(u64(res.scheduler_result.public_input),
                                  u64(jres.scheduler_result.public_input))
    assert res.l1_messages_hash == jres.l1_messages_hash


def test_port_block_with_every_proof():
    code, kw, _ = jax_block2_program()
    blob = ([bytes([7]) * 31, bytes([9]) * 31], b"\x01" + b"\x22" * 31)
    cfg = block2.Block2Config(**SIZES, prove_vm=True, prove_hash_chains=True, prove_routing=True,
                              prove_storage_paths=True, prove_ecrecover=True,
                              prove_commitments=True, node_in_field_types=(13,))
    log = []
    res = block2.execute_block2(code, cfg, device=CPU, blobs=[blob], log=log, **kw)
    assert res.ok, res.failing()
    assert res.stark_verdicts == {t: True for t in (1, 3, 4, 5, 6, 7, 10, 13, 255)}
    assert res.handoffs["vm_code_reads_on_tape"]
    assert res.commitment_verdicts == {t: True for t in range(1, 14)}
    assert {r["name"].split()[0] for r in log} >= {"main_vm", "sha256", "keccak", "demux",
                                                   "blake2s", "ecrecover", "horner"}
