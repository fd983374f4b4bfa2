"""Block programs and JAX conversions shared by the torch port's block tests.

`straight_block_program`: a bootloader of 25 cycles, no loop, in which all
13 circuit types have work: a storage write and read, an event, an L1
message, then one far call into each precompile contract (keccak, sha256,
ecrecover), the data in the bootloader heap.  One call a precompile, so the
JAX block runtime's memory-union order is the chains' order (ROADMAP
Queue 3).

`jax_block2_program`: the program of tests/test_block2.py (its bootloader,
its three precompile contracts and its signed heap), as data.

`jax_scheduler_inputs` turns the port's `run_scheduler` keywords into the
JAX package's (u64 values, bools and bytes unchanged).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from zkevm_circuits_tpu.models import recursion as jrec
from zkevm_circuits_tpu.models import scheduler as jsched
from zkevm_circuits_tpu.ops import gf as jgf
from zkevm_circuits_tpu.utils import protocol as jprotocol

import chip_smoke
from zkevm_circuits_tpu_torch.isa import opcodes as isa
from zkevm_circuits_tpu_torch.isa import system_params as sp
from zkevm_circuits_tpu_torch.models import code_unpacker_sha256 as cu
from zkevm_circuits_tpu_torch.models import vm
from zkevm_circuits_tpu_torch.ops import gf
from zkevm_circuits_tpu_torch.ops import secp256k1 as ec
from zkevm_circuits_tpu_torch.ops.keccak import keccak256_ref

enc = isa.encode_instruction
FIRST = 1 << isa.FIRST_MESSAGE_FLAG_IDX
SWAP = 1 << isa.SWAP_OPERANDS_FLAG_IDX_FOR_ARITH_OPCODES


def _imm(val, dst):
    return enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=val, src1=0, dst0=dst)


def _deploy(storage, code_store, address, words):
    code_hash = cu.make_request(words, 0, 0)["code_hash"]
    storage[(0, sp.DEPLOYER_SYSTEM_CONTRACT_ADDRESS, address)] = code_hash
    code_store[code_hash] = words


def straight_block_program(key=5, value=77):
    """(code words, EraVM keyword arguments): the storage cell `key` of the
    bootloader written with `value` and read back, an event and an L1
    message of them, and one call of each precompile."""
    page = sp.BOOTLOADER_HEAP_PAGE
    storage, code_store = {}, {}
    precompile = vm.assemble_code_words([enc(isa.LOG, isa.LOG_PRECOMPILE_CALL, src0=3, src1=0),
                                         enc(isa.RET, isa.RET_OK)])
    addresses = (sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS, sp.SHA256_PRECOMPILE_FORMAL_ADDRESS,
                 sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS)
    for k, address in enumerate(addresses):
        _deploy(storage, code_store, address, chip_smoke._pad_code(precompile, 3, [(2, k)]))

    # the heap: a signature (h, v, r, s) at words 0..3, 40 bytes of keccak
    # payload from byte 3 of word 4, a pre-padded sha256 block at words 8..9
    h = int.from_bytes(keccak256_ref(b"zk block"), "big")
    r, s, recid = ec.sign(h, 0xC0FFEE, 0x12345)
    heap = {0: h, 1: recid, 2: r, 3: s, 4: int.from_bytes(keccak256_ref(b"a"), "big"),
            5: int.from_bytes(keccak256_ref(b"b"), "big")}
    padded = chip_smoke._sha_padded(b"abc")
    heap[8], heap[9] = int.from_bytes(padded[:32], "big"), int.from_bytes(padded[32:], "big")
    keys = (chip_smoke._mem_key(4 * 32 + 3, 40, 16, page),
            chip_smoke._mem_key(8, 0, 17, page, 1),
            chip_smoke._mem_key(0, 0, 18, page))

    n_words = 17
    abi_slot = n_words - 1
    prog = [_imm(key, 2), _imm(value, 3),
            enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=2, src1=3),
            enc(isa.LOG, isa.LOG_STORAGE_READ, src0=2, dst0=4),
            enc(isa.LOG, isa.LOG_EVENT, src0=2, src1=3, flags=FIRST),
            enc(isa.LOG, isa.LOG_TO_L1_MESSAGE, src0=2, src1=3)]
    for k, address in enumerate(addresses):
        prog += [enc(isa.ADD, src_mode=isa.SRC_CODE, imm0=abi_slot - 1 - k, src1=0, dst0=3),
                 enc(isa.ADD, src_mode=isa.SRC_CODE, imm0=abi_slot, src1=0, dst0=1),
                 _imm(address, 4),
                 enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=4, imm0=len(prog) + 4)]
    prog += [enc(isa.RET, isa.RET_OK)]
    abi = (1 << 248) | (1 << (192 + 20))  # a system call with 2^20 ergs
    consts = [(abi_slot, abi)] + [(abi_slot - 1 - k, key_) for k, key_ in enumerate(keys)]
    words = chip_smoke._pad_code(vm.assemble_code_words(prog), n_words, consts)
    return words, dict(storage=storage, code_store=code_store, bootloader_heap=heap)


# --- tests/test_block2.py's program ------------------------------------------

def _shl(src, amt_reg, dst):
    return enc(isa.SHIFT, isa.SHIFT_SHL, src0=src, src1=amt_reg, dst0=dst)


def _odd_words(prog):
    words = vm.assemble_code_words(prog)
    if len(words) % 2 == 0:
        words.append(0)
    return words


def _ecrecover_contract():
    prog = [
        _imm(32, 3),
        enc(isa.SHIFT, isa.SHIFT_SHR, src0=1, src1=3, dst0=2),
        _imm(1, 4),
        _shl(4, 3, 4),
        enc(isa.SUB, src_mode=isa.SRC_IMM, imm0=1, src1=4, dst0=4, flags=SWAP),
        enc(isa.BINOP, isa.BINOP_AND, src0=2, src1=4, dst0=2),
        _imm(128, 3),
        _shl(2, 3, 2),
        enc(isa.LOG, isa.LOG_PRECOMPILE_CALL, src0=2, src1=0),
        enc(isa.UMA, isa.UMA_HEAP_READ, src0=0, dst0=5),
        _imm(32, 6),
        enc(isa.UMA, isa.UMA_HEAP_READ, src0=6, dst0=7),
        enc(isa.RET, isa.RET_OK),
    ]
    return _odd_words(prog)


def _keccak_contract():
    prog = [
        _imm(0xDEAD, 2),
        _imm(16, 3),
        _shl(2, 3, 2),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=0xBEEF, src1=2, dst0=2),
        _imm(224, 3),
        _shl(2, 3, 2),
        enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=0, src1=2),
        _imm(4, 4),
        _imm(32, 5),
        _shl(4, 5, 4),
        _imm(10, 6),
        _imm(64, 7),
        _shl(6, 7, 6),
        enc(isa.ADD, src0=4, src1=6, dst0=4),
        enc(isa.LOG, isa.LOG_PRECOMPILE_CALL, src0=4, src1=0),
        _imm(320, 8),
        enc(isa.UMA, isa.UMA_HEAP_READ, src0=8, dst0=9),
        enc(isa.RET, isa.RET_OK),
    ]
    return _odd_words(prog)


def _sha256_contract():
    prog = [
        _imm(0x6162, 2),
        _imm(16, 3),
        _shl(2, 3, 2),
        enc(isa.ADD, src_mode=isa.SRC_IMM, imm0=0x6380, src1=2, dst0=2),
        _imm(224, 3),
        _shl(2, 3, 2),
        enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=0, src1=2),
        _imm(24, 4),
        _imm(32, 5),
        enc(isa.UMA, isa.UMA_HEAP_WRITE, src0=5, src1=4),
        _imm(1, 6),
        _imm(192, 7),
        _shl(6, 7, 6),
        _imm(12, 8),
        _imm(64, 9),
        _shl(8, 9, 8),
        enc(isa.ADD, src0=6, src1=8, dst0=6),
        enc(isa.LOG, isa.LOG_PRECOMPILE_CALL, src0=6, src1=0),
        enc(isa.RET, isa.RET_OK),
    ]
    return _odd_words(prog)


def _abi_ergs(len_bytes=0):
    out = [_imm(800, 5), _imm(8, 6), _shl(5, 6, 5), _imm(192, 6), _shl(5, 6, 1)]
    if len_bytes:
        out += [_imm(len_bytes, 6), _imm(96, 7), _shl(6, 7, 6),
                enc(isa.ADD, src0=1, src1=6, dst0=1)]
    return out


def _bootloader(eh):
    eh_imm = eh or 0
    prog = [
        _imm(5, 2),
        _imm(77, 3),
        enc(isa.LOG, isa.LOG_STORAGE_WRITE, src0=2, src1=3),
        enc(isa.LOG, isa.LOG_STORAGE_READ, src0=2, dst0=4),
        enc(isa.LOG, isa.LOG_EVENT, src0=2, src1=3, flags=FIRST),
        enc(isa.LOG, isa.LOG_TO_L1_MESSAGE, src0=2, src1=3),
    ]
    prog += _abi_ergs(len_bytes=128)
    prog += [_imm(sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS, 2),
             enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=2, imm0=eh_imm)]
    prog += _abi_ergs()
    prog += [_imm(sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS, 2),
             enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=2, imm0=eh_imm)]
    prog += _abi_ergs()
    prog += [_imm(sp.SHA256_PRECOMPILE_FORMAL_ADDRESS, 2),
             enc(isa.FAR_CALL, isa.FAR_CALL_NORMAL, src0=1, src1=2, imm0=eh_imm)]
    prog += [enc(isa.RET, isa.RET_OK)]
    if eh is not None:
        assert len(prog) == eh
    prog += [enc(isa.RET, isa.RET_PANIC)]
    return prog


def jax_block2_program():
    """(code words, EraVM keyword arguments, signer's private key) of
    tests/test_block2.py's `block_result` fixture."""
    storage, code_store = {}, {}
    for address, code in ((sp.ECRECOVER_PRECOMPILE_FORMAL_ADDRESS, _ecrecover_contract()),
                          (sp.KECCAK256_PRECOMPILE_FORMAL_ADDRESS, _keccak_contract()),
                          (sp.SHA256_PRECOMPILE_FORMAL_ADDRESS, _sha256_contract())):
        _deploy(storage, code_store, address, code)
    priv, k = 0xC0FFEE, 0x12345
    h = int.from_bytes(keccak256_ref(b"zk block"), "big")
    r, s, recid = ec.sign(h, priv, k)
    heap = {0: h, 1: recid, 2: r, 3: s}
    eh = len(_bootloader(None)) - 1
    code = vm.assemble_code_words(_bootloader(eh))
    return code, dict(storage=storage, code_store=code_store, bootloader_heap=heap), priv


# --- the port's scheduler inputs as the JAX package's --------------------------

def jax_field(t):
    return jgf.from_u64(gf.to_u64(t))


def jax_forms(cf):
    """a port ClosedFormInputCompactForm as the JAX package's"""
    return jprotocol.ClosedFormInputCompactForm(
        jnp.asarray(cf.start_flag.cpu().numpy()), jnp.asarray(cf.completion_flag.cpu().numpy()),
        *[jax_field(getattr(cf, k)) for k in ("observable_input_commitment",
                                              "observable_output_commitment",
                                              "hidden_fsm_input_commitment",
                                              "hidden_fsm_output_commitment")])


def jax_proof(p):
    """a port node proof as the JAX scheduler reads it (public input,
    validity, VK or None)"""
    return jrec.ProofSurrogate(jax_field(p.public_input), bool(p.is_valid),
                               None if p.vk_commitment is None else jax_field(p.vk_commitment))


def jax_scheduler_inputs(kw: dict) -> dict:
    """the keywords of the port's `run_scheduler` for the JAX package's"""
    return dict(
        compact_forms_by_type={t: jax_forms(cf) for t, cf in kw["compact_forms_by_type"].items()},
        node_proofs_by_type={t: jax_proof(p) for t, p in kw["node_proofs_by_type"].items()},
        leaf_params_by_type={t: jrec.RecursionLeafParameters(
            p.circuit_type, p.basic_circuit_vk_commitment, p.leaf_vk_commitment)
            for t, p in kw["leaf_params_by_type"].items()},
        node_vk_commitment=kw["node_vk_commitment"],
        previous_block_content_hash=kw["previous_block_content_hash"],
        block_data=jsched.BlockPassthroughData(*[
            tuple(jsched.PerShardState(**dataclasses.asdict(s)) for s in
                  kw["block_data"].per_shard_states)]),
        block_meta=jsched.BlockMetaParameters(**dataclasses.asdict(kw["block_meta"])),
        aux_output=jsched.BlockAuxilaryOutput(**dataclasses.asdict(kw["aux_output"])),
        derived_observable_inputs=None if kw["derived_observable_inputs"] is None else {
            t: jax_field(d) for t, d in kw["derived_observable_inputs"].items()},
        required_types=kw["required_types"],
    )


def u64(t) -> np.ndarray:
    """a port field tensor or a JAX GF as numpy u64"""
    return gf.to_u64(t) if hasattr(t, "cpu") else np.asarray(t.astype_u64(), np.uint64)
