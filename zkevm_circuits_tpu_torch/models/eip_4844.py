"""eip_4844: the blob polynomial-evaluation circuit, standalone (the JAX
package's `models/eip_4844.py`).

Reference parity: `src/eip_4844/` (entry mod.rs:107-260) — 4096 x 31-byte
chunks (input.rs:26-27) interpreted as polynomial coefficients highest-degree
first; evaluation point z = keccak256(linear_hash || versioned_hash)
truncated to its last 16 bytes (mod.rs:157-174); Horner evaluation in the
BLS12-381 scalar field (17 x u16 limbs in the reference, mod.rs:40-42,
186-204); linear hash equality over the raw chunk bytes and an output
commitment keccak256(versioned_hash || truncated_hash || opening_value_be)
(mod.rs:206-242).  Scheduler integration is gated off upstream
(IMPLEMENT_4844_FUNCTIONALITY = false, scheduler/mod.rs:77).

Rows: Horner steps.  Step i materializes t_i = acc_i + fe_i (mod r) and
acc_{i+1} = t_i * z (mod r), checked as batched integer identities
(`ops/nonnative.py`); the three keccak chains (blob linear hash, challenge,
output) are built on the host and checked with the batched keccak on the
witness's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import gf, keccak, nonnative as nn
from ..utils import protocol
from ..utils.device import resolve_device
from ..utils.shard_plan import Axis, RowWindow, ShardPlan

BLS_FR = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
ELEMENTS_PER_4844_BLOCK = 4096
CHUNK_BYTES = 31
RATE = keccak.KECCAK_RATE_BYTES
M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class EIP4844Config:
    elements: int = ELEMENTS_PER_4844_BLOCK


def _fe_from_chunk_int(chunk_bytes: bytes) -> int:
    return int.from_bytes(chunk_bytes, "little")


def _keccak_chain_host(data: bytes):
    """padded blocks + state chain (host): (block lanes lo, hi, states u64,
    digest)."""
    padded = bytearray(data)
    pad_len = RATE - (len(padded) % RATE)
    if pad_len == 1:
        padded += b"\x81"
    else:
        padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80"
    nb = len(padded) // RATE
    lanes_np = np.zeros((nb, 17), np.uint64)
    states = np.zeros((nb + 1, 25), np.uint64)
    cur = [0] * 25
    for b in range(nb):
        lanes = keccak.bytes_to_lanes(bytes(padded[b * RATE: (b + 1) * RATE]))
        cur = keccak.keccak_f1600_ref([cur[j] ^ (lanes[j] if j < 17 else 0) for j in range(25)])
        states[b + 1] = cur
        lanes_np[b] = lanes
    digest = b"".join(int(states[nb][j]).to_bytes(8, "little") for j in range(4))
    lo = (lanes_np & np.uint64(M32)).astype(np.int64)
    return lo, (lanes_np >> np.uint64(32)).astype(np.int64), states, digest


@dataclasses.dataclass(frozen=True)
class EIP4844Witness:
    chunks: torch.Tensor  # (E, 31) byte values
    fe: torch.Tensor  # (E, 16) u16 limbs
    acc: torch.Tensor  # (E+1, 16)
    t: torch.Tensor  # (E, 16)  (acc_i + fe_i mod r)
    add_k: torch.Tensor  # (E, 1) small quotients for the additions
    mul_q: torch.Tensor  # (E, 17) quotients for t*z
    z: torch.Tensor  # (16,) evaluation point limbs
    versioned_hash: torch.Tensor  # (32,) bytes
    linear_hash: torch.Tensor  # (32,)
    truncated: torch.Tensor  # (16,)
    opening_be: torch.Tensor  # (32,)
    output_hash: torch.Tensor  # (32,)
    blob_blocks_lo: torch.Tensor
    blob_blocks_hi: torch.Tensor
    blob_states_lo: torch.Tensor
    blob_states_hi: torch.Tensor
    chal_states_lo: torch.Tensor  # (2, 25)
    chal_states_hi: torch.Tensor
    out_states_lo: torch.Tensor
    out_states_hi: torch.Tensor


def _limbs(values, nlimbs: int = 16) -> np.ndarray:
    raw = b"".join(int(v).to_bytes(2 * nlimbs, "little") for v in values)
    return np.frombuffer(raw, "<u2").reshape(len(values), nlimbs).astype(np.int64)


def generate_witness(chunks: list, versioned_hash: bytes, config: EIP4844Config,
                     device=None) -> EIP4844Witness:
    """chunks: up to `config.elements` 31-byte strings (the rest zero);
    `device=None` is the card."""
    device = resolve_device(device)
    E = config.elements
    data = list(chunks) + [b"\x00" * CHUNK_BYTES] * (E - len(chunks))
    if any(len(c) != CHUNK_BYTES for c in data):
        raise ValueError(f"a blob chunk is {CHUNK_BYTES} bytes")
    blob = b"".join(data)
    blob_lo, blob_hi, blob_states, linear_hash = _keccak_chain_host(blob)
    _, _, chal_states, chal_digest = _keccak_chain_host(linear_hash + versioned_hash)
    truncated = chal_digest[16:]
    z = int.from_bytes(truncated, "big")

    fes = [_fe_from_chunk_int(c) for c in data]
    acc = [0]
    ts, ks, qs = [], [], []
    for i, fe in enumerate(fes):
        k, t = divmod(acc[-1] + fe, BLS_FR)
        ts.append(t)
        ks.append(k)
        q, nxt = divmod(t * z, BLS_FR) if i != E - 1 else (0, t)
        qs.append(q)
        acc.append(nxt)
    opening_be = acc[-1].to_bytes(32, "big")
    _, _, out_states, output_hash = _keccak_chain_host(versioned_hash + truncated + opening_be)

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def by(b: bytes):
        return t_(np.frombuffer(b, np.uint8).astype(np.int64))

    def lo_hi(states):
        return (t_((states & np.uint64(M32)).astype(np.int64)),
                t_((states >> np.uint64(32)).astype(np.int64)))

    blob_slo, blob_shi = lo_hi(blob_states)
    chal_lo, chal_hi = lo_hi(chal_states)
    out_lo, out_hi = lo_hi(out_states)
    return EIP4844Witness(
        chunks=by(blob).reshape(E, CHUNK_BYTES),
        fe=t_(_limbs(fes)),
        acc=t_(_limbs(acc)),
        t=t_(_limbs(ts)),
        add_k=t_(np.asarray([nn.from_int(k, 1) for k in ks], np.int64).reshape(E, 1)),
        mul_q=t_(_limbs(qs, 17)),
        z=t_(_limbs([z])[0]),
        versioned_hash=by(versioned_hash),
        linear_hash=by(linear_hash),
        truncated=by(truncated),
        opening_be=by(opening_be),
        output_hash=by(output_hash),
        blob_blocks_lo=t_(blob_lo),
        blob_blocks_hi=t_(blob_hi),
        blob_states_lo=blob_slo,
        blob_states_hi=blob_shi,
        chal_states_lo=chal_lo,
        chal_states_hi=chal_hi,
        out_states_lo=out_lo,
        out_states_hi=out_hi,
    )


def _one_block(data_bytes: torch.Tensor):
    """the single padded keccak block of a short message (64 or 80 bytes):
    its (17,) lane halves."""
    n = data_bytes.shape[0]
    buf = torch.zeros(RATE, dtype=torch.int64, device=data_bytes.device)
    buf[:n] = data_bytes
    buf[n] = 0x01
    buf[RATE - 1] = buf[RATE - 1] | 0x80
    return keccak.lane_halves(buf)


def _one_block_chain_ok(states_lo, states_hi, data_bytes):
    """a two-state chain from zero over the one padded block of `data_bytes`."""
    lo, hi = _one_block(data_bytes)
    elo, ehi = keccak.absorb_block(states_lo[0][None], states_hi[0][None], lo[None], hi[None])
    return ((states_lo[0] == 0).all() & (elo[0] == states_lo[1]).all()
            & (ehi[0] == states_hi[1]).all())


def _blob_block_lanes(chunks: torch.Tensor, nb: int, first: int, count: int):
    """the (count, 17) lane halves of blocks first.. of the blob's padded
    keccak stream of nb blocks."""
    flat = chunks.reshape(-1)
    stream_len = flat.shape[0]
    idx = torch.arange(first * RATE, (first + count) * RATE, device=flat.device)
    stream = torch.where(idx < stream_len, flat[idx.clamp(max=stream_len - 1)],
                         torch.zeros_like(idx))
    stream = torch.where(idx == stream_len, torch.full_like(stream, 0x01), stream)
    stream = torch.where(idx == nb * RATE - 1, stream | 0x80, stream)
    return keccak.lane_halves(stream.reshape(count, RATE))


def eval_constraints(w: EIP4844Witness, config: EIP4844Config,
                     window: Optional[RowWindow] = None) -> dict:
    """Constraint evaluation on the witness's device; every entry must be
    all-True.  `window` places a block of elements and one of blob blocks
    in their run (`parallel/auto.py`); None is the whole run."""
    E = config.elements
    dev = w.chunks.device
    row0, run_e = (window.row0, window.total) if window else (0, E)
    res = {}

    # witness limb/byte range checks: the u16-limb identities are exact only
    # for limbs < 2^16 (and chunk bytes < 2^8)
    res["limb_range"] = (
        nn.check_range(w.acc).all() & nn.check_range(w.t).all() & nn.check_range(w.mul_q).all()
        & nn.check_range(w.add_k).all() & nn.check_range(w.fe).all()
        & nn.check_range(w.z[None]).all() & (w.chunks <= 0xFF).all()
        & (w.truncated <= 0xFF).all() & (w.linear_hash <= 0xFF).all()
        & (w.versioned_hash <= 0xFF).all() & (w.opening_be <= 0xFF).all())

    # field elements from chunk bytes (31 LE bytes -> 16 u16 limbs)
    by = w.chunks[row0:row0 + E]
    hi_bytes = torch.cat([by[:, 1::2], torch.zeros((E, 1), dtype=torch.int64, device=dev)], dim=-1)
    fe = by[:, 0::2] | (hi_bytes << 8)
    res["fe_from_chunks"] = (fe == w.fe).all(-1)

    rconst = torch.from_numpy(nn.from_int(BLS_FR).astype(np.int64)).to(dev).expand(E, 16)
    # addition: acc_i + fe_i == t_i + k_i * r
    res["horner_add"] = nn.sides_equal([("lin", w.acc[:-1], 1), ("lin", w.fe, 1)],
                                       [("lin", w.t, 1), ("prod", w.add_k, rconst, 1)], (E,))
    # multiply: t_i * z == q_i * r + acc_{i+1}  (all but the last step)
    mul_ok = nn.sides_equal([("prod", w.t, w.z.expand(E, 16), 1)],
                            [("prod", w.mul_q, rconst, 1), ("lin", w.acc[1:], 1)], (E,))
    is_last = torch.arange(row0, row0 + E, device=dev) == run_e - 1
    res["horner_mul"] = torch.where(is_last, torch.ones_like(mul_ok), mul_ok)
    res["horner_last"] = torch.where(is_last, (w.t == w.acc[1:]).all(-1), torch.ones_like(mul_ok))
    res["acc_starts_zero"] = (w.acc[0] == 0).all()

    # blob keccak chain + linear hash
    exp_lo, exp_hi = keccak.absorb_block(w.blob_states_lo[:-1], w.blob_states_hi[:-1],
                                         w.blob_blocks_lo, w.blob_blocks_hi)
    res["blob_chain"] = ((exp_lo == w.blob_states_lo[1:]).all(-1)
                         & (exp_hi == w.blob_states_hi[1:]).all(-1))
    res["linear_hash"] = (keccak.digest_bytes(w.blob_states_lo[-1], w.blob_states_hi[-1])
                          == w.linear_hash).all()
    # blob block bytes match chunk stream (+ padding)
    nb = w.blob_blocks_lo.shape[0]
    blob = window.axes["blob"] if window else None
    slo, shi = _blob_block_lanes(w.chunks, blob.total if blob else nb, blob.row0 if blob else 0,
                                 nb)
    res["blob_blocks"] = (slo == w.blob_blocks_lo).all(-1) & (shi == w.blob_blocks_hi).all(-1)

    # challenge hash: keccak(linear_hash || versioned_hash), z = last 16 bytes BE
    res["challenge_chain"] = _one_block_chain_ok(
        w.chal_states_lo, w.chal_states_hi, torch.cat([w.linear_hash, w.versioned_hash]))
    chal_digest = keccak.digest_bytes(w.chal_states_lo[1], w.chal_states_hi[1])
    res["truncated_hash"] = (chal_digest[16:] == w.truncated).all()
    # z limbs from BE truncated bytes
    zint = torch.zeros(16, dtype=torch.int64, device=dev)
    for i in range(16):  # byte i is most significant of the remaining
        zint[(15 - i) // 2] += w.truncated[i] << (8 * ((15 - i) % 2))
    res["z_limbs"] = ((zint & M32) == w.z).all()

    # opening value BE serialization of acc_E
    acc_final = w.acc[E]
    ob = torch.stack([(acc_final[(31 - i) // 2] >> (8 * ((31 - i) % 2))) & 0xFF
                      for i in range(32)])
    res["opening_serialization"] = (ob == w.opening_be).all()
    res["opening_canonical"] = nn.limbs_lt(acc_final[None], BLS_FR)[0]

    # output hash block
    res["output_chain"] = _one_block_chain_ok(
        w.out_states_lo, w.out_states_hi, torch.cat([w.versioned_hash, w.truncated, w.opening_be]))
    res["output_hash"] = (keccak.digest_bytes(w.out_states_lo[1], w.out_states_hi[1])
                          == w.output_hash).all()
    return res


def all_ok(residuals: dict) -> bool:
    return all(bool(v.all()) for v in residuals.values())


# row-sharded over the Horner steps and, as a further axis, over the blob's
# keccak blocks; the chunk bytes stay whole on every member, for a block
# window reads the bytes of its own blocks by range; the challenge and
# output chains are whole, and the first accumulator is the first member's;
# the range check is ANDed over the members
eval_constraints.shard_plan = ShardPlan(
    rows=frozenset({"fe", "acc", "t", "add_k", "mul_q"}),
    axes={"blob": Axis(rows_of="blob_blocks_lo",
                       fields=frozenset({"blob_blocks_lo", "blob_blocks_hi",
                                         "blob_states_lo", "blob_states_hi"}),
                       residuals=frozenset({"blob_chain", "blob_blocks"}))},
    last=frozenset({"linear_hash", "opening_serialization", "opening_canonical"}),
    whole=frozenset({"acc_starts_zero", "challenge_chain", "truncated_hash", "z_limbs",
                     "output_chain", "output_hash"}),
    every=frozenset({"limb_range"}),
    takes_window=True,
    window_config=lambda config, rows: dataclasses.replace(config, elements=rows),
)


# PyTorch runs eagerly: the counterparts of the JAX package's jitted names.
generate_witness_jit = generate_witness
eval_constraints_jit = eval_constraints


def instance_compact_form(w: EIP4844Witness, config: EIP4844Config):
    """Single-instance ClosedFormInput (EIP4844OutputData: linear_hash +
    output_hash; observable input is () — ref eip_4844 mod.rs:143-155)."""
    dev = w.chunks.device
    obs_out = torch.cat([gf.from_u32(w.linear_hash), gf.from_u32(w.output_hash)])[None]
    return protocol.single_instance_compact_form(gf.zeros((1, 0), dev), obs_out)
