"""Plain reference of the main_vm benchmark loop: a simulator of the six
opcodes it uses, the memory queue it commits to, and the rule a check's
verdict is held to.

The program (instruction indices):
  0  ADD  r5 = outer                      (immediate)
  1  ADD  r1 = inner                      (immediate)
  2  SUB  r1 = r1 - 1, flags set
  3  MUL  r2, r3 = low, high of r1 * r1
  4  XOR  r4 = r2 ^ r1
  5  JUMP to 2 if not equal
  6  SUB  r5 = r5 - 1, flags set
  7  JUMP to 1 if not equal
  8  RET
One instruction a cycle.  A subtraction with flags sets
(overflow, equal, greater) = (borrow, result == 0, neither); the other
opcodes keep the flags.  After the RET the frame is left: the call stack is
empty (depth 0), pc, flags and the code page are 0, r2..r5 keep their values,
r1 holds the return pointer, and every later cycle is skipped.

Each cycle that is not skipped takes 4 timestamps and fetches its
instruction: a 256-bit code word holds instructions 4j..4j+3, the one at
sub-pc k in u32 limbs (6 - 2k, 7 - 2k).  The word is read from memory (a
query at the cycle's timestamp, on the code page, at index pc >> 2) when the
code page or pc >> 2 differs from the last fetch's; a read absorbs the
query's 8-element encoding (the memory-query encoding of the ram reference)
into the memory queue's sponge by rate replacement and one Poseidon2
permutation.  The loop reads and writes registers only, so code reads are its
only memory queries.

`simulate` gives the state columns a witness has (row i is the state before
cycle i) and the per-cycle fetch columns.  `witness_diff` holds the
program's columns to them; `queue_diff` holds the program's memory-queue
sponge to the reference's Poseidon2, each transition from the program's state
of the row before (a chain of 2^19 dependent permutations cannot be followed
in plain torch in a run's time) and the first state to the empty sponge: by
induction that is the whole chain.  Plain numpy and torch; it imports nothing
of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import poseidon2 as p2
from .ram_permutation import encode

U32 = (1 << 32) - 1


def loop_pcs(outer: int, inner: int, cycles: int) -> np.ndarray:
    """the pc of rows 0..cycles in closed form (0 after the return)."""
    it = 3 + 4 * inner
    ret = 2 + outer * it
    rows = np.arange(cycles + 1)
    j = (rows - 1) % it
    body = np.where(j == 0, 1, np.where(j <= 4 * inner, 2 + (j - 1) % 4,
                                        np.where(j == 4 * inner + 1, 6, 7)))
    return np.where(rows == 0, 0, np.where(rows == ret - 1, 8,
                                           np.where(rows >= ret, 0, body))).astype(np.int64)


def simulate(outer: int, inner: int, cycles: int, boot: dict) -> dict:
    """columns over rows 0..cycles: pc, flags (of, eq, gt), regs r1..r5 (low
    32 bits; the loop's values never leave them), depth, code_page, ts,
    prev_page, prev_super, prev_word (the index of the last word fetched, -1
    before the first), mem_len; over cycles: read (a fetch from memory);
    `ret`, the row after the RET."""
    code_page, ts, step = boot["code_page"], boot["timestamp"], boot["timestamp_step"]
    cols = {k: [] for k in ("pc", "flags", "regs", "depth", "code_page", "ts", "prev_page",
                            "prev_super", "prev_word", "mem_len")}
    reads = []
    pc, fl, r = 0, (False, False, False), [0, 0, 0, 0, 0]
    depth, page = 1, code_page
    prev_page, prev_super, prev_word, mem_len = 0, 0, -1, 0
    ret = None

    def record():
        for k, v in (("pc", pc), ("flags", fl), ("regs", tuple(r)), ("depth", depth),
                     ("code_page", page), ("ts", ts), ("prev_page", prev_page),
                     ("prev_super", prev_super), ("prev_word", prev_word),
                     ("mem_len", mem_len)):
            cols[k].append(v)

    for _ in range(cycles):
        record()
        skip = depth == 0
        super_pc = pc >> 2
        read = not skip and (prev_page != page or prev_super != super_pc)
        reads.append(read)
        if read:
            prev_word, mem_len = super_pc, mem_len + 1
        if not skip:
            prev_super, ts = super_pc, ts + step
        prev_page = page
        if skip:
            continue
        if pc == 0:
            r[4], pc = outer, 1
        elif pc == 1:
            r[0], pc = inner, 2
        elif pc in (2, 6):
            k = 0 if pc == 2 else 4
            borrow = r[k] < 1
            r[k] = (r[k] - 1) % (1 << 32)
            fl = (borrow, r[k] == 0, not borrow and r[k] != 0)
            pc += 1
        elif pc == 3:
            r[1], r[2], pc = r[0] * r[0], 0, 4
        elif pc == 4:
            r[3], pc = r[1] ^ r[0], 5
        elif pc in (5, 7):
            pc = (2 if pc == 5 else 1) if not fl[1] else pc + 1
        elif pc == 8:
            ret = len(cols["pc"])
            pc, fl, depth, page = 0, (False, False, False), 0, 0
    record()
    if ret is None:
        raise ValueError(f"the loop ({outer} x {inner}) does not return within {cycles} cycles")
    out = {k: np.array(v, dtype=np.int64) for k, v in cols.items() if k != "flags"}
    f = np.array(cols["flags"], dtype=bool)
    out.update(f_of=f[:, 0], f_eq=f[:, 1], f_gt=f[:, 2], read=np.array(reads, dtype=bool),
               ret=ret)
    return out


def word_limbs(words: list) -> np.ndarray:
    """(n, 8) u32 limbs, least significant first, of 256-bit code words."""
    return np.array([[(w >> (32 * i)) & U32 for i in range(8)] for w in words], dtype=np.int64)


def witness_diff(sim: dict, words: list, w: dict) -> int:
    """elements of the witness columns (torch tensors, as the program holds
    them) that differ from the simulation of the code words `words`."""
    dev = w["regs"].device
    ret = sim["ret"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    regs, ptr = w["regs"], w["regs_ptr"]
    ref = t(sim["regs"])
    diff = (regs[:, 1:5, 0] != ref[:, 1:5]).sum() + (regs[:, 1:, 1:] != 0).sum()
    diff += (regs[:, 5:, 0] != 0).sum() + ptr[:, 1:].sum()
    diff += (regs[2:ret, 0, 0] != ref[2:ret, 0]).sum() + (regs[2:ret, 0, 1:] != 0).sum()
    diff += ptr[2:ret, 0].sum()
    for key in ("f_of", "f_eq", "f_gt"):
        diff += (w[key].bool() != t(sim[key])).sum()
    for key, col in (("ctx_pc", "pc"), ("cs_depth", "depth"), ("ctx_code_page", "code_page"),
                     ("ts", "ts"), ("prev_code_page", "prev_page"),
                     ("prev_super_pc", "prev_super"), ("mem_q_len", "mem_len")):
        diff += (w[key] != t(sim[col])).sum()
    limbs = word_limbs(words)
    fetched = np.where((sim["prev_word"] >= 0)[:, None], limbs[np.maximum(sim["prev_word"], 0)], 0)
    diff += (w["prev_code_word"] != t(fetched)).sum()
    read = t(sim["read"])
    diff += (w["should_read_opcode"] != read).sum()
    n = read.shape[0]
    word_at = t(limbs[sim["pc"][:n] >> 2])
    diff += (w["code_word_read"][read] != word_at[read]).sum()
    k = t(sim["pc"][:ret] & 3)
    lo = word_at[:ret].gather(1, (6 - 2 * k)[:, None])[:, 0]
    hi = word_at[:ret].gather(1, (7 - 2 * k)[:, None])[:, 0]
    diff += (w["raw_opcode_lo"][:ret] != lo).sum() + (w["raw_opcode_hi"][:ret] != hi).sum()
    return int(diff)


def queue_diff(sim: dict, words: list, w: dict, block: int = 1 << 18) -> int:
    """elements of the program's memory-queue sponge states that differ from
    the reference's: the first state is the empty sponge (zeros); after a
    cycle that reads a code word the state is the reference's absorb of that
    read's encoding into the program's state of the row before; after any
    other cycle it is unchanged.  In blocks of `block` reads."""
    state = w["mem_q_state"]
    dev = state.device
    diff = int((state[0] != 0).sum())
    read = torch.from_numpy(sim["read"]).to(dev)
    n = read.shape[0]
    diff += int((state[1:][~read] != state[:-1][~read]).sum())
    rows = torch.nonzero(read).reshape(-1)
    limbs = torch.from_numpy(word_limbs(words)).to(dev)
    pcs = torch.from_numpy(sim["pc"][:n]).to(dev)
    ts = torch.from_numpy(sim["ts"][:n]).to(dev)
    page = torch.from_numpy(sim["code_page"][:n]).to(dev)
    for at in range(0, rows.shape[0], block):
        i = rows[at:at + block]
        zero = torch.zeros_like(i, dtype=torch.bool)
        enc = encode(dict(timestamp=ts[i], memory_page=page[i], index=pcs[i] >> 2,
                          rw_flag=zero, is_ptr=zero, value=limbs[pcs[i] >> 2]))
        diff += int((p2.absorb(state[i], enc) != state[i + 1]).sum())
    return diff


def verdict_ok(pairs: set, faults: list) -> bool:
    """whether a check's false (group, cycle) pairs are those its faults
    make: every pair a fault's kind says it fails ("fails": the groups whose
    relation reads the tampered entry itself) is false, and every false pair
    is one of those or one a fault's kind says it may fail ("may": groups
    that read the entry through the cycle's data).  An honest witness has no
    false pair."""
    due = {(g, f["row"] + o) for f in faults for g, o in f["fails"]}
    may = {(g, f["row"] + o) for f in faults for g, o in f["may"]}
    return due <= pairs <= due | may
