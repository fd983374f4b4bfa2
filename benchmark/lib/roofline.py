"""The least time the card could take for the Poseidon2 work a cell asks for.

Copied from the bring-up smoke script's bound (sound, counted from the
algorithm).  One permutation needs, at the least:
Goldilocks products: 8 full rounds x 12 lanes x 4 (x^7) + 22 partial rounds
x (4 for x^7 + 12 for M_I); additions: 9 M_E x 62 + 96 full-round constants
+ 22 x (1 constant + 11 for the lane sum + 12 for M_I).  A product is 20
32-bit integer instructions (4 wide multiply-adds and 4 carry adds for the
128 bits, 12 for the reduction), an addition 6.  The card issues one INT32
instruction a lane a clock, 64 lanes an SM.  Bytes: 96 in and 96 out a
state, or for a chain each 8-element encoding and its execute byte once and
the segment boundary and landing states once, over the HBM rate.  The bound
is the larger of the two times.
"""

from __future__ import annotations

import subprocess

PRODUCTS_PER_STATE = 8 * 12 * 4 + 22 * (4 + 12)
ADDITIONS_PER_STATE = 9 * 62 + 8 * 12 + 22 * (1 + 11 + 12)
INT32_INSTR_PER_STATE = PRODUCTS_PER_STATE * 20 + ADDITIONS_PER_STATE * 6  # 21,812
INT32_LANES_PER_SM = 64
HBM_BYTES_PER_S = 3.35e12
BYTES_PER_STATE = 2 * 12 * 8


def max_sm_clock_hz() -> float:
    """the card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()
    return float(out[0]) * 1e6


def int32_per_s(sm_count: int, clock_hz: float) -> float:
    return sm_count * INT32_LANES_PER_SM * clock_hz


def permutation_bound_s(states: int, sm_count: int, clock_hz: float) -> float:
    """least seconds for `states` independent permutations."""
    ops = states * INT32_INSTR_PER_STATE / int32_per_s(sm_count, clock_hz)
    return max(ops, states * BYTES_PER_STATE / HBM_BYTES_PER_S)


def chain_bound_s(executed_rows: int, rows: int, segments: int, sm_count: int,
                  clock_hz: float) -> float:
    """least seconds for segmented chains: a permutation an executed row; 65
    bytes a row and 96 a boundary and landing state moved once."""
    ops = executed_rows * INT32_INSTR_PER_STATE / int32_per_s(sm_count, clock_hz)
    return max(ops, (rows * 65 + (2 * segments + 1) * 96) / HBM_BYTES_PER_S)
