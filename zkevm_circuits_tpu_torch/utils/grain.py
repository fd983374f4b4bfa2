"""Grain-LFSR pseudo-random constant generation for Poseidon/Poseidon2.

The torch port's own copy of the JAX package's `utils/grain.py` (the port
imports nothing of that package); tests/test_torch_copies.py holds the two
equal by value.

The reference stack pins its Poseidon2-Goldilocks round constants inside the
external `boojum` crate (consumed as `CircuitRoundFunction<F, 8, 12, 4>`,
SURVEY.md §2.3).  boojum's constant tables are not available in this
environment (zero egress), so this framework pins its own Poseidon2 instance
whose constants are generated by the *standard* Grain-LFSR procedure from the
Poseidon reference specification (GrassiKRRS19, appendix; same generator the
Poseidon2 authors use).  The instance is frozen by golden tests; if bit-level
parity with a specific boojum build is later required, the constants are pure
data — swap the table, nothing structural changes.

Generator spec (verbatim from the Poseidon reference implementation):
  * 80-bit state seeded with: 2-bit field tag (GF(p)=1), 4-bit sbox tag
    (x^alpha=0), 12-bit field size n, 12-bit t, 10-bit R_F, 10-bit R_P,
    30 ones.
  * LFSR feedback: b_new = b62 ^ b51 ^ b38 ^ b23 ^ b13 ^ b0 (state shifts
    left by one, new bit appended).
  * First 160 output bits discarded.
  * Thereafter a shrinking step: generate bit pairs, emit the second bit of
    a pair only when the first is 1.
  * Field constants: assemble n MSB-first bits; rejection-sample values >= p.
"""

from __future__ import annotations

from typing import List


class GrainLFSR:
    def __init__(self, field_bits: int, t: int, r_f: int, r_p: int):
        bits: List[int] = []
        for value, width in (
            (1, 2),  # field tag: GF(p)
            (0, 4),  # sbox tag: x^alpha
            (field_bits, 12),
            (t, 12),
            (r_f, 10),
            (r_p, 10),
        ):
            bits.extend(int(b) for b in format(value, f"0{width}b"))
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new_bit)
        return new_bit

    def next_bit(self) -> int:
        # shrinking generator: (gate, payload) pairs
        while True:
            gate = self._next_raw()
            payload = self._next_raw()
            if gate == 1:
                return payload

    def next_field_element(self, modulus: int, field_bits: int) -> int:
        while True:
            v = 0
            for _ in range(field_bits):
                v = (v << 1) | self.next_bit()
            if v < modulus:
                return v


def poseidon2_goldilocks_constants(
    modulus: int, t: int = 12, r_f: int = 8, r_p: int = 22
):
    """Generate (external_rcs[r_f][t], internal_rcs[r_p], internal_diag[t]).

    External rounds take a full width-t constant vector; internal rounds add a
    single constant to lane 0 (Poseidon2 structure).  The internal-matrix
    diagonal mu is sampled from the same stream (nonzero, and mu_i != 1 so
    M_I = J + diag(mu - 1) stays non-degenerate per lane).
    """
    g = GrainLFSR(64, t, r_f, r_p)
    external = [
        [g.next_field_element(modulus, 64) for _ in range(t)] for _ in range(r_f)
    ]
    internal = [g.next_field_element(modulus, 64) for _ in range(r_p)]
    diag = []
    while len(diag) < t:
        v = g.next_field_element(modulus, 64)
        if v not in (0, 1):
            diag.append(v)
    return external, internal, diag
