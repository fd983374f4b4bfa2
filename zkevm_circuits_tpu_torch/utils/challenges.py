"""Fiat-Shamir challenge derivation and grand-product accumulation.

Same semantics as the JAX package's `utils/challenges.py`:
  * fs_input = unsorted.tail ++ [unsorted.length] ++ sorted.tail ++ [sorted.length]
  * sponge: empty state, length specialization with len(fs_input), absorb
    zero-padded rate-8 chunks with replacement, one permutation per chunk;
  * squeeze a (repetitions, challenges) matrix whose column 0 is ONE, the
    rest drawn from the rate lanes, re-permuting when 8 are used up;
  * factor[i, r] = challenges[r, ENC] + sum_j enc[i, j] * challenges[r, j].

`product_accumulate` is the running product.  torch has no associative
scan and `torch.cumprod` knows nothing of the field, so it is a log-depth
Hillis-Steele scan of Goldilocks multiplies.
"""

from __future__ import annotations

import torch

from ..ops import gf, poseidon2
from ..ops.queues import QueueState

DEFAULT_NUM_REPETITIONS = 2


def produce_fs_challenges(
    unsorted: QueueState,
    sorted_q: QueueState,
    num_challenges: int,
    num_repetitions: int = DEFAULT_NUM_REPETITIONS,
) -> torch.Tensor:
    """(num_repetitions, num_challenges) challenges; column 0 == 1."""
    dev = unsorted.tail.device
    fs_input = torch.cat([
        unsorted.tail,
        gf.constant(unsorted.length, dev).reshape(1),
        sorted_q.tail,
        gf.constant(sorted_q.length, dev).reshape(1),
    ])
    n = fs_input.shape[-1]
    state = poseidon2.apply_length_specialization(poseidon2.empty_state((), dev), n)
    padded = n + (-n) % poseidon2.RATE
    if padded != n:
        fs_input = torch.cat([fs_input, gf.zeros((padded - n,), dev)])
    for i in range(0, padded, poseidon2.RATE):
        state = poseidon2.absorb_round(fs_input[i : i + poseidon2.RATE], state)

    needed = num_repetitions * (num_challenges - 1)
    drawn = []
    while len(drawn) < needed:
        take = min(needed - len(drawn), poseidon2.RATE)
        drawn.extend(state[k] for k in range(take))
        if len(drawn) < needed:
            state = poseidon2.permutation(state)
    rows = []
    for rep in range(num_repetitions):
        cols = [gf.ones((), dev)]
        cols.extend(drawn[rep * (num_challenges - 1) : (rep + 1) * (num_challenges - 1)])
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def grand_product_factors(encodings: torch.Tensor, challenges: torch.Tensor) -> torch.Tensor:
    """encodings (n, ENC), challenges (R, ENC + 1) -> factors (n, R)."""
    enc_len = encodings.shape[-1]
    lin = challenges[..., :enc_len]  # (R, ENC)
    const = challenges[..., enc_len]  # (R,)
    prods = gf.mul(encodings.unsqueeze(-2), lin)  # (n, R, ENC)
    return gf.add(gf.sum_mod(prods, dim=-1), const)


def masked_factors(factors: torch.Tensor, should_accumulate: torch.Tensor) -> torch.Tensor:
    """factors where accumulated, 1 elsewhere."""
    return gf.select(should_accumulate.unsqueeze(-1), factors, torch.ones_like(factors))


def product_accumulate(factors: torch.Tensor, init: torch.Tensor) -> torch.Tensor:
    """Inclusive running product along dim 0, times `init`:
    out[i] = init * prod_{k <= i} factors[k]."""
    x = factors
    d = 1
    while d < x.shape[0]:
        x = torch.cat([x[:d], gf.mul(x[d:], x[:-d])])
        d *= 2
    return gf.mul(x, init)
