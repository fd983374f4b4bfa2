"""Poseidon2 Merkle trees with caps.

Each level is one batched 2-to-1 compression over the whole level: the
width-12 permutation maps [left(4) | right(4) | zeros(4)] to lanes 0..3.
The top 2^cap_log2 nodes are the commitment.

  leaf_hashes = hash_leaves(rows)           (n, L) -> (n, 4)
  levels      = tree_levels(leaf_hashes, cap_log2); levels[-1] is the cap
  ok          = verify_path(leaf_hash, index, path, cap)   (batched)
"""

from __future__ import annotations

import torch

from . import gf, poseidon2

DIGEST = 4


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    batch = left.shape[:-1]
    st = torch.cat([left, right, gf.zeros(batch + (4,), left.device)], dim=-1)
    return poseidon2.permutation(st)[..., :DIGEST]


def hash_leaves(rows: torch.Tensor) -> torch.Tensor:
    """(n, L) leaf payloads -> (n, 4) digests (length-specialized sponge)."""
    return poseidon2.hash_padded(rows, length_specialize=True)


def tree_levels(leaf_hashes: torch.Tensor, cap_log2: int):
    """[leaves, level 1, ..., cap]; the cap has 2^cap_log2 nodes."""
    n = leaf_hashes.shape[0]
    log_n = int(n).bit_length() - 1
    if 1 << log_n != n or cap_log2 > log_n:
        raise ValueError(f"{n} leaves cannot make a tree with a cap of 2^{cap_log2}")
    levels = [leaf_hashes]
    cur = leaf_hashes
    for _ in range(log_n - cap_log2):
        pairs = cur.reshape(cur.shape[0] // 2, 2, DIGEST)
        cur = compress(pairs[:, 0], pairs[:, 1])
        levels.append(cur)
    return levels


def commit(leaf_hashes: torch.Tensor, cap_log2: int) -> torch.Tensor:
    return tree_levels(leaf_hashes, cap_log2)[-1]


def verify_path(leaf_hash: torch.Tensor, index: torch.Tensor, path: torch.Tensor,
                cap: torch.Tensor) -> torch.Tensor:
    """Recompute the cap node from leaf digests (..., 4), leaf indices (...,)
    and sibling paths (..., depth, 4); True where it equals the cap's."""
    depth = path.shape[-2]
    idx = index.to(torch.int64)
    cur = leaf_hash
    for d in range(depth):
        sib = path[..., d, :]
        bit = ((idx >> d) & 1).bool().unsqueeze(-1)
        cur = compress(torch.where(bit, sib, cur), torch.where(bit, cur, sib))
    expected = cap[idx >> depth]
    return (cur == expected).all(dim=-1)
