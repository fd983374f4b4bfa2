"""Multi-block chain driver + interblock aggregation (the JAX package's
`runtime/chain.py`).

Runs N blocks through `execute_block2`, threading state the way the
reference system chains blocks:

  * each block's scheduler public input binds `previous_block_content_hash`
    (ref scheduler/mod.rs:1237-1281) — block k+1 gets block k's content hash;
  * the storage state carries over: block k+1's initial storage (and the
    storage_application tree seed) is block k's final storage;
  * the per-block scheduler public inputs land in the FIXED-capacity
    interblock keccak aggregator with invalid-slot masking
    (ref interblock/keccak_aggregator.rs:5-96).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..models import recursion
from ..ops import gf
from ..utils.device import resolve_device
from .block2 import Block2Config, Block2Result, execute_block2


@dataclasses.dataclass
class ChainResult:
    blocks: List[Block2Result]
    content_hashes: List[bytes]
    aggregated_input: bytes  # interblock keccak over the block public inputs

    @property
    def ok(self) -> bool:
        return all(b.ok for b in self.blocks)


def execute_chain(
    block_specs: List[dict],
    config: Block2Config = Block2Config(),
    aggregator_capacity: int = 4,
    initial_storage: Optional[dict] = None,
    device=None,
) -> ChainResult:
    """block_specs: per-block kwargs for execute_block2 minus `storage` and
    `previous_block_content_hash` (both threaded here).  Each spec must
    carry `code`; `code_store`/`calldata`/`bootloader_heap`/`registers`
    are optional.  `device` (None: the card) is where every block runs."""
    device = resolve_device(device)
    assert len(block_specs) <= aggregator_capacity
    storage = dict(initial_storage or {})
    prev_hash = b"\x00" * 32
    results: List[Block2Result] = []
    hashes: List[bytes] = []
    public_inputs = []
    for spec in block_specs:
        spec = dict(spec)
        code = spec.pop("code")
        res = execute_block2(
            code,
            config,
            storage=storage,
            previous_block_content_hash=prev_hash,
            device=device,
            **spec,
        )
        results.append(res)
        prev_hash = res.scheduler_result.block_content_hash
        hashes.append(prev_hash)
        public_inputs.append(res.scheduler_result.public_input)
        # the next block starts from this block's final storage state
        storage = dict(res.vm.storage)

    # fixed-capacity aggregation: empty slots masked invalid
    n = len(public_inputs)
    slots = public_inputs + [gf.zeros((4,), device)] * (aggregator_capacity - n)
    valid = [True] * n + [False] * (aggregator_capacity - n)
    aggregated = recursion.interblock_aggregate_keccak(slots, valid)
    return ChainResult(
        blocks=results, content_hashes=hashes, aggregated_input=aggregated
    )
