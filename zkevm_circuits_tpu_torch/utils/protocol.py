"""The ClosedFormInput multi-instance continuation protocol (the JAX
package's `utils/protocol.py`).

Every circuit instance's interface is a `ClosedFormInput{start_flag,
completion_flag, observable_input, observable_output, hidden_fsm_input,
hidden_fsm_output}`; the compact form commits each part to 4 field elements
with these masking rules:

  * the fsm_input commitment is zeroed when start_flag is set;
  * the observable_output commitment is zeroed unless completion_flag is set;
  * the fsm_output commitment is zeroed when completion_flag is set;
  * the observable_input commitment is never masked.

Commitments use the Poseidon2 sponge with zero padding and length
specialization, `poseidon2.hash_padded`.  The compact form itself encodes to
18 elements (2 flags + 4 x 4 lanes) and is committed the same way.
Everything is batch-parallel: commitments for many instances at once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import gf, poseidon2

CLOSED_FORM_COMMITMENT_LENGTH = 4
INPUT_OUTPUT_COMMITMENT_LENGTH = 4
COMPACT_FORM_ENCODING_LENGTH = 2 + 4 * CLOSED_FORM_COMMITMENT_LENGTH  # 18


def commit_encoding(encoding: torch.Tensor) -> torch.Tensor:
    """Commit a variable-length encoding (..., L) to 4 lanes."""
    return poseidon2.hash_padded(encoding, length_specialize=True)


def bool_to_gf(flag: torch.Tensor) -> torch.Tensor:
    """bool tensor -> 0/1 field elements."""
    return gf.from_u32(flag)


@dataclasses.dataclass(frozen=True)
class ClosedFormInputCompactForm:
    """4-lane commitments per part, and the two flags."""

    start_flag: torch.Tensor  # (...,) bool
    completion_flag: torch.Tensor  # (...,) bool
    observable_input_commitment: torch.Tensor  # (..., 4)
    observable_output_commitment: torch.Tensor  # (..., 4)
    hidden_fsm_input_commitment: torch.Tensor  # (..., 4)
    hidden_fsm_output_commitment: torch.Tensor  # (..., 4)

    def encode(self) -> torch.Tensor:
        """18-element encoding: the flags, then the 4 commitments."""
        return torch.cat(
            [
                bool_to_gf(self.start_flag).unsqueeze(-1),
                bool_to_gf(self.completion_flag).unsqueeze(-1),
                self.observable_input_commitment,
                self.observable_output_commitment,
                self.hidden_fsm_input_commitment,
                self.hidden_fsm_output_commitment,
            ],
            dim=-1,
        )

    def commitment(self) -> torch.Tensor:
        """The per-instance 4-lane commitment the scheduler queues up."""
        return commit_encoding(self.encode())


def compact_form_from_parts(
    start_flag: torch.Tensor,
    completion_flag: torch.Tensor,
    observable_input_encoding: torch.Tensor,
    observable_output_encoding: torch.Tensor,
    hidden_fsm_input_encoding: torch.Tensor,
    hidden_fsm_output_encoding: torch.Tensor,
) -> ClosedFormInputCompactForm:
    """Commit each part and apply the masking rules."""
    obs_in = commit_encoding(observable_input_encoding)
    obs_out = commit_encoding(observable_output_encoding)
    fsm_in = commit_encoding(hidden_fsm_input_encoding)
    fsm_out = commit_encoding(hidden_fsm_output_encoding)

    zero = torch.zeros_like(obs_in)
    start_mask = start_flag.unsqueeze(-1)
    complete_mask = completion_flag.unsqueeze(-1)
    return ClosedFormInputCompactForm(
        start_flag=start_flag,
        completion_flag=completion_flag,
        observable_input_commitment=obs_in,
        observable_output_commitment=gf.select(complete_mask, obs_out, zero),
        hidden_fsm_input_commitment=gf.select(start_mask, zero, fsm_in),
        hidden_fsm_output_commitment=gf.select(complete_mask, zero, fsm_out),
    )


def input_output_commitment(compact: ClosedFormInputCompactForm) -> torch.Tensor:
    """The circuit's 4 public inputs: the commitment of the compact form."""
    return compact.commitment()


def single_instance_compact_form(
    observable_input_encoding: torch.Tensor,
    observable_output_encoding: torch.Tensor,
    hidden_fsm_encoding: Optional[torch.Tensor] = None,
) -> ClosedFormInputCompactForm:
    """Compact form of a circuit that runs as ONE instance (start and
    completion both set, so both hidden FSM commitments are zeroed whatever
    the payload)."""
    batch = tuple(observable_input_encoding.shape[:-1])
    dev = observable_input_encoding.device
    if hidden_fsm_encoding is None:
        hidden_fsm_encoding = gf.zeros(batch + (0,), dev)
    t = torch.ones(batch, dtype=torch.bool, device=dev)
    return compact_form_from_parts(
        t, t, observable_input_encoding, observable_output_encoding,
        hidden_fsm_encoding, hidden_fsm_encoding,
    )


def encode_queue_state_generic(head: torch.Tensor, tail: torch.Tensor, length) -> torch.Tensor:
    """[head lanes, tail lanes, length]: the QueueState encoding.  `length`
    is a python int or an int64 tensor of the batch shape (u32 values)."""
    if not isinstance(length, torch.Tensor):
        length = torch.full(tuple(head.shape[:-1]), int(length), dtype=torch.int64,
                            device=head.device)
    return torch.cat([head, tail, gf.from_u32(length).unsqueeze(-1)], dim=-1)


def result_queue_state_at(result_chain: torch.Tensor, result_count: torch.Tensor,
                          bounds: torch.Tensor, total: int) -> torch.Tensor:
    """The encoded state of a sorter's result queue after `bounds` rows of
    `total` (head zeros): the chain state at the boundary, the count of pushes
    before it; at the end the finalization push is included (state `total` +
    1, count `total`), the JAX package's indices."""
    at_end = bounds == total
    res_len = torch.where(
        bounds == 0, torch.zeros_like(bounds),
        result_count[torch.where(at_end, bounds, (bounds - 1).clamp(min=0))],
    )
    head = gf.zeros(tuple(bounds.shape) + (result_chain.shape[-1],), bounds.device)
    return encode_queue_state_generic(head, result_chain[torch.where(at_end, bounds + 1, bounds)],
                                      res_len)


def check_instance_chaining(
    start_flags: torch.Tensor,
    completion_flags: torch.Tensor,
    fsm_input_commitments: torch.Tensor,
    fsm_output_commitments: torch.Tensor,
) -> dict:
    """Scheduler-side chaining invariants over an instance sequence (dim 0):
      * start_flag[0] is True;
      * start_flag[k+1] == completion_flag[k];
      * fsm_output_commitment[k] == fsm_input_commitment[k+1] where the
        next instance continues.
    Returns a dict of bool tensors that must all be True."""
    chained = start_flags[1:] == completion_flags[:-1]
    fsm_match = gf.equal(fsm_output_commitments[:-1], fsm_input_commitments[1:]).all(-1)
    return {
        "first_starts": start_flags[0],
        "chained": chained,
        "fsm_handoff": fsm_match | start_flags[1:],
    }
