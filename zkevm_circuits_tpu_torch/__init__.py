"""zkevm_circuits_tpu_torch — the PyTorch and CUDA port of zkevm_circuits_tpu.

Same layout as the JAX package, so each module's counterpart is easy to
find.  Field elements are int64 tensors holding the canonical u64 bit
pattern; the Poseidon2 permutation on a CUDA tensor runs a hand-written
kernel (csrc/poseidon2.cu).  This package never imports jax.

Layout:
    ops/              field, GF(p^2), Poseidon2 (+ CUDA kernel), NTT, Merkle, FRI
    prover/           the DEEP-ALI STARK and the grand-product pipeline
    models/           ram_permutation witness generation
    base_structures/  memory-query packing
    utils/            Fiat-Shamir challenges, grand products, conversions
    runtime/          ctypes front end over native/gl_runtime.cpp
    csrc/             CUDA sources
"""

__version__ = "0.1.0"
