"""zkevm_circuits_tpu_torch — the PyTorch and CUDA port of zkevm_circuits_tpu.

Same layout as the JAX package, so each module's counterpart is easy to
find.  Field elements are int64 tensors holding the canonical u64 bit
pattern; the Poseidon2 permutation on a CUDA tensor runs a hand-written
kernel (csrc/poseidon2.cu).  This package imports neither jax nor the JAX
package.  Entry points that build tensors from host data take `device=None`,
which is the first CUDA card (`utils/device.py`) and an error without one.

Layout:
    ops/              field, GF(p^2), Poseidon2 (+ CUDA kernel), queue chains,
                      non-native arithmetic checks, NTT, Merkle, FRI
    prover/           the DEEP-ALI STARK and the grand-product pipeline
    models/           ram_permutation: witness, constraint evaluation, compact forms
    models/vm/        main_vm: native EraVM witness oracle, constraint evaluation
    base_structures/  memory, log and decommit query packing
    isa/              EraVM opcode tables and system parameters (host, numpy)
    utils/            device rule, Fiat-Shamir challenges, grand products, the
                      ClosedFormInput protocol, Grain constants, bench tapes,
                      conversions
    runtime/          ctypes front end over native/gl_runtime.cpp and eravm.cpp
    csrc/             CUDA sources
"""

__version__ = "0.1.0"
