"""The names the benchmark's process may not hold: JAX and the JAX package.

Compared by whole top-level name (the part before the first dot): the port,
`zkevm_circuits_tpu_torch`, begins with the JAX package's name and is not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "zkevm_circuits_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(names) -> list:
    """the forbidden top-level names among module names."""
    return sorted({top_level(n) for n in names} & FORBIDDEN)


def loaded_forbidden() -> list:
    return forbidden(list(sys.modules))
