"""ctypes front end over the native host runtime (native/gl_runtime.cpp and
native/eravm.cpp), for the torch port.

The sequential sponge chains of witness generation run here as scalar C++
on the host.  The library is built with g++ at first use into
`native/build/libgl_runtime_torch.so` (a name of its own, so that it never
races the JAX package's build of the same sources), through a temporary
file with a pid suffix.  The Poseidon2 constants are taken from
`utils/grain.py`, so the instance has a single source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops.gf import MODULUS
from ..utils.grain import poseidon2_goldilocks_constants

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRCS = [
    os.path.join(_REPO_ROOT, "native", "gl_runtime.cpp"),
    os.path.join(_REPO_ROOT, "native", "eravm.cpp"),
]
_BUILD_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB = os.path.join(_BUILD_DIR, "libgl_runtime_torch.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    newest = max(os.path.getmtime(s) for s in _SRCS)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= newest:
        return _LIB
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-funroll-loops",
        "-shared", "-fPIC", "-fopenmp", "-o", tmp,
    ] + _SRCS
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            u64p = ctypes.POINTER(ctypes.c_uint64)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64 = ctypes.c_int64
            lib.gl_poseidon2_init.argtypes = [u64p, u64p, u64p]
            lib.gl_poseidon2_init.restype = None
            lib.gl_poseidon2_permute.argtypes = [u64p]
            lib.gl_poseidon2_permute.restype = None
            lib.gl_poseidon2_permute_batch.argtypes = [u64p, i64]
            lib.gl_poseidon2_permute_batch.restype = None
            lib.gl_full_state_chain.argtypes = [u64p, u64p, u8p, u64p, i64]
            lib.gl_full_state_chain.restype = None
            lib.gl_narrow_chain.argtypes = [u64p, u64p, u8p, u64p, i64, i64]
            lib.gl_narrow_chain.restype = None
            lib.gl_narrow_chains.argtypes = [u64p, u64p, u8p, u64p, i64, i64, i64]
            lib.gl_narrow_chains.restype = None
            # eravm_run's struct arguments are declared by models/vm/native_sim.py
            lib.gl_full_state_chains.argtypes = [u64p, u64p, u8p, u64p, i64, i64]
            lib.gl_full_state_chains.restype = None
            lib.gl_full_state_chains_strided.argtypes = [u64p, u64p, u8p, u64p, i64, i64, i64]
            lib.gl_full_state_chains_strided.restype = None
            ext, intr, mu = poseidon2_goldilocks_constants(MODULUS, 12, 8, 22)
            ext = np.ascontiguousarray(ext, dtype=np.uint64).reshape(-1)
            intr = np.ascontiguousarray(intr, dtype=np.uint64)
            mu = np.ascontiguousarray(mu, dtype=np.uint64)
            lib.gl_poseidon2_init(_u64p(ext), _u64p(intr), _u64p(mu))
            _lib = lib
    return _lib


def _u64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8p(a: Optional[np.ndarray]):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _chain_args(encodings, execute, init):
    enc = np.ascontiguousarray(encodings, dtype=np.uint64)
    if enc.ndim != 3 or enc.shape[2] != 8:
        raise ValueError(f"encodings must be (K, n, 8), got {enc.shape}")
    k, n = enc.shape[0], enc.shape[1]
    ex = None
    if execute is not None:
        ex = np.ascontiguousarray(execute, dtype=np.uint8)
        if ex.shape != (k, n):
            raise ValueError(f"execute must be {(k, n)}, got {ex.shape}")
    ini = np.ascontiguousarray(init, dtype=np.uint64)
    if ini.shape != (k, 12):
        raise ValueError(f"init must be {(k, 12)}, got {ini.shape}")
    return enc, ex, ini, k, n


def _execute_arg(execute, shape):
    if execute is None:
        return None
    ex = np.ascontiguousarray(execute, dtype=np.uint8)
    if ex.shape != shape:
        raise ValueError(f"execute must be {shape}, got {ex.shape}")
    return ex


def poseidon2_permute(state: np.ndarray) -> np.ndarray:
    """one permutation: (12,) u64 -> (12,) u64."""
    lib = get_lib()
    out = np.ascontiguousarray(state, dtype=np.uint64).copy()
    if out.shape != (12,):
        raise ValueError(f"state must be (12,), got {out.shape}")
    lib.gl_poseidon2_permute(_u64p(out))
    return out


def poseidon2_permute_batch(states: np.ndarray) -> np.ndarray:
    """(B, 12) u64 -> permuted (B, 12) u64."""
    lib = get_lib()
    out = np.ascontiguousarray(states, dtype=np.uint64).copy()
    if out.ndim != 2 or out.shape[1] != 12:
        raise ValueError(f"states must be (B, 12), got {out.shape}")
    lib.gl_poseidon2_permute_batch(_u64p(out), out.shape[0])
    return out


def full_state_chains(encodings, execute, init) -> np.ndarray:
    """K full-state sponge chains: encodings (K, n, 8), init (K, 12) ->
    every state, (K, n + 1, 12)."""
    lib = get_lib()
    enc, ex, ini, k, n = _chain_args(encodings, execute, init)
    out = np.empty((k, n + 1, 12), dtype=np.uint64)
    lib.gl_full_state_chains(_u64p(out), _u64p(enc), _u8p(ex), _u64p(ini), k, n)
    return out


def full_state_chains_strided(encodings, execute, init, stride: int) -> np.ndarray:
    """K chains, boundary states only: (K, n, 8) -> (K, n / stride + 1, 12)."""
    lib = get_lib()
    enc, ex, ini, k, n = _chain_args(encodings, execute, init)
    if stride <= 0 or n % stride:
        raise ValueError(f"stride {stride} must divide n = {n}")
    out = np.empty((k, n // stride + 1, 12), dtype=np.uint64)
    lib.gl_full_state_chains_strided(_u64p(out), _u64p(enc), _u8p(ex), _u64p(ini), k, n, stride)
    return out


def full_state_chain(encodings, execute, init) -> np.ndarray:
    """One full-state chain: encodings (n, 8), execute (n,) or None,
    init (12,) -> every state, (n + 1, 12)."""
    lib = get_lib()
    enc = np.ascontiguousarray(encodings, dtype=np.uint64)
    if enc.ndim != 2 or enc.shape[1] != 8:
        raise ValueError(f"encodings must be (n, 8), got {enc.shape}")
    n = enc.shape[0]
    ex = _execute_arg(execute, (n,))
    ini = np.ascontiguousarray(init, dtype=np.uint64)
    if ini.shape != (12,):
        raise ValueError(f"init must be (12,), got {ini.shape}")
    out = np.empty((n + 1, 12), dtype=np.uint64)
    lib.gl_full_state_chain(_u64p(out), _u64p(enc), _u8p(ex), _u64p(ini), n)
    return out


def narrow_chains(encodings, execute, init) -> np.ndarray:
    """K narrow (4-lane) chains: encodings (K, n, L), execute (K, n) or
    None, init (K, 4) -> (K, n + 1, 4)."""
    lib = get_lib()
    enc = np.ascontiguousarray(encodings, dtype=np.uint64)
    if enc.ndim != 3:
        raise ValueError(f"encodings must be (K, n, L), got {enc.shape}")
    k, n, enc_len = enc.shape
    ex = _execute_arg(execute, (k, n))
    ini = np.ascontiguousarray(init, dtype=np.uint64)
    if ini.shape != (k, 4):
        raise ValueError(f"init must be {(k, 4)}, got {ini.shape}")
    out = np.empty((k, n + 1, 4), dtype=np.uint64)
    lib.gl_narrow_chains(_u64p(out), _u64p(enc), _u8p(ex), _u64p(ini), k, n, enc_len)
    return out


def narrow_chain(encodings, execute, init) -> np.ndarray:
    """One narrow chain: encodings (n, L), init (4,) -> (n + 1, 4)."""
    lib = get_lib()
    enc = np.ascontiguousarray(encodings, dtype=np.uint64)
    if enc.ndim != 2:
        raise ValueError(f"encodings must be (n, L), got {enc.shape}")
    n, enc_len = enc.shape
    ex = _execute_arg(execute, (n,))
    ini = np.ascontiguousarray(init, dtype=np.uint64)
    if ini.shape != (4,):
        raise ValueError(f"init must be (4,), got {ini.shape}")
    out = np.empty((n + 1, 4), dtype=np.uint64)
    lib.gl_narrow_chain(_u64p(out), _u64p(enc), _u8p(ex), _u64p(ini), n, enc_len)
    return out
