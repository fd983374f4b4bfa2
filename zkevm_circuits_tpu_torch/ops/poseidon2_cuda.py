"""The hand-written CUDA Poseidon2 kernels (`csrc/poseidon2.cu`, which includes
`csrc/poseidon2_coop.cuh`).

Built at first use with nvcc for sm_90a into `csrc/build/` (listed in
.gitignore) and loaded with ctypes.  The round constants are copied into the
kernels' __constant__ memory once, from `utils/grain.py` through
`ops/poseidon2.py`, as `gl_poseidon2_init` does for the C++ runtime.

Three kernels, each with its own launch count on `KERNEL`:

* the thread-per-state permutation (`KERNEL.launches`), for batches of
  `SMALL_BATCH` states and more;
* the lane-parallel small-batch permutation (`KERNEL.small_launches`), one
  state spread over 4 threads of a warp, for batches below
  `SMALL_BATCH`: `permutation_cuda` picks between the two by batch size only,
  and both give the same bits;
* the fused segmented sponge chain (`KERNEL.chain_launches`), which keeps a
  segment's state in registers over all its steps: `chain_segmented_cuda`.

Every wrapper takes CUDA int64 tensors, launches on torch's current stream
and does not synchronise.  A failed build, a refused launch or a wrong tensor
raises; nothing falls back to the plain torch version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import poseidon2

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "poseidon2.cu")
_SOURCES = (_SRC, os.path.join(_CSRC, "poseidon2_coop.cuh"))
_BUILD_DIR = os.path.join(_CSRC, "build")
_LIB = os.path.join(_BUILD_DIR, "libzk_poseidon2.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# Which kernel takes a batch of n states, from the times that
# scripts/bench_poseidon2_kernels.py measured on an H100 (PERF.md): the
# lane-parallel kernel below SMALL_BATCH, the thread-per-state kernel from
# there on.
SMALL_BATCH = 1 << 14


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; cannot build csrc/poseidon2.cu")


def build(verbose: bool = False) -> str:
    """Compile csrc/poseidon2.cu (with its header) into the shared library if it
    is missing or older than a source; returns the library path.  Raises with
    the compiler's output when nvcc fails; `verbose` prints what ptxas reports
    (registers, spills) for each kernel."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= max(map(os.path.getmtime, _SOURCES)):
        return _LIB
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) + ["-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, _LIB)
    return _LIB


class Poseidon2Kernel:
    """The loaded library, its constant upload, and the launch counts."""

    def __init__(self):
        self.launches = 0        # thread-per-state permutation
        self.small_launches = 0  # lane-parallel small-batch permutation
        self.chain_launches = 0  # fused segmented chain
        self._lib: Optional[ctypes.CDLL] = None
        self._device: Optional[torch.device] = None
        self._lock = threading.Lock()

    def counts(self) -> dict:
        return dict(permutation=self.launches, permutation_small=self.small_launches,
                    chain_segmented=self.chain_launches)

    def reset_counts(self) -> None:
        self.launches = self.small_launches = self.chain_launches = 0

    def lib(self, device: torch.device) -> ctypes.CDLL:
        """Build and load once; the constants go to `device` (one card)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build())
                vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
                lib.zk_poseidon2_init.argtypes = [vp, vp, vp]
                lib.zk_poseidon2_permute.argtypes = [vp, vp, ll, vp]
                lib.zk_poseidon2_permute_small.argtypes = [vp, vp, ll, vp]
                lib.zk_poseidon2_chain_segmented.argtypes = [vp] * 8 + [ci, ll, ll, vp]
                for fn in (lib.zk_poseidon2_init, lib.zk_poseidon2_permute,
                           lib.zk_poseidon2_permute_small, lib.zk_poseidon2_chain_segmented):
                    fn.restype = ci
                ext = np.ascontiguousarray(poseidon2.EXT_RC, dtype=np.uint64)
                intr = np.ascontiguousarray(poseidon2.INT_RC, dtype=np.uint64)
                mu_m1 = np.ascontiguousarray(poseidon2.MU_MINUS_1, dtype=np.uint64)
                with torch.cuda.device(device):
                    err = lib.zk_poseidon2_init(
                        ext.ctypes.data, intr.ctypes.data, mu_m1.ctypes.data
                    )
                if err != 0:
                    raise RuntimeError(f"zk_poseidon2_init failed: cudaError_t {err}")
                self._lib = lib
                self._device = device
        if device != self._device:
            raise ValueError(f"kernel constants live on {self._device}, not {device}")
        return self._lib

    def permute(self, state: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
        who = "permutation_cuda"
        _check_dtype(who, "states", state, torch.int64)
        if state.dim() == 0 or state.shape[-1] != poseidon2.WIDTH:
            raise ValueError(f"{who} needs shape (..., 12), got {tuple(state.shape)}")
        _check_contiguous(who, "states", state)
        _check_on_card(who, "states", state)
        if route not in (None, "thread", "small"):
            raise ValueError(f"route must be None, 'thread' or 'small', got {route!r}")
        lib = self.lib(state.device)
        out = torch.empty_like(state)
        n = state.numel() // poseidon2.WIDTH
        if n == 0:
            return out
        if route is None:
            route = "small" if n < SMALL_BATCH else "thread"
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream(state.device).cuda_stream
            if route == "small":
                err = lib.zk_poseidon2_permute_small(state.data_ptr(), out.data_ptr(), n, stream)
            else:
                err = lib.zk_poseidon2_permute(state.data_ptr(), out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"poseidon2 {route} kernel launch failed: cudaError_t {err}")
        if route == "small":
            self.small_launches += 1
        else:
            self.launches += 1
        return out

    def chain_segmented(
        self, chains: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    ) -> List[torch.Tensor]:
        if len(chains) not in (1, 2):
            raise ValueError(f"chain_segmented_cuda takes one or two chains, got {len(chains)}")
        who = "chain_segmented_cuda"
        shape = None
        for boundaries, encodings, execute in chains:
            _check_dtype(who, "boundaries", boundaries, torch.int64)
            _check_dtype(who, "encodings", encodings, torch.int64)
            _check_dtype(who, "execute", execute, torch.bool)
            if boundaries.dim() != 2 or boundaries.shape[1] != poseidon2.WIDTH \
                    or boundaries.shape[0] < 2:
                raise ValueError(f"{who} needs boundaries of shape (S + 1, 12), "
                                 f"got {tuple(boundaries.shape)}")
            n = encodings.shape[0]
            if encodings.dim() != 2 or encodings.shape[1] != poseidon2.RATE:
                raise ValueError(f"{who} needs encodings of shape (n, 8), "
                                 f"got {tuple(encodings.shape)}")
            if tuple(execute.shape) != (n,):
                raise ValueError(f"{who} needs execute of shape ({n},), "
                                 f"got {tuple(execute.shape)}")
            segments = boundaries.shape[0] - 1
            if n == 0 or n % segments:
                raise ValueError(f"{segments} segments do not divide {n} rows")
            if shape not in (None, (segments, n)):
                raise ValueError(f"{who} needs two chains of one shape, got "
                                 f"{shape} and {(segments, n)}")
            shape = (segments, n)
        named = [(name, x) for chain in chains
                 for name, x in zip(("boundaries", "encodings", "execute"), chain)]
        for name, x in named:
            _check_contiguous(who, name, x)
        for name, x in named:
            _check_on_card(who, name, x)
            if x.device != chains[0][0].device:
                raise ValueError(f"{who} needs all tensors on one card")
        segments, n = shape
        device = chains[0][0].device
        lib = self.lib(device)
        landing = [torch.empty((segments, poseidon2.WIDTH), dtype=torch.int64, device=device)
                   for _ in chains]
        args = []
        for (boundaries, encodings, execute), out in zip(chains, landing):
            args += [boundaries.data_ptr(), encodings.data_ptr(), execute.data_ptr(),
                     out.data_ptr()]
        args += [None] * (8 - len(args))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.zk_poseidon2_chain_segmented(
                *args, len(chains), segments, n // segments, stream)
        if err != 0:
            raise RuntimeError(f"poseidon2 chain kernel launch failed: cudaError_t {err}")
        self.chain_launches += 1
        return landing


def _check_dtype(who: str, name: str, x: torch.Tensor, dtype: torch.dtype) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{who} needs {dtype} {name}, got {x.dtype}")


def _check_contiguous(who: str, name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{who} needs a contiguous tensor, {name} is not")


def _check_on_card(who: str, name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{who} needs a CUDA tensor, got {name} on {x.device}")


KERNEL = Poseidon2Kernel()


def permutation_cuda(state: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
    """Poseidon2 permutation of a CUDA (..., 12) int64 tensor: by the
    lane-parallel kernel below `SMALL_BATCH` states, by the thread-per-state
    kernel from there on.  `route` ("thread" or "small") names a kernel
    outright, for the checks and timings that hold one against the other."""
    return KERNEL.permute(state, route)


def chain_segmented_cuda(
    chains: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
) -> List[torch.Tensor]:
    """Landing states of one or two segmented full-state sponge chains, one
    kernel launch for all of them.

    Each chain is (boundaries (S + 1, 12) int64, encodings (n, 8) int64,
    execute (n,) bool) on the card, contiguous, S | n; two chains have the same
    S and n.  Segment s starts from boundaries[s] and absorbs its n / S
    encodings in order, skipping the rows that are not executed.  Returns a
    (S, 12) int64 tensor for each chain."""
    return KERNEL.chain_segmented(chains)
