"""The hand-written CUDA Poseidon2 permutation (`csrc/poseidon2.cu`).

Built at first use with nvcc for sm_90a into `csrc/build/` (listed in
.gitignore) and loaded with ctypes.  The round constants are copied into the
kernel's __constant__ memory once, from `utils/grain.py` through
`ops/poseidon2.py`, as `gl_poseidon2_init` does for the C++ runtime.

`permutation_cuda` takes a CUDA int64 tensor of shape (..., 12), launches
on torch's current stream and counts its launches in `KERNEL.launches`.
A failed build, a refused launch or a wrong tensor raises; nothing falls
back to the plain torch version.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np
import torch

from . import poseidon2

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SRC = os.path.join(_CSRC, "poseidon2.cu")
_BUILD_DIR = os.path.join(_CSRC, "build")
_LIB = os.path.join(_BUILD_DIR, "libzk_poseidon2.so")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]


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
    """Compile csrc/poseidon2.cu into the shared library if it is missing or
    older than the source; returns the library path.  Raises with the
    compiler's output when nvcc fails."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
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
    """The loaded library, its constant upload, and the launch count."""

    def __init__(self):
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._device: Optional[torch.device] = None
        self._lock = threading.Lock()

    def lib(self, device: torch.device) -> ctypes.CDLL:
        """Build and load once; the constants go to `device` (one card)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(build())
                vp = ctypes.c_void_p
                lib.zk_poseidon2_init.argtypes = [vp, vp, vp]
                lib.zk_poseidon2_init.restype = ctypes.c_int
                lib.zk_poseidon2_permute.argtypes = [vp, vp, ctypes.c_longlong, vp]
                lib.zk_poseidon2_permute.restype = ctypes.c_int
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

    def permute(self, state: torch.Tensor) -> torch.Tensor:
        if state.device.type != "cuda":
            raise ValueError(f"permutation_cuda needs a CUDA tensor, got {state.device}")
        if state.dtype != torch.int64:
            raise TypeError(f"permutation_cuda needs int64 states, got {state.dtype}")
        if state.dim() == 0 or state.shape[-1] != poseidon2.WIDTH:
            raise ValueError(f"permutation_cuda needs shape (..., 12), got {tuple(state.shape)}")
        if not state.is_contiguous():
            raise ValueError("permutation_cuda needs a contiguous tensor")
        lib = self.lib(state.device)
        out = torch.empty_like(state)
        n = state.numel() // poseidon2.WIDTH
        if n == 0:
            return out
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream(state.device).cuda_stream
            err = lib.zk_poseidon2_permute(state.data_ptr(), out.data_ptr(), n, stream)
        if err != 0:
            raise RuntimeError(f"poseidon2 kernel launch failed: cudaError_t {err}")
        self.launches += 1
        return out


KERNEL = Poseidon2Kernel()


def permutation_cuda(state: torch.Tensor) -> torch.Tensor:
    """Poseidon2 permutation of a CUDA (..., 12) int64 tensor by the kernel."""
    return KERNEL.permute(state)
