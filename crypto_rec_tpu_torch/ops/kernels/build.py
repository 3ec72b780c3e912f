"""Build and load the hand-written Hopper kernels.

Every `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into ONE shared
library with a plain C interface, loaded with `ctypes`.  The library's file
name carries a content hash of the sources and flags, so a stale build is
never loaded; the build happens at first use, from the checkout's sources
alone, into `build/torch_kernels/` at the repository root.

Nothing here runs at import time: CPU-only installs import the package and
never call `library()`.  A missing `nvcc` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (x, proj, out, n, d, k, L, stream) -> cudaError_t
    "crt_signproj": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (slab, queries, row0, head, size, dots, q, T, win, d, mask, dtype, stream)
    "crt_slab_window_dots": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


def _sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the Hopper kernels cannot be built")
    return cand


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcrt_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, compiled on first use (raises on failure)."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(p) for p in _sources() if p.suffix == ".cu"]
        # compile to a private name, then rename: concurrent builds never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu],
                capture_output=True, text=True,
            )
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
                )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
