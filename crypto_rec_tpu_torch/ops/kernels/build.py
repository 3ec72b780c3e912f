"""Build and load the hand-written Hopper kernels.

Every `csrc/*.cu` source is compiled by its own `nvcc` for `sm_90a`, all
started together, and the objects are linked into ONE shared library with
a plain C interface, loaded with `ctypes`.  The library's file
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
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # (x, proj, out, n, d, k, L, stream) -> cudaError_t
    "crt_signproj": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (slab, queries, scale, meta, item_tile, item_lo, item_cnt, dots,
    #  n_items, P, T, win, d, n_rows, mask, dtype, rt, m, stream)
    "crt_slab_tile_dots": (_P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (slab, queries, row0, pair, bounds, keys, vals, pos,
    #  P, q, T, win, d, n_rows, nbins, dtype, rt, stream)
    "crt_binned_tile_dots": (_P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (slab, queries, row0, pair, bounds, dots, P, T, win, d, n_rows, kind, rt, stream)
    "crt_tile_dots": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # (slab, row0, pair, bounds, pair_row0, out, fold,
    #  P, q, T, win, d, n_rows, dtype, rt, stream)
    "crt_tile_load_floor": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # (values, out_v, out_i, R, m, k, stream)
    "crt_window_topk": (_P, _P, _P, _I, _I, _I, _P),
    # (values, out_v, out_i, R, m, k, ldo, stream)
    "crt_window_topk_segments": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (values, out_v, out_i, scratch, R, m, k, P2, stream)
    "crt_window_topk_large": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (q_ratings, q_known, q_mean, n_ratings, n_mean, sims, ids, valid, out,
    #  q, P, c, n, id_bytes, stream)
    "crt_cf_predict": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # (scores, ids, aligned, rows, out_s, out_i, kept,
    #  q, m, k, n_rows, id_bytes, T, n_pad, win, kk, stream)
    "crt_dedup_topk": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
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


def _check_run(rc: int, stdout: str, stderr: str, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed ({rc}):\n{stdout}\n{stderr}")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernel library, compiled on first use (raises on failure)."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile and link in a private directory, then rename: concurrent
        # builds never load a half-written library
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            nvcc = _nvcc()
            jobs = [
                (src, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o",
                     os.path.join(tmp, src.stem + ".o"), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
                for src in _sources() if src.suffix == ".cu"
            ]
            for src, job in jobs:
                stdout, stderr = job.communicate()
                _check_run(job.returncode, stdout, stderr, f"nvcc {src.name}")
            lib_tmp = os.path.join(tmp, out.name)
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp,
                 *(os.path.join(tmp, src.stem + ".o") for src, _ in jobs)],
                capture_output=True, text=True,
            )
            _check_run(res.returncode, res.stdout, res.stderr, "nvcc link")
            os.replace(lib_tmp, out)
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
