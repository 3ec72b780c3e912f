#!/usr/bin/env python3
"""Where the tile-major probe kernels' time goes (csrc/probetile.cu).

No profiler on the card splits a kernel's time by phase, so this compiles
copies of probetile.cu with one phase cut out and times them against the
whole kernel in alternating rounds (CUDA events, medians), at the probes'
operating point (2M x 128 planted corpus, cosine k = 13, L = 8, window 488;
P3 binned top-1 on int8 slabs, nbins 128, q = 8,192; P6 int4, q = 32,768;
P2 rounded_query on bf16 slabs, P4 i8_dot on int8 slabs and P5 on blocked
int8 and bf16 slabs, q = 8,192):

- full:       the kernel as built for the port;
- no_epi:     no epilogue (P3's key combine, the others' dots writes);
- no_mma:     no tensor-core product (the epilogue writes zeros);
- loads_only: neither, nor the query staging: the sort, `tile_bounds`, each
              tile's loads and upcast, and the block's barriers.

The differences are what each phase adds where the others run too (they
overlap across the blocks of an SM, so they need not add up).  Each call
runs as the wrappers do, from the sort of the pairs on; the window
geometry is computed once, outside the timed calls.  The copies are built
into build/probetile_phases/.

    python3 tools/chip_probes/probetile_phases.py [--rounds 11]

Needs a CUDA device and nvcc.  Prints the card first.
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, ROOT)

from crypto_rec_tpu_torch.experiments import _common as C  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.index import pack_index  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels import build, int4slab  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.blkslab import B, _geometry_blk, to_blk  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.probetile import (  # noqa: E402
    BYTE_TILE_ROWS, KINDS, tile_queries, tile_schedule,
)
from crypto_rec_tpu_torch.ops.kernels.slabscore import (  # noqa: E402
    _DTYPE_CODE, _geometry, probe_tile_rows,
)
from crypto_rec_tpu_torch.ops.kernels.slabvariants import quantize_queries  # noqa: E402

EPI = "    for (int m = warp; m < cnt; m += kThreads / 32) {"
MMA = "    for (int kc = 0; kc < d / (K::i8 ? 32 : 16); ++kc) {"
QRY = "    if (slot < cnt) {"
CUT = {EPI: EPI.replace("cnt;", "cnt * 0;"), MMA: MMA.replace("d / (K::i8 ? 32 : 16);", "0;"),
       QRY: QRY.replace("(slot < cnt)", "(slot < cnt * 0)")}
VARIANTS = {"full": (), "no_epi": (EPI,), "no_mma": (MMA,), "loads_only": (EPI, QRY, MMA)}
NBINS = 128


def build_variants() -> dict:
    """-> {variant: ctypes library} built from cut copies of probetile.cu."""
    src = (build.CSRC / "probetile.cu").read_text()
    if not all(src.count(x) == 1 for x in CUT):
        raise RuntimeError("probetile.cu no longer has the phases this probe cuts")
    out = os.path.join(ROOT, "build", "probetile_phases")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for name, cuts in VARIANTS.items():
        s = src
        for c in cuts:
            s = s.replace(c, CUT[c])
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(s)
        jobs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                                       "-shared", "-o", path[:-3] + ".so", path])
    libs = {}
    for name, job in jobs.items():
        if job.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} copy")
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        for fn in ("crt_binned_tile_dots", "crt_tile_dots"):
            getattr(lib, fn).argtypes = list(build._SIGNATURES[fn])
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def p3_call(lib, p):
    """binned_dots' launch on a library, from the sort on."""
    win, _, row0, _, _ = _geometry(p.packed, p.s0, None, p.per_table, False)
    q, T = p.s0.shape
    d = p.packed.shape[2]
    rt, n_rows, dev = probe_tile_rows(d), p.packed.shape[0] * p.packed.shape[1], p.qv.device
    keys = torch.empty(q, NBINS, dtype=torch.int64, device=dev)
    vals = torch.empty(q, NBINS, device=dev)
    pos = torch.empty(q, NBINS, dtype=torch.int32, device=dev)
    row0 = row0.contiguous()

    def run():
        sr, order, bounds = tile_schedule(row0, n_rows, rt)
        build.check(lib.crt_binned_tile_dots(
            p.packed.data_ptr(), p.qv.data_ptr(), sr.data_ptr(), order.data_ptr(),
            bounds.data_ptr(), keys.data_ptr(), vals.data_ptr(), pos.data_ptr(), sr.numel(),
            q, T, win, d, n_rows, NBINS, _DTYPE_CODE[p.packed.dtype], rt,
            torch.cuda.current_stream().cuda_stream), "P3")
        return vals
    return run


def dots_call(lib, slab, qv, row0, win, d, n_rows, kind, rt):
    """`tile_dots`' launch of a dots-writing kind (P2, P5, P6) on a
    library, from the sort on."""
    q, T = row0.shape
    dots = torch.empty(q, T, win, device=slab.device)
    row0 = row0.contiguous()

    def run():
        sr, order, bounds = tile_schedule(row0, n_rows, rt)
        build.check(lib.crt_tile_dots(
            slab.data_ptr(), qv.data_ptr(), sr.data_ptr(), order.data_ptr(),
            bounds.data_ptr(), dots.data_ptr(), sr.numel(), T, win, d, n_rows, KINDS[kind],
            rt, torch.cuda.current_stream().cuda_stream), kind)
        return dots
    return run


def p6_call(lib, p4, p):
    win, _, row0 = int4slab._geometry4(p4, p.s0, p.per_table)
    d = p4.shape[2]
    return dots_call(lib, p4, p.qv, row0, win, d, p4.shape[0] * p4.shape[1], "int4",
                     probe_tile_rows(d) // 2)


def p2_call(lib, p):
    win, _, row0, _, _ = _geometry(p.packed, p.s0, None, p.per_table, False)
    d = p.packed.shape[2]
    return dots_call(lib, p.packed, p.qv, row0, win, d,
                     p.packed.shape[0] * p.packed.shape[1], "rounded_query",
                     probe_tile_rows(d))


def p4_call(lib, p):
    """P4 i8_dot on int8 slabs, the queries quantized once outside the
    timed calls, as the probe does."""
    win, _, row0, _, _ = _geometry(p.packed, p.s0, None, p.per_table, False)
    d = p.packed.shape[2]
    return dots_call(lib, p.packed, tile_queries(quantize_queries(p.qv), torch.int8), row0,
                     win, d, p.packed.shape[0] * p.packed.shape[1], "i8_dot",
                     BYTE_TILE_ROWS)


def p5_call(lib, blk, p):
    win, _, blk0 = _geometry_blk(blk, p.s0, p.per_table)
    L, npb, d, _ = blk.shape
    kind = "blk_int8" if blk.dtype == torch.int8 else "blk_bf16"
    return dots_call(lib, blk, p.qv, blk0 * B, win, d, L * npb * B, kind,
                     probe_tile_rows(d))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=11)
    args = ap.parse_args(argv)
    C.require_cuda()
    print(C.card(), flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    corpus, queries, _ = C.make_corpus("planted", C.N, 32768, 0, dev)
    index = C.build_cosine(corpus, 40)
    pidx = pack_index(index, corpus, dtype=torch.int8)
    p3, p6 = C.probe_index(pidx, queries[:8192]), C.probe_index(pidx, queries)
    p4, b8 = int4slab.repack_int4(p6.packed), to_blk(p3.packed)
    p16 = C.probe_index(pack_index(index, corpus, dtype=torch.bfloat16), queries[:8192])
    b16 = to_blk(p16.packed)
    del pidx
    for label, make in ((f"P3 int8 nbins {NBINS}, q = 8192", lambda lib: p3_call(lib, p3)),
                        ("P6 int4, q = 32768", lambda lib: p6_call(lib, p4, p6)),
                        ("P2 rounded_query bf16, q = 8192", lambda lib: p2_call(lib, p16)),
                        ("P4 i8_dot int8, q = 8192", lambda lib: p4_call(lib, p3)),
                        ("P5 int8, q = 8192", lambda lib: p5_call(lib, b8, p3)),
                        ("P5 bf16, q = 8192", lambda lib: p5_call(lib, b16, p16))):
        t = C.timed_alternating({name: make(lib) for name, lib in libs.items()}, dev,
                                args.rounds)
        ms = {k: statistics.median(v) for k, v in t.items()}
        print(f"{label}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
