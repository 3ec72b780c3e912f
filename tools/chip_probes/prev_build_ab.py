#!/usr/bin/env python3
"""This tree's kernels against a previous tree's, on the same inputs.

Builds the previous tree's `crypto_rec_tpu_torch/csrc/*.cu` into a second
library (one nvcc a source, started together) and launches K1
(`crt_slab_tile_dots`), K2 (`crt_signproj`) and S1 (`crt_window_topk`)
from both libraries on the same tensors, at shapes both take (chip_smoke's
phase 4-5 CF point, phases 8-10's widths, the program's d = 15 and 16, the
retrieval cell's d = 1,536; K1 on each build's own work list, cut by that
tree's `tile_plan`): outputs equal bit for bit, then CUDA-event medians of
alternating rounds (this tree, previous, previous, this tree).  K1 rows
whose two builds run different bodies (`exact` false: the CF cell's int8
d = 100 and the program's int8 d = 15, where this tree's tensor-core body
replaced the previous tree's FFMA body) are held instead to rtol 1e-5 /
atol 1e-6 of the largest |dot| against each other.  Each K1 row also gives
`bounds.k1_call` and this tree's share of it.

    python3 tools/chip_probes/prev_build_ab.py --prev DIR [--rounds 9]

DIR is a checkout of the previous commit (`git archive` unpacked).  Needs a
CUDA device.  Prints the card first and one JSON line last.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from crypto_rec_tpu_torch.ops.kernels import bounds, build  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels import slabscore as S  # noqa: E402

ENTRIES = ("crt_slab_tile_dots", "crt_signproj", "crt_window_topk")


def prev_library(root: str) -> ctypes.CDLL:
    csrc = Path(root) / "crypto_rec_tpu_torch" / "csrc"
    out = Path(tempfile.mkdtemp(prefix="crt_prev_"))
    srcs = sorted(p for p in csrc.iterdir() if p.suffix == ".cu")
    jobs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-c", "-o",
                              str(out / (p.stem + ".o")), str(p)]) for p in srcs]
    if any(j.wait() for j in jobs):
        raise RuntimeError("nvcc failed on the previous tree")
    lib = out / "libprev.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                    *(str(out / (p.stem + ".o")) for p in srcs)], check=True)
    cdll = ctypes.CDLL(str(lib))
    for name in ENTRIES:
        fn = getattr(cdll, name)
        fn.argtypes = list(build._SIGNATURES[name])
        fn.restype = ctypes.c_int
    return cdll


def prev_slabscore(root: str):
    """The previous tree's K1 wrapper module, loaded beside this tree's: its
    `tile_shape` / `tile_plan` cut the tiles its kernels take."""
    path = Path(root) / "crypto_rec_tpu_torch" / "ops" / "kernels" / "slabscore.py"
    spec = importlib.util.spec_from_file_location("prev_slabscore", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def alternating(fns, rounds):
    """{name: median ms}, rounds of a, b, b, a."""
    names = list(fns)
    for f in fns.values():
        f()
    torch.cuda.synchronize()
    times = {n: [] for n in names}
    for r in range(rounds):
        for n in (names if r % 2 == 0 else names[::-1]):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fns[n]()
            b.record()
            b.synchronize()
            times[n].append(a.elapsed_time(b))
    return {n: statistics.median(t) for n, t in times.items()}


def stream():
    return torch.cuda.current_stream().cuda_stream


def k1_case(libs, wrappers, label, dtype, T, n_pad, d, q, per_table, rounds, exact=True):
    g = torch.Generator(device="cuda").manual_seed(d + T)
    if dtype == torch.int8:
        packed = torch.randint(-127, 128, (T, n_pad, d), generator=g, device="cuda",
                               dtype=dtype)
    else:
        packed = torch.randn(T, n_pad, d, generator=g, device="cuda").to(dtype)
    starts = torch.randint(0, n_pad, (q, T), generator=g, device="cuda", dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, d, generator=g, device="cuda"), dim=1)
    win, _, row0, head, size = S.card_geometry(packed, starts, None, qv, per_table, False,
                                               False)
    outs = {k: torch.empty(q, T, win, device="cuda") for k in libs}

    def run(k):
        meta, item_tile, item_lo, item_cnt = wrappers[k].tile_plan(packed, row0, head, size, win)
        rt, m = wrappers[k].tile_shape(dtype, d)

        def f():
            err = libs[k].crt_slab_tile_dots(
                packed.data_ptr(), qv.data_ptr(), None, meta.data_ptr(), item_tile.data_ptr(),
                item_lo.data_ptr(), item_cnt.data_ptr(), outs[k].data_ptr(), item_tile.numel(),
                meta.shape[1], T, win, d, T * n_pad, 0, S._DTYPE_CODE[dtype], rt, m, stream())
            assert err == 0, err
        return f

    t = alternating({k: run(k) for k in libs}, rounds)
    new, old = outs["this"], outs["previous"]
    same = torch.equal(new.view(torch.int32), old.view(torch.int32))
    top = float(old.abs().max())
    err = float((new - old).abs().max()) / top
    bound = bounds.k1_call(packed, starts, None, qv, per_table)["bound_ms"]
    ok = same if exact else torch.allclose(new, old, rtol=1e-5, atol=1e-6 * top)
    return dict(kernel="K1", case=label, same_bits=same, exact=exact, ok=ok,
                max_err_rel=err, bound_ms=bound, share_of_bound=bound / t["this"], **t)


def k2_case(libs, label, n, d, k, L, rounds):
    g = torch.Generator(device="cuda").manual_seed(n + k)
    x = torch.randn(n, d, generator=g, device="cuda")
    proj = torch.randn(d, L * k, generator=g, device="cuda")
    outs = {key: torch.empty(n, L, dtype=torch.int32, device="cuda") for key in libs}

    def run(key):
        def f():
            err = libs[key].crt_signproj(x.data_ptr(), proj.data_ptr(), outs[key].data_ptr(),
                                         n, d, k, L, stream())
            assert err == 0, err
        return f

    t = alternating({key: run(key) for key in libs}, rounds)
    same = torch.equal(outs["this"], outs["previous"])
    return dict(kernel="K2", case=label, same_bits=same, ok=same, **t)


def s1_case(libs, label, R, m, k, rounds):
    g = torch.Generator(device="cuda").manual_seed(m + k)
    v = torch.randint(-50, 50, (R, m), generator=g, device="cuda").float()
    outs = {key: (torch.empty(R, k, device="cuda"),
                  torch.empty(R, k, dtype=torch.int64, device="cuda")) for key in libs}

    def run(key):
        def f():
            ov, oi = outs[key]
            err = libs[key].crt_window_topk(v.data_ptr(), ov.data_ptr(), oi.data_ptr(), R, m, k,
                                            stream())
            assert err == 0, err
        return f

    t = alternating({key: run(key) for key in libs}, rounds)
    same = all(torch.equal(a, b) for a, b in zip(outs["this"], outs["previous"]))
    return dict(kernel="S1", case=label, same_bits=same, ok=same, **t)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prev", required=True)
    ap.add_argument("--rounds", type=int, default=9)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prev_build_ab: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    libs = {"this": build.library(), "previous": prev_library(args.prev)}
    wrappers = {"this": S, "previous": prev_slabscore(args.prev)}
    r = args.rounds
    rows = [
        k1_case(libs, wrappers, "CF point: int8 [8, 2,004,992, 128], q 8,192, window 488",
                torch.int8, 8, 2_004_992, 128, 8192, 488, r),
        k1_case(libs, wrappers, "augmented int8 [4, 2,004,992, 256], q 8,192, window 768",
                torch.int8, 4, 2_004_992, 256, 8192, 768, r),
        k1_case(libs, wrappers, "bf16 [8, 1,000,000, 128], q 8,192, window 488",
                torch.bfloat16, 8, 1_000_000, 128, 8192, 488, r),
        k1_case(libs, wrappers, "bf16 [4, 1,000,000, 256], q 8,192, window 768",
                torch.bfloat16, 4, 1_000_000, 256, 8192, 768, r),
        k1_case(libs, wrappers, "CV fold: f32 [6, 184,320, 128], q 20,000, window 512",
                torch.float32, 6, 184_320, 128, 20_000, 512, r),
        k1_case(libs, wrappers, "retrieval cell: int8 [8, 1,000,000, 1,536], q 8,192, "
                "window 488", torch.int8, 8, 1_000_000, 1536, 8192, 488, r),
        k1_case(libs, wrappers, "CF cell: int8 [8, 77,517, 100], q 73,421, window 287",
                torch.int8, 8, 77_517, 100, 73_421, 287, r, exact=False),
        k1_case(libs, wrappers, "program's coins: int8 [5, 24,096, 15], q 20,000, window 256",
                torch.int8, 5, 24_096, 15, 20_000, 256, r, exact=False),
        k2_case(libs, "index build: [2,000,000, 128], L 8, k 13", 2_000_000, 128, 13, 8, r),
        k2_case(libs, "cube vertices: [2,000,000, 128], L 1, k 13", 2_000_000, 128, 13, 1, r),
        k2_case(libs, "program: [20,000, 16], L 5, k 4", 20_000, 16, 4, 5, r),
        k2_case(libs, "[1,000,000, 256], L 8, k 13", 1_000_000, 256, 13, 8, r),
        s1_case(libs, "CF point [65,536, 640] k 12 (warp rows)", 65_536, 640, 12, r),
        s1_case(libs, "cube [32,768, 16,384] k 40 (block rows)", 32_768, 16_384, 40, r),
        s1_case(libs, "[4,096, 32,768] k 40 (block rows of 1,024 threads)", 4096, 32_768,
                40, r),
    ]
    for e in rows:
        extra = (f", max |err| / max |dot| {e['max_err_rel']:.2e}, bound {e['bound_ms']:.3f} ms "
                 f"({100 * e['share_of_bound']:.1f}% of it)" if e["kernel"] == "K1" else "")
        print(f"{e['kernel']} {e['case']}: this tree {e['this']:.3f} ms, previous "
              f"{e['previous']:.3f} ms, outputs equal bit for bit: {e['same_bits']}{extra}",
              flush=True)
    print(json.dumps(dict(card=card, rounds=r, rows=rows)))
    return 0 if all(e["ok"] for e in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
