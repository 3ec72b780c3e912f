#!/usr/bin/env python3
"""S1's two designs on the card: what each compiles to, whether each is
right, and where each one's time goes.

  csrc/windowtopk.cu       the threshold design `window_topk` launches: a
                           lower bound from the lanes' maxima, one counting
                           pass, the winners sorted;
  csrc/windowtopk_prev.cu  the previous design, `window_topk_prev`: k serial
                           arg-max rounds over the row.

Steps (each optional):

  --ptxas   nvcc -Xptxas -v of both sources with the build's flags:
            registers, shared memory, stack and spills of every
            instantiation;
  --check   both designs against topk_desc bit for bit (values and
            indices) on chip_smoke phase 24's tied rows at the 19 stage-1
            shapes of the program's paths;
  --split   the previous design at k = 1, k / 2 and k on one [R, m]: the
            intercept is the load, the slope the rounds (CF point
            [65,536, 640] k = 12 and the single cube's [32,768, 16,384]
            k = 40; tied and Gaussian rows);
  --time    at every shape, the threshold design, the previous design,
            torch.topk (the library yardstick) and topk_desc (the plain
            version) in alternating rounds on tied rows, the first three on
            Gaussian rows too, each beside S1's byte bound: CUDA events
            around one call (as chip_smoke times them: the wrapper's host
            dispatch included), and the kernels' own device time per call
            from a torch.profiler trace of 20 calls (device_ms).

    python3 tools/chip_probes/s1_designs.py --ptxas --check --split --time

Needs a CUDA device.  Prints the card first and one JSON line last.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from chip_smoke import S1_CHUNK, S1_TIME_ELEMS, SEED, _s1_tied_rows, rounds_ms  # noqa: E402
from crypto_rec_tpu_torch.experiments._common import card  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels import bounds, build  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.windowtopk import (  # noqa: E402
    window_topk, window_topk_prev,
)
from crypto_rec_tpu_torch.ops.topk import topk_desc  # noqa: E402

# (rows, m, k, the chip_smoke phase that first launches S1 at it)
SHAPES = [(65536, 640, 12, 5), (262144, 640, 12, 5), (2048, 640, 10, 5),
          (65536, 640, 80, 6), (8192, 640, 10, 7), (131072, 896, 20, 9),
          (786432, 640, 10, 10), (2097152, 1024, 10, 10), (2359296, 1024, 10, 10),
          (32768, 16384, 40, 10), (4096, 896, 20, 11), (262144, 640, 10, 12),
          (65536, 640, 10, 12), (8192, 5120, 40, 12), (8192, 5120, 80, 12),
          (120000, 640, 20, 14), (65536, 640, 32, 15), (65536, 384, 10, 19),
          (65536, 640, 20, 22)]
SPLIT = [(65536, 640, 12), (32768, 16384, 40)]


def ptxas_report():
    """-> [{source, kernel, registers, smem, stack, spill_stores, spill_loads}]."""
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("windowtopk.cu", "windowtopk_prev.cu"):
            res = subprocess.run(
                [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC),
                 "-c", "-o", os.path.join(tmp, "s1.o"), str(build.CSRC / name)],
                capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"nvcc {name} failed:\n{res.stderr}")
            entry = None
            for line in res.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\w+)'", line)
                if m:
                    entry = dict(source=name, kernel=_demangle(m.group(1)))
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
                if m and entry is not None:
                    entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                 spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
                if m and entry is not None:
                    entry.update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
                    out.append(entry)
                    print(f"ptxas {name} {entry['kernel']}: {entry['registers']} registers, "
                          f"{entry['smem']} B static smem, {entry.get('stack', 0)} B stack, "
                          f"spills {entry.get('spill_stores', 0)} / "
                          f"{entry.get('spill_loads', 0)} B", flush=True)
                    entry = None
    return out


def _demangle(sym):
    try:
        return subprocess.run(["c++filt", sym], capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return sym


def equal_to_plain(select, v, k):
    """select(v, k) against topk_desc, S1_CHUNK rows at a time, bit for bit."""
    got = select(v, k)
    for s in range(0, v.shape[0], S1_CHUNK):
        want = topk_desc(v[s:s + S1_CHUNK], k)
        if not (torch.equal(got[1][s:s + S1_CHUNK], want[1]) and torch.equal(
                got[0][s:s + S1_CHUNK].view(torch.int32), want[0].view(torch.int32))):
            return False
    return True


def gaussian_rows(R, m, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(R, m, generator=g, device="cuda")


def device_ms(fn, reps=20):
    """The device time of fn's kernels, copies and memsets per call, from a
    torch.profiler trace of `reps` calls after one warm call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    us = sum(e.get("dur", 0) for e in events
             if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return us / 1e3 / reps


def time_shape(v, k, arms):
    """{arm: median ms of CUDA events around one call, arm_device: the
    profiler's device ms per call} on the first S1_TIME_ELEMS // m rows,
    with S1's bound."""
    v = v[:max(1, S1_TIME_ELEMS // v.shape[1])]
    fns = {"new": lambda: window_topk(v, k), "prev": lambda: window_topk_prev(v, k),
           "torch_topk": lambda: torch.topk(v, k, dim=1),
           "topk_desc": lambda: topk_desc(v, k)}
    t = rounds_ms({a: fns[a] for a in arms})
    for a in arms:
        t[f"{a}_device"] = device_ms(fns[a])
    R, m = v.shape
    t.update(R=int(R), m=int(m), k=int(k), bound_ms=bounds.s1_call(R, m, k)["bound_ms"])
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for step in ("ptxas", "check", "split", "time"):
        ap.add_argument(f"--{step}", action="store_true")
    ap.add_argument("--shapes", type=int, default=len(SHAPES),
                    help="only the first N of the 19 shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("s1_designs: needs a CUDA device", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    res = dict(card=smi)
    if args.ptxas:
        res["ptxas"] = ptxas_report()
    build.library()
    if args.split:
        res["split"] = []
        for R, m, k in SPLIT:
            for kind, v in (("tied", _s1_tied_rows(R, m, SEED + 7)),
                            ("gaussian", gaussian_rows(R, m, SEED + 8))):
                ks = sorted({1, k // 2, k})
                t = rounds_ms({f"k{kk}": (lambda kk=kk: window_topk_prev(v, kk)) for kk in ks})
                ms = [t[f"k{kk}"] for kk in ks]
                slope = (ms[-1] - ms[0]) / (ks[-1] - ks[0])
                e = dict(R=R, m=m, rows=kind, ks=ks, prev_ms=ms, load_ms=ms[0] - slope,
                         round_ms=slope, bound_ms=bounds.s1_call(R, m, k)["bound_ms"])
                print(f"split, previous design [{R}, {m}] {kind} rows: k = {ks}: "
                      f"{', '.join(f'{x:.3f}' for x in ms)} ms; intercept (load) "
                      f"{e['load_ms']:.3f} ms, slope {slope:.4f} ms a round, bound at k = {k} "
                      f"{e['bound_ms']:.4f} ms", flush=True)
                res["split"].append(e)
                del v
    if args.check or args.time:
        res["shapes"] = []
        for i, (R, m, k, phase) in enumerate(SHAPES[:args.shapes]):
            v = _s1_tied_rows(R, m, SEED + 240 + i)
            e = dict(R=R, m=m, k=k, phase=phase)
            if args.check:
                e["new_equal"] = equal_to_plain(window_topk, v, k)
                e["prev_equal"] = equal_to_plain(window_topk_prev, v, k)
                print(f"check [{R}, {m}] k = {k} (phase {phase}), tied rows: threshold design "
                      f"equal to topk_desc {e['new_equal']}, previous design "
                      f"{e['prev_equal']}", flush=True)
            if args.time:
                e["tied"] = time_shape(v, k, ("new", "prev", "torch_topk", "topk_desc"))
                del v
                g = gaussian_rows(R, m, SEED + 340 + i)
                e["gaussian"] = time_shape(g, k, ("new", "prev", "torch_topk"))
                e["new_all_rows_ms"] = rounds_ms({"ms": lambda: window_topk(g, k)})["ms"]
                del g
                for kind in ("tied", "gaussian"):
                    t = e[kind]
                    print(f"time [{R}, {m}] k = {k} {kind} rows (timed on {t['R']}): "
                          f"threshold {t['new']:.3f} ms, previous {t['prev']:.3f}, torch.topk "
                          f"{t['torch_topk']:.3f}"
                          + (f", topk_desc {t['topk_desc']:.3f}" if "topk_desc" in t else "")
                          + f"; device only: threshold {t['new_device']:.4f}, previous "
                          f"{t['prev_device']:.4f}, torch.topk {t['torch_topk_device']:.4f}"
                          + (f", topk_desc {t['topk_desc_device']:.4f}" if "topk_desc" in t
                             else "")
                          + f"; bound {t['bound_ms']:.4f} ms ({100 * t['bound_ms'] / t['new']:.1f}"
                          f"% of the event time, "
                          f"{100 * t['bound_ms'] / max(t['new_device'], 1e-9):.1f}% of the device time)",
                          flush=True)
                print(f"  threshold design on all {R} Gaussian rows: "
                      f"{e['new_all_rows_ms']:.3f} ms", flush=True)
            else:
                del v
            res["shapes"].append(e)
            torch.cuda.empty_cache()
    ok = all(e.get("new_equal", True) and e.get("prev_equal", True)
             for e in res.get("shapes", []))
    res["ok"] = ok
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
