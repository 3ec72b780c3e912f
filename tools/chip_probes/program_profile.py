#!/usr/bin/env python3
"""Where the recommender program's time goes on the card.

Writes chip_smoke.py phase 13's dataset (20,000 users, 400,000 tweets, 15
coins), runs `crypto_rec_tpu_torch.main -validate` once to load the
kernels, then once more with `--profile`, and reads the torch.profiler
trace: for each phase span (PhaseTimer's record_function), its host span,
the device busy time (the union of the kernel, copy and memset intervals
inside the span), the idle share and the kernel count; then the kernels
with the most device time.

    python3 tools/chip_probes/program_profile.py [--users N] [--tweets T]

Needs a CUDA device.  Prints the card first.
"""

import argparse
import collections
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from chip_smoke import PIPE  # noqa: E402
from crypto_rec_tpu_torch import main as rec_main  # noqa: E402
from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset  # noqa: E402

PHASES = ("phase0", "ingest", "lsh_A", "validate", "lsh_B", "cluster_A", "cluster_B")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_us(intervals, lo, hi):
    """Length of the union of [start, end) intervals clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--users", type=int, default=PIPE["n_users"])
    ap.add_argument("--tweets", type=int, default=PIPE["n_tweets"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("program_profile: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        tweets, conf = write_synthetic_dataset(
            os.path.join(tmp, "ds"), **dict(PIPE, n_users=args.users, n_tweets=args.tweets))
        base = ["-d", tweets, "-o", os.path.join(tmp, "out.txt"), "-c", conf, "-validate"]
        with contextlib.redirect_stdout(io.StringIO()):
            rec_main.main(base)                                  # kernels loaded
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rec_main.main(base + ["--profile", os.path.join(tmp, "trace")])
        phase_ms = json.loads(buf.getvalue().strip().splitlines()[-1])["phase_ms"]
        with open(os.path.join(tmp, "trace", "trace.json")) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in PHASES}
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
           if e.get("cat") in DEVICE_CATS]
    print(f"{args.users} users, {args.tweets} tweets; phase ms (PhaseTimer, profiled "
          f"run) {phase_ms}")
    rows = {}
    for name in PHASES:
        lo, hi = spans[name]
        inside = [(s, e) for s, e, _ in dev if s < hi and e > lo]
        busy = union_us(inside, lo, hi)
        rows[name] = dict(span_ms=(hi - lo) / 1e3, busy_ms=busy / 1e3,
                          idle_share=1.0 - busy / max(hi - lo, 1e-9), kernels=len(inside))
        r = rows[name]
        print(f"{name:>9}: span {r['span_ms']:9.3f} ms, device busy {r['busy_ms']:8.3f} ms, "
              f"idle {100 * r['idle_share']:5.1f}%, {r['kernels']} kernels/copies")
    total = collections.Counter()
    for s, e, n in dev:
        total[n] += e - s
    print("device time by kernel (top 12):")
    for n, us in total.most_common(12):
        print(f"  {us / 1e3:9.3f} ms  {n[:110]}")
    print(json.dumps({"phases": rows, "phase_ms": phase_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
