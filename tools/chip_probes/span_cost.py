#!/usr/bin/env python3
"""What the library's spans and counters (`crypto_rec_tpu_torch/utils/timing.py`)
cost on the card, off and on.

Off (no profiler recording): host us of an empty `timing.span` and of a
`timing.count`, against an empty call.  On (a torch.profiler recording CPU
and CUDA activity, as a `--trace 1` run of the benchmark does): the same,
and the parts of a span, a `record_function` range alone and a pair of
CUDA event records alone.  Each figure is the mean over many calls with a
synchronise at each end.

    python3 tools/chip_probes/span_cost.py [--n 20000]

Needs a CUDA device.  Prints the card first, then one JSON line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from crypto_rec_tpu_torch.utils import timing  # noqa: E402


def per_call_us(fn, n: int) -> float:
    for _ in range(min(n, 100)):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=20000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_cost: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    one = torch.ones((), dtype=torch.int64, device=dev)

    def nothing():
        pass

    def span():
        with timing.span("s"):
            pass

    def count():
        timing.count("c", one)

    def record_function():
        with torch.profiler.record_function("r"):
            pass

    def event_pair():
        a = torch.cuda.Event(enable_timing=True)
        a.record()
        b = torch.cuda.Event(enable_timing=True)
        b.record()

    calls = {"empty_call": nothing, "span": span, "count": count}
    off = {k: per_call_us(f, args.n) for k, f in calls.items()}
    calls.update(record_function=record_function, event_pair=event_pair)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        on = {k: per_call_us(f, max(1, args.n // 10)) for k, f in calls.items()}
    n_spans = timing.snapshot()["spans"]["s"]["calls"]
    timing.reset()
    print(json.dumps({"device": torch.cuda.get_device_name(dev), "off_us": off, "on_us": on,
                      "spans_recorded_on": n_spans}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
