#!/usr/bin/env python3
"""A benchmark cell's requests split by the program's own spans and
counters, on the card: the cell's set-up (`portbench.harness.set_up`, its
seed's inputs, index and warm-up), then n requests of its traffic under
torch.profiler, each synchronised, and `timing.snapshot()`.

    python3 tools/chip_probes/spans_split.py <workload> <seed> <n>

One JSON line: each span path's device-stream and host ms a request and
its calls, the counters (e.g. "dedup.kept" over "dedup.lanes") and the
launches.  Run it from the root of a checkout; from another checkout's
root (a parent tree) it measures that tree.
"""

import json
import sys
from pathlib import Path

import torch

ROOT = Path(".").resolve()
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from crypto_rec_tpu_torch.utils import timing  # noqa: E402


def main(argv) -> int:
    wl, seed, n = argv[0], int(argv[1]), int(argv[2])
    dev = torch.device("cuda")
    su = harness.set_up(ROOT, wl, seed, False, dev, timed_builds=False)
    requests = iter(su.traffic)
    timing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        for _ in range(n):
            su.path.serve(next(requests))
            torch.cuda.synchronize()
    snap = timing.snapshot()
    spans = {p: [None if e["stream_ms"] is None else round(e["stream_ms"] / n, 3),
                 round(e["host_ms"] / n, 3), e["calls"]]
             for p, e in sorted(snap["spans"].items())}
    print(json.dumps({"workload": wl, "seed": seed, "requests": n,
                      "card": torch.cuda.get_device_name(0),
                      "spans_stream_host_calls_a_request": spans,
                      "counters": snap["counters"], "launches": snap["launches"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
