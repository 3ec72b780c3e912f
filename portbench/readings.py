#!/usr/bin/env python3
"""The readings that the checks' limits are set from: for each seed, the
program's numbers (a short window at the cell's own load, then the same
comparison a run makes) and, with --control, the control's on the same
sampled requests (the reference in the program's place, its products in
TF32).  The benchmark's own runs never run this.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 --seconds 3 [--control 1]

One JSON line a seed on standard output.  Needs the card, as run.py does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, workload: str, seed: int, seconds: float, control: bool,
             device) -> dict:
    import torch

    from portbench import harness

    su = harness.set_up(root, workload, seed, False, device, timed_builds=False)
    path = su.path
    sample = harness.Reservoir(int(su.cell.mix["judge_requests"]), seed)
    reqs, _ = harness.window(path, su.traffic, seconds, sample, device)
    state = path.state()
    path.release()
    t0 = time.perf_counter()
    worst = {}
    out = {"seed": seed, "requests": len(reqs),
           "program": path.numbers(state, path.sample_rows(sample.items, seed), worst)}
    out["check_s"] = time.perf_counter() - t0
    out["worst"] = worst
    del state
    if control:
        cstate, cans = path.control(sample.items, seed)
        out["control"] = path.numbers(cstate, cans)
    del su, path, sample
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for s in args.seeds.split(","):
        print(json.dumps(readings(ROOT, args.workload, int(s), args.seconds,
                                  bool(args.control), device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
