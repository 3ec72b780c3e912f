#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic mix and
metrics are read from BENCHMARK.json and the files it names.  The last
line of standard output is one JSON object (correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last the checks: each
number compared with the reference beside its limit); the checks are also
the last lines of standard error.  Exits non-zero, printing no result,
without a CUDA device (or with fewer than the cell asks for), without the
port beside the benchmark, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "crypto_rec_tpu")


def loaded_forbidden() -> list:
    """Modules loaded whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    if not (ROOT / "crypto_rec_tpu_torch").is_dir():
        print("portbench: no crypto_rec_tpu_torch/ beside the benchmark; run it from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.cell_of(ROOT, harness.load_json(ROOT / "BENCHMARK.json"), args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
