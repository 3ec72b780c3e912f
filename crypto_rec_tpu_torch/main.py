"""Command line: python -m crypto_rec_tpu_torch.main -d <input> -o <output> [-validate]

Mirrors the reference binary's interface (reference main.cpp:489-509): -d
input tweets file, -o output file, -validate for 10-fold CV.  The config
file defaults to ./cluster.conf (main.cpp:48) and -c overrides it.  The run
goes to `--device`: `cuda` (the default) runs the Hopper kernels and exits
with an error when there is no NVIDIA GPU; `cpu` runs the kernels' plain
PyTorch versions.  One JSON summary line goes to stdout.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import torch

from crypto_rec_tpu_torch.config import RecConfig, load_config
from crypto_rec_tpu_torch.models.rec.pipeline import run_pipeline


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crypto_rec_tpu_torch")
    p.add_argument("-d", dest="input_file", required=True, help="input tweets file")
    p.add_argument("-o", dest="output_file", required=True, help="output file")
    p.add_argument("-c", dest="config_file", default="./cluster.conf")
    p.add_argument("-validate", action="store_true", dest="validate")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace of the whole run to DIR/trace.json",
    )
    p.add_argument(
        "--silhouette", action="store_true",
        help="evaluate cluster silhouettes in the clustering phases",
    )
    p.add_argument(
        "--engine", choices=("auto", "mask", "csr", "fused"), default=None,
        help="LSH candidate engine: dense mask (reference-exact, O(q*n)), CSR "
             "fixed-budget retrieval (scalable) or fused slab retrieval; default auto",
    )
    p.add_argument(
        "--budget", type=int, default=None,
        help="per-query candidate budget for the csr engine",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default): the Hopper kernels, and an error without a GPU; "
             "cpu: their plain PyTorch versions",
    )
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no NVIDIA GPU is available "
              "(pass --device cpu to run the plain PyTorch versions)", file=sys.stderr)
        return 2
    cfg = load_config(args.config_file, RecConfig(seed=args.seed))
    if args.engine is not None:
        cfg = cfg.replace(engine=args.engine)
    if args.budget is not None:
        cfg = cfg.replace(candidate_budget=args.budget)
    device = torch.device(args.device)
    prof = contextlib.nullcontext()
    if args.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
    with prof:
        result = run_pipeline(args.input_file, args.output_file, cfg,
                              validate=args.validate, with_silhouette=args.silhouette,
                              device=device)
    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    summary = {
        "phase_ms": result.phase_ms,
        "n_users": result.n_users,
        "n_fake_users": result.n_fake_users,
    }
    if result.mae is not None:
        summary["mae_10fold"] = result.mae
    if result.silhouettes is not None:
        summary["silhouettes"] = result.silhouettes
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
