#!/usr/bin/env python3
"""The sharded engines across cards: one torch.distributed rank a card.

Run with torchrun, one process a card:

    torchrun --nproc-per-node 4 tools/chip_probes/sharded_multicard.py

Every rank makes chip_smoke phase 5's planted corpus (2M x 128, the same
seed, on its own device) and the same hyperplanes (cosine k = 13, L = 8);
a (1, world) mesh gives each rank one shard.  Counted and timed:
build_sharded_index (K2), the int8 pack, sharded_retrieve_topk (window
488, top-20) and sharded_recommend_scored (K1) with their all_gather
merges over NCCL, sharded_recommend_csr (budget 256), and
routed_retrieve_topk (csr interior, budget 512) with its all_to_all
exchange, at q = 8,192.  Rank 0 then runs the same calls with every shard
as a logical cell of its own card (no collectives) and checks that the
multi-card results equal them: ids and integer stats exactly, scores
within 1e-5.  Times are host-clock medians of 3 runs that end in a
synchronize, on rank 0 (the merges keep the ranks in step).

    --device cpu --n 40000 --q 512    the rehearsal: gloo over CPU processes

Rank 0 prints the card line first and one JSON line last.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.index import build_index  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_window_dots  # noqa: E402
from crypto_rec_tpu_torch.ops.oracle import recall_at_k  # noqa: E402
from crypto_rec_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from crypto_rec_tpu_torch.parallel.routing import routed_retrieve_topk  # noqa: E402
from crypto_rec_tpu_torch.parallel.sharded_index import (  # noqa: E402
    build_sharded_index, pack_sharded_index, shard_corpus, sharded_recommend_csr,
    sharded_recommend_scored, sharded_retrieve_topk,
)

D, K, L, PER_TABLE, TOP_P, TOP_N, TOP_K, SEED = 128, 13, 8, 488, 20, 5, 10, 0


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev, reps=3):
    fn()
    sync(dev)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def engines(mesh, corpus, qs, qk, qm, n_mean, time_them):
    """Build, pack and every engine on `mesh` -> (outputs, timings and
    launch counts)."""
    dev = mesh.device
    pc = shard_corpus(mesh, corpus)
    nm = shard_corpus(mesh, n_mean)
    info = {}
    for fn in (signproj_bucket_ids, slab_window_dots):
        fn.launches = 0
    t0 = time.perf_counter()
    idx = build_sharded_index(mesh, torch.Generator().manual_seed(SEED + 1), pc, "cosine", K, L)
    sync(dev)
    info["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pidx = pack_sharded_index(mesh, idx, pc, dtype=torch.int8)
    sync(dev)
    info["pack_s"] = time.perf_counter() - t0
    calls = {
        "retrieval": lambda: sharded_retrieve_topk(mesh, pidx, qs, pc, budget=PER_TABLE,
                                                   top_k=TOP_P, per_table=PER_TABLE,
                                                   int8_rerank=False),
        "scored": lambda: sharded_recommend_scored(mesh, pidx, qs, qk, qm, pc, nm, top_p=TOP_P,
                                                   top_n=TOP_N, per_table=PER_TABLE),
        "csr": lambda: sharded_recommend_csr(mesh, idx, qs, qk, qm, pc, nm, budget=256,
                                             top_p=TOP_P, top_n=TOP_N),
    }
    out = {name: fn() for name, fn in calls.items()}
    sync(dev)
    info["launches"] = dict(signproj_bucket_ids=signproj_bucket_ids.launches,
                            slab_window_dots=slab_window_dots.launches)
    single = build_index(torch.Generator().manual_seed(SEED + 1), corpus, "cosine", K, L)
    calls["routed"] = lambda: routed_retrieve_topk(mesh, single, qs, corpus, top_k=TOP_K,
                                                   budget=512)
    out["routed"] = calls["routed"]()
    if time_them:
        info["ms"] = {name: timed(fn, dev) for name, fn in calls.items()}
    return out, info


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--q", type=int, default=8192)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("sharded_multicard: no CUDA device", file=sys.stderr)
            return 1
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    if world > 1:
        pmesh.initialize_multihost("env://", world, rank, device=dev)
    else:
        torch.distributed.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://", world_size=1,
            rank=0, **({"device_id": dev} if dev.type == "cuda" else {}))
    card = ""
    if rank == 0 and dev.type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip()
        print(card, flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    corpus, queries, true_idx = planted_clustered_corpus(gen, args.n, D, args.q, TOP_K)
    kq = torch.Generator(device=dev).manual_seed(SEED + 11)
    n_known = torch.rand(args.n, D, generator=kq, device=dev) < 0.6
    n_mean = (corpus * n_known).sum(1) / n_known.sum(1).clamp(min=1)
    qk = torch.rand(args.q, D, generator=kq, device=dev) < 0.6
    qm = (queries * qk).sum(1) / qk.sum(1).clamp(min=1)
    del n_known
    mesh = pmesh.make_mesh((1, world), device=dev)
    out, info = engines(mesh, corpus, queries, qk, qm, n_mean, time_them=True)
    res = dict(world=world, backend=torch.distributed.get_backend(), card=card,
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               n=args.n, q=args.q, **info)
    if rank == 0:
        res["recall"] = {
            "retrieval": recall_at_k(out["retrieval"][1][:, :TOP_K], true_idx),
            "scored": recall_at_k(out["scored"][4][:, :TOP_K], true_idx),
            "csr": recall_at_k(out["csr"][4][:, :TOP_K], true_idx),
            "routed": recall_at_k(out["routed"][1], true_idx)}
        res["qps"] = {k: args.q / v * 1e3 for k, v in info["ms"].items()}
        res["routed_stats"] = out["routed"][2]
        # every shard a logical cell of this card, no collectives
        local = pmesh.Mesh((1, world), ("dp", "mp"), dev, None, 0, 1)
        ref, _ = engines(local, corpus, queries, qk, qm, n_mean, time_them=False)
        pairs = {"retrieval": (0, 1), "scored": (3, 4), "csr": (3, 4), "routed": (0, 1)}
        same = {}
        for name, (si, ii) in pairs.items():
            ids_equal = torch.equal(out[name][ii], ref[name][ii])
            err = float((out[name][si] - ref[name][si]).abs().nan_to_num().max())
            same[name] = dict(ids_equal=ids_equal, max_abs_score_diff=err)
        for name in ("scored", "csr"):
            same[name]["stats_equal"] = all(
                int(out[name][5][k]) == int(ref[name][5][k])
                for k in out[name][5] if k != "ici_bytes_per_query")
        res["equal_to_one_card"] = same
        ok = all(s["ids_equal"] and s["max_abs_score_diff"] <= 1e-5
                 and s.get("stats_equal", True) for s in same.values())
        res["ok"] = ok
        for k, v in res.items():
            if k not in ("card",):
                print(f"{k}: {v}", flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    if rank == 0:
        print(json.dumps(res, default=str))
        return 0 if res["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
