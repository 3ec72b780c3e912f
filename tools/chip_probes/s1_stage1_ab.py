#!/usr/bin/env python3
"""Stage 1 through S1 against stage 1 through `torch.topk`, end to end.

Every K1 path selects its dots through `window_topk` (S1 on the card,
`csrc/windowtopk.cu`: a threshold from the lanes' maxima, one counting
pass, the winners sorted); before S1 those sites called `torch.topk`,
which keeps no order among equal dots.  This puts the two selections in
the same call, on the same index and queries, and times whole paths with
each, in rounds whose order alternates every round, host clock around
work that ends in `torch.cuda.synchronize()`:

  cf          chip_smoke phase 5's CF leg: retrieval (K2 query hash, K1,
              stage 1 kk = 12 a window, dedup) then CF scoring, on the 2M x
              128 planted corpus (cosine k = 13, L = 8, int8 slabs, window
              488), q = 8,192 and 32,768;
  euclid      phase 9's euclidean LSH (k = 5, L = 4, w = 20, window 768,
              augmented int8 slabs, 2x over-fetch and rerank), q = 32,768;
  cube        phase 10's single cosine cube (16 probes, window 976): the flat
              stage 1 of 40 lanes over 16,384, S1's block rows, q = 32,768;
  euclid cube phase 10's euclidean cube (64 probes, window 976, augmented
              int8) and euclidean MultiCube (C = 3 x 24 probes): per-window
              stage 1 over [q probes, 1,024] rows, q = 32,768.

The selection is swapped in for the module attribute `window_topk` of
ops/kernels/slabscore.py and models/lsh/hypercube.py, so nothing else
moves.  Recall@10 against the planted truth is printed for each:
`torch.topk` differs from S1 only among tied dots.

    python3 tools/chip_probes/s1_stage1_ab.py [--rounds 11]

Needs a CUDA device.  Prints the card first and one JSON line last (the
medians and every round's ms of each path).
"""

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from chip_smoke import (  # noqa: E402
    BATCHES, CK, CQ, CUBE_LEGS, D, E_DIV, E_K, E_L, E_PT, E_W, K, L, N, PER_TABLE, SEED,
    TOP_K, TOP_N, TOP_P,
)
from crypto_rec_tpu_torch.experiments._common import card  # noqa: E402
from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus  # noqa: E402
from crypto_rec_tpu_torch.models.lsh import hypercube  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.index import (  # noqa: E402
    build_index, pack_index, retrieve_topk, retrieve_topk_pallas,
)
from crypto_rec_tpu_torch.models.rec.engine import (  # noqa: E402
    RatingSet, recommend_topk_retrieved,
)
from crypto_rec_tpu_torch.ops.kernels import slabscore  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk  # noqa: E402
from crypto_rec_tpu_torch.ops.oracle import recall_at_k  # noqa: E402

DEV = torch.device("cuda")
SITES = (slabscore, hypercube)


def torch_topk(values, k):
    return torch.topk(values, k, dim=1)


ARMS = {"s1": window_topk, "torch_topk": torch_topk}


@contextlib.contextmanager
def stage1(select):
    """Every stage-1 site selects through `select` inside the block."""
    for mod in SITES:
        mod.window_topk = select
    try:
        yield
    finally:
        for mod in SITES:
            mod.window_topk = window_topk


def ab(fn, rounds):
    """-> {arm: [host ms of each round]}: one warm run of each, then
    `rounds` rounds running every arm once, the order alternating."""
    for select in ARMS.values():
        with stage1(select):
            fn()
    torch.cuda.synchronize()
    names = list(ARMS)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            with stage1(ARMS[name]):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def report(label, q, times, recalls):
    med = {name: statistics.median(t) for name, t in times.items()}
    wins = {"torch_topk": sum(a < b for a, b in zip(times["s1"], times["torch_topk"]))}
    print(f"{label}, q = {q}: host ms S1 {med['s1']:.3f} ({q / med['s1'] * 1e3:,.0f}/s), "
          f"torch.topk {med['torch_topk']:.3f} ({q / med['torch_topk'] * 1e3:,.0f}/s); "
          f"S1 faster than torch.topk in {wins['torch_topk']} of {len(times['s1'])} "
          f"rounds; recall@{TOP_K} S1 {recalls['s1']:.4f}, torch.topk "
          f"{recalls['torch_topk']:.4f}", flush=True)
    for name, t in times.items():
        print(f"  {name} rounds (ms): {', '.join(f'{x:.3f}' for x in t)}", flush=True)
    return dict(path=label, q=q, median_ms=med, rounds_ms=times, s1_wins=wins,
                recall=recalls)


def recalls_of(run, truth):
    out = {}
    for name, select in ARMS.items():
        with stage1(select):
            out[name] = recall_at_k(run()[:, :TOP_K], truth)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=11)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("s1_stage1_ab: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card()
    print(smi, flush=True)
    corpus, queries, truth = planted_clustered_corpus(
        torch.Generator(device=DEV).manual_seed(SEED), N, D, max(BATCHES), TOP_K)
    out = []

    # the CF leg (phase 5)
    proj = CosineLsh.create(torch.Generator().manual_seed(SEED + 1), D, K, L, DEV).proj
    pidx = pack_index(build_index(None, corpus, "cosine", K, L,
                                  family=CosineLsh(proj, K, L)), corpus, dtype=torch.int8)
    kq = torch.Generator(device=DEV).manual_seed(SEED + 11)
    n_known = torch.rand(N, D, generator=kq, device=DEV) < 0.6
    nset = RatingSet(corpus, n_known,
                     (corpus * n_known).sum(1) / n_known.sum(1).clamp(min=1))
    q_known = torch.rand(max(BATCHES), D, generator=kq, device=DEV) < 0.6
    q_mean = (queries * q_known).sum(1) / q_known.sum(1).clamp(min=1)
    for q in BATCHES:
        qset = RatingSet(queries[:q], q_known[:q], q_mean[:q])

        def retrieve(qs=qset.ratings):
            return retrieve_topk_pallas(pidx, qs, corpus, top_k=TOP_P,
                                        per_table=PER_TABLE, int8_rerank=False,
                                        stage1_per_table=12)

        def cf(qset=qset):
            return recommend_topk_retrieved(qset, nset, *retrieve(qset.ratings), TOP_N)

        rec = recalls_of(lambda: retrieve()[1], truth[:q])
        out.append(report("CF leg (retrieval + CF scoring)", q, ab(cf, args.rounds),
                          rec))
    del pidx, nset, n_known
    torch.cuda.empty_cache()

    qs = queries[:CQ]
    # euclidean LSH (phase 9)
    eidx = pack_index(build_index(torch.Generator().manual_seed(SEED + 21), corpus,
                                  "euclidean", E_K, E_L, lsh_bucket_div=E_DIV,
                                  euclidean_h_w=E_W), corpus, dtype=torch.int8,
                      augment=True)

    def euclid():
        return retrieve_topk(eidx, qs, corpus, top_k=TOP_K, per_table=E_PT)

    rec = recalls_of(lambda: euclid()[1], truth[:CQ])
    out.append(report("euclidean LSH", CQ, ab(euclid, args.rounds), rec))
    del eidx
    torch.cuda.empty_cache()

    # the cubes (phase 10): the single cosine cube's flat stage 1 is S1's
    # block rows, the euclidean cubes' per-window stage 1 its warp rows
    legs = {leg[0]: (i, leg) for i, leg in enumerate(CUBE_LEGS)}
    for name in ("single cosine cube", "euclidean cube", "euclidean MultiCube"):
        i, (_, metric, cubes, probes, per_probe, w, _) = legs[name]
        g = torch.Generator().manual_seed(SEED + 30 + i)
        if cubes > 1:
            obj = hypercube.build_multicube(g, corpus, metric, cubes, CK, w,
                                            corpus_dtype=torch.int8)

            def run(obj=obj, probes=probes, per_probe=per_probe):
                return hypercube.multicube_retrieve_topk(obj, qs, TOP_K, probes, per_probe)
        else:
            obj = hypercube.pack_cube(hypercube.build_hypercube(g, corpus, metric, CK, w),
                                      corpus, dtype=torch.int8,
                                      augment=metric == "euclidean")

            def run(obj=obj, probes=probes, per_probe=per_probe):
                return hypercube.cube_retrieve_topk(obj, qs, corpus, TOP_K, probes, per_probe)

        rec = recalls_of(lambda: run()[1], truth[:CQ])
        stage = "flat stage 1" if name == "single cosine cube" else "per-window stage 1"
        out.append(report(f"{name} ({stage})", CQ, ab(run, args.rounds), rec))
        del obj, run
        torch.cuda.empty_cache()

    print(json.dumps({"card": smi, "rounds": args.rounds, "paths": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
