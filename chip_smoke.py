#!/usr/bin/env python3
"""Smoke run of the PyTorch / Hopper port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's serving paths at `bench.py`'s operating points on one
2M x 128 planted corpus on the card, the recommender program and its
10-fold CV, the rest of the single-chip package and the sharded
engines, in twenty-five phases; each phase raises on failure:

  1. device: nvidia-smi's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles csrc/*.cu for sm_90a (seconds printed);
  3. K2 (sign-projection hash) against its plain version, 2M x 128 rows,
     L = 8;
  4. K1 (slab-window dots, the tile-major kernel) against its plain
     version on every window at q = 8,192, both mask modes, and on a hot
     tile (half the queries on one window set);
  5. the fused LSH -> CF slice end to end at q = 8,192 and 32,768 (cosine
     k = 13, L = 8, int8 slabs, top-20 neighbours, top-5 coins): index
     build (K2), pack, retrieval (K1), CF scoring; neighbour recall@10
     against the planted truth must reach 0.99; the exact oracle streamed
     from the corpus copied to the host (exact_nearest_streamed, 1,024
     queries, 2^18-row slices) against the resident one: ids equal but
     within 1e-5 distance ties;
  6. lsh_phase(engine="fused") on the same users;
  7. serving: serve_cli answers three requests from a saved index;
  8. K1 against its plain version on every window at the new geometries
     (augmented int8 [4, n_pad, 256] at q = 8,192; shared-slab cosine
     MultiCube [1, 2 n_pad, 128] and shared-slab augmented MultiCube
     [1, 3 n_pad, 256] at q = 1,024) and K2 at L = 1;
  9. euclidean p-stable LSH (k = 5, L = 4, w = 20, window 768, int8
     augmented slabs) at q = 32,768, recall@10 floor 0.98;
 10. the cube family at q = 32,768, k = 13, int8: cosine MultiCube (C = 2,
     12 probes), single cosine cube (16 probes), euclidean cube (64
     probes), euclidean MultiCube (C = 3, 24 probes), each with its
     recall@10 floor (CUBE_LEGS);
 11. serving: `serve_cli retrieve --pack --augment` answers three requests
     from a saved euclidean index;
 12. the probe kernels of benchmarks/experiments/ (P1-P6) on one cosine
     index (k = 13, L = 8, int8 and bf16 slabs) at the probes' point,
     q = 8,192 (P6: 32,768): the binned, int4, variant and blocked kernels
     and K1 without the mask, each against its plain version (dots within
     rtol 1e-5 / atol 1e-4, i8_dot and load_floor exact, binned winners
     equal away from near-ties) on 2,048 queries and timed against it;
     the recall of each retrieval path against its plain path (within
     0.002); then one counted run of the six probes' run_* functions;
 13. the recommender program: `crypto_rec_tpu_torch.main -validate` (default
     engine and device) on a synthetic reference-format dataset of 20,000
     users, 400,000 tweets and 15 coins: phase A must take the csr engine
     (with its truncation log) and K2 must run; the output file's four
     headers, four "Execution Time:" lines and coin names, the phase ms,
     the MAE and the peak device memory; a rerun in the same process must
     write the same file; the native ingest against one timed Python
     score_tweets (equal batches); K2 against its plain version at the
     pipeline's index shape (d = 15);
 14. 10-fold CV at BENCH_CV.json's point (200,000 users x 128 coins,
     bench_cv.py's population, cosine k = 10, L = 6, budget 512, fused):
     K1 on f32 slabs (d = 128, win 640) against its plain version on every
     window of one fold and timed, K2 at the fold's build; then one
     counted ten_fold_mae: K1, K2 and the CF prediction kernel must run,
     and the MAE must lie within 0.03 of the JAX package's 1.4802 (the
     mean predictor's MAE beside it);
 15. candidate_ids_scored on phase 5's 2M x 128 int8 index at q = 8,192,
     budget 256, counted: K1 must run, set recall@10 against the planted
     truth >= 0.999;
 16. the program on the card against the program on the CPU: `main
     -validate` with --engine mask, csr and fused on 4,000 users x 15
     coins, once on the card and once with --device cpu; every differing
     recommendation line must be an exact tie or a near-tie (1e-5) in the
     neighbour sims or the predicted scores (counts printed);
 17. `main -validate --engine fused` on phase 13's dataset: phase A at
     d = 15 through packed_retrieve_core, counted (K2 must run);
 18. the retrieval paths that run no kernel, on phase 5's corpus at
     q = 8,192: `serve_cli retrieve` without --pack (recall@10 >= 0.99),
     cosine per-row int8 (>= 0.99) and unaugmented euclidean per-row int8
     at phase 9's point (>= 0.98) through packed_retrieve_core and the
     rerank, a single cosine cube with 20 probes (the blocked branch,
     >= 0.96), and pack_index_host's int8 slabs equal to pack_index's byte
     for byte; on the per-row int8 index, K1 with packed_scale against its
     plain version on every window (both masks), timed with and without
     the scale, and packed_retrieve_pallas with the scale (production and
     strict, counted: K1 must run) at recall@10 >= 0.99;
 19. the streamed index: bench_100m.py's planted recipe cut from 100M to
     16M x 128 rows (4 chunks, k = 15, L = 4, window 256, q = 16,384,
     pinned host chunks): K1 against its plain version on every window of
     chunk 0; five passes alternating with five copies of every chunk's
     bytes alone (the copy rate the pass is held against); then a counted
     pass: K1 and K2 must run, recall@10 >= 0.95, device peak under three
     chunks; the chunks' 16M f32 rows kept on the host (8.2 GB) and
     exact_nearest_streamed over 1,024 queries in 2^20-row slices: its
     agreement with the planted truth (>= 0.99) and seconds;
 20. IVF at bench_ivf.py's point (1,953 clusters, k-means on 262,144 rows
     x 8 iterations, bf16 blocks), nprobe 2/4/8/16 at q = 8,192 with q/s
     and recall@10; recall >= 0.99 at nprobe 16;
 21. the CLIs, counted: cluster_cli on phase 13's 400,000 x 16
     embeddings (k = 6; lloyd, lsh and cube under kmeans; pam on the
     first 20,000 rows) with silhouettes, K2 on lsh and cube; serve_cli
     recommend on phase 13's users saved with save_user_matrix (K2);
 22. the sharded engines (parallel/) on phase 5's corpus and index point
     under a NCCL process group of world size 1, mp = 1 and 4 logical
     shards in the one process: build (K2), int8 pack,
     sharded_retrieve_topk and sharded_recommend_scored (K1), counted;
     recall@10 >= 0.99 and within 0.002 of phase 5's; at mp = 4 the four
     shards' single-chip retrieve_topk merged with ops/topk must equal
     the sharded result (ids exact, scores within 1e-5), K1 against its
     plain version on shard 0's windows, sharded_recommend_csr (budget
     256), routed_retrieve_topk (csr interior) and the dense
     sharded_recommend at q = 512, each recall@10 >= 0.99, with their
     stats;
 23. the top-k sites repaired to tie order (exact_nearest, its streamed
     merge, directed_probe_vertices, rerank_exact, the epilogue's dedup
     top-k), each on inputs full of exact ties on the card and on the CPU:
     0 differing sets and orders;
 24. S1 (`window_topk`, the stage-1 selection of every K1 path) at every
     (rows, m, k) it was launched at in phases 5-22, on tied rows
     (integers, +-0, +-inf, NaN, -inf runs): equal to topk_desc bit for
     bit on the card and, on the first S1_CPU_ROWS rows, to topk_desc on
     the CPU (0 differing sets and orders); timed beside torch.topk (the
     library yardstick) and topk_desc with its byte bound.
     Phases 5, 9 and 10 also hold S1 against topk_desc on the dots their
     paths selected from, and time it there;
 25. wide rows, the public sets' shapes on planted corpora made from the
     seed: (a) cosine 1,000,000 x 1,536 (dbpedia-openai-1000k-angular's
     shape; L = 8, k = 13, int8 slabs): build (K2 at d = 1,536),
     retrieve_topk at q = 8,192 (K2, K1, S1, dedup, rerank), then the
     single cosine cube at 40 probes x 992 (S1 over 40,960 lanes, two
     levels); (b) euclidean 1,000,000 x 960 (GIST-1M's shape; augmented
     int8, d_aug 1,024, L = 4); each counted, recall@10 against
     exact_nearest on 1,024 queries >= 0.90, K1 against its plain version
     on every window of the path's call, K2 ids against the plain
     version's; (c) the program's 15 coins (phase 13's dataset):
     ten_fold_mae fused beside mask, and candidate_ids_scored on f32
     slabs (K1 at d = 15, its f32 body), card against CPU, and on int8
     slabs (rows of 15 B: K1's tensor-core body in 4-element pieces); (d)
     K1's bodies off those paths: the CF cell's geometry (73,421 x 100,
     L = 8, window 287, int8: 4-byte words), counted, and bf16 rows of
     200 B on its windows (shifted words), then f32 d = 384 (FFMA in
     d-chunks), each against its plain version; (e) the CF engine at the
     CF cell's shape: the neighbours (P = 20) of all 73,421 users from
     (d)'s path, recommend_topk_retrieved counted (the prediction kernel
     `csrc/cfpredict.cu` and S1's top-5), the kernel against
     cf_predict_plain (rtol / atol 1e-5) and the top-5 against the stable
     sort's on the same predictions (equal); then S1 on
     tied rows at [R, 40,960] and [R, 131,072] k = 40 and [R, 8,192]
     k = 2,048, bit for bit against topk_desc.  Times: CUDA events and
     the profiler's device time of each kernel, with its bound.

Times are CUDA-event medians of alternating rounds: K2 against one
torch.matmul(x, proj) (the library yardstick, TF32 off) and the plain
version; K1 against the plain version at every geometry of phases 4, 5, 8, 9 and 10 (the plain version is not timed on
the two euclidean cubes, where a call takes seconds; phase 8 checks it
at their geometry).  Each time stands beside its bound
(`ops/kernels/bounds.py`: unique bytes over 3.35 TB/s against FLOPs over
the unit's peak) and the card's nvidia-smi line.

Each kernel wrapper counts its launches.  The counts are zeroed just before
each path's counted run (phase 5: build, pack, retrieve and CF-score 8,192
users; phases 9 and 10: build, pack and retrieve; phases 6-7 and 11 as
wholes; phase 12: the six probes; phase 13: the program's run; phase 14:
ten_fold_mae; phase 15: one candidate_ids_scored call; phases 17, 19
and 21: the fused program, the streamed pass, each CLI run; phase 22:
build, pack, retrieve and scored CF at each mp) and read just after it;
each kernel of the path must show > 0, and every counted run that
launches K1 must show S1 too (`check_s1`); phase 25 counts each of its
paths apart.
The comparisons and timings run outside those windows.  The second-to-last
line is a JSON object with each kernel's route, source, main-path launches,
error against its plain version, times, bound and share of it, every
geometry and each path's launches, and the new paths' results; the
last line is {"ok": true, "device": ...}.  The script's wall time is
printed before them.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import itertools
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N, D, K, L = 2_000_000, 128, 13, 8
PER_TABLE = 488            # bench.py's window: 2 * N / 2^k
TOP_P, TOP_N, TOP_K = 20, 5, 10
BATCHES = (8192, 32768)
SEED = 0
REQ_Q = 1024               # queries per serving request


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps=5):
    """Median device time of fn() over reps runs (CUDA events), warm."""
    from crypto_rec_tpu_torch.experiments._common import timed

    return timed(fn, torch.device("cuda"), reps)[0]


def wall_ms(fn, reps=5):
    """Median host time of fn() + synchronize over reps runs, warm."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


ROUNDS = 5                 # alternating timing rounds (3 at the large paths)
CARD = ""                  # nvidia-smi's name and power limit, set in main
T_START = 0.0              # the script's start (perf_counter), set in main
DEV = torch.device("cuda")


def rounds_ms(fns, rounds=ROUNDS):
    """{key: median CUDA-event ms over `rounds` alternating rounds} after
    one warm run of each fn, so drift on the card falls on all alike; a fn
    given as None is not timed (None)."""
    from crypto_rec_tpu_torch.experiments._common import timed_alternating

    live = {k: f for k, f in fns.items() if f is not None}
    t = timed_alternating(live, torch.device("cuda"), rounds)
    return {k: statistics.median(t[k]) if k in t else None for k in fns}


def with_bound(entry, b):
    """entry + its bound (bounds.py), share of bound = bound / ms, the card."""
    entry.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"], peak=b["peak"],
                 unique_bytes=b["bytes"], flops=b["flops"],
                 share_of_bound=b["bound_ms"] / entry["ms"], card=CARD)
    if "ffma_bound_ms" in b:
        entry["ffma_bound_ms"] = b["ffma_bound_ms"]
    return entry


def check_k2(corpus, proj, k, L):
    """K2 against its plain version on every corpus row.  A row may differ
    only where a projection lies within 1e-5 |x||r| of 0 (f32 summation
    order decides its sign); any other difference raises.  Then the kernel,
    one torch.matmul(x, proj) (the library yardstick, TF32 off) and the
    plain version in alternating rounds."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.signproj import (
        signproj_bucket_ids, signproj_bucket_ids_plain,
    )

    n = corpus.shape[0]
    ids_k = signproj_bucket_ids(corpus, proj, k, L)
    ids_p = signproj_bucket_ids_plain(corpus, proj, k, L)
    bad = (ids_k != ids_p).any(dim=1)
    near0 = torch.zeros(n, dtype=torch.bool, device=corpus.device)
    for s in range(0, n, 1 << 18):
        x = corpus[s:s + (1 << 18)]
        acc = (x @ proj).abs()
        lim = 1e-5 * x.norm(dim=1, keepdim=True) * proj.norm(dim=0)[None, :]
        near0[s:s + (1 << 18)] = (acc <= lim).any(dim=1)
    n_unexplained = int((bad & ~near0).sum())
    if n_unexplained:
        raise AssertionError(f"K2: {n_unexplained} rows differ away from 0")
    max_err = float((ids_k - ids_p).abs().max())
    del ids_k, ids_p
    t = rounds_ms({"ms": lambda: signproj_bucket_ids(corpus, proj, k, L),
                   "library_ms": lambda: torch.matmul(corpus, proj),
                   "plain_ms": lambda: signproj_bucket_ids_plain(corpus, proj, k, L)})
    entry = dict(geometry=f"L = {L}, k = {k}, [{n}, {corpus.shape[1]}] x "
                          f"[{corpus.shape[1]}, {L * k}]",
                 rows_differ=int(bad.sum()), rows_near_zero=int(near0.sum()),
                 max_abs_err=max_err, **t)
    return with_bound(entry, bounds.k2_call(n, corpus.shape[1], k, L))


def k2_line(phase, e):
    log(f"phase {phase} K2 signproj {e['geometry']}: {e['rows_differ']} rows differ "
        f"({e['rows_near_zero']} rows have a projection within 1e-5 |x||r| of 0); "
        f"{ROUNDS} alternating rounds: kernel {e['ms']:.3f} ms, torch.matmul "
        f"{e['library_ms']:.3f}, plain {e['plain_ms']:.3f}; bound {e['bound_ms']:.3f} ms ({e['bound_by']}, "
        f"{e['peak']}): {100 * e['share_of_bound']:.1f}% of it")


def k1_check(label, packed, s0, sizes, qk, per_table, shared_slab, packed_scale=None):
    """The tile-major K1 against its plain version on every given window,
    both mask modes: aligned starts equal, masked lanes equal, dots within
    rtol 1e-5 / atol 1e-4 (with a per-row packed_scale, atol 1e-4 times
    the largest scale: the unscaled dots' tolerance).  -> max |err| over
    the finite lanes."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_window_dots, slab_window_dots_plain,
    )

    err = 0.0
    atol = 1e-4 if packed_scale is None else 1e-4 * float(packed_scale.max())
    for mask in (True, False):
        a = (packed, s0, sizes, qk, per_table)
        kw = dict(mask=mask, shared_slab=shared_slab, packed_scale=packed_scale)
        dk, ak = slab_window_dots(*a, **kw)
        dp, ap = slab_window_dots_plain(*a, **kw)
        torch.cuda.synchronize()
        if not torch.equal(ak, ap):
            raise AssertionError(f"K1 {label}: aligned starts differ")
        fin = torch.isfinite(dp)
        if not torch.equal(fin, torch.isfinite(dk)):
            raise AssertionError(f"K1 {label}: masked lanes differ")
        if not torch.allclose(dk[fin], dp[fin], rtol=1e-5, atol=atol):
            raise AssertionError(f"K1 {label}: dots differ beyond rtol 1e-5, atol {atol:.3g}")
        err = max(err, float((dk[fin] - dp[fin]).abs().max()))
        del dk, dp, fin
    return err


def k1_time(label, packed, s0, sizes, qk, per_table, shared_slab, plain=True,
            rounds=ROUNDS):
    """The tile-major K1 and (plain=True) the plain version, mask off, in
    alternating rounds on the same windows, with the call's bound.  K1 has no one PyTorch call for a
    library yardstick (a gather and an einsum are two): library_ms is None."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_window_dots, slab_window_dots_plain, window_len,
    )

    a = (packed, s0, sizes, qk, per_table)
    kw = dict(mask=False, shared_slab=shared_slab)
    t = rounds_ms({"ms": lambda: slab_window_dots(*a, **kw),
                   "plain_ms": (lambda: slab_window_dots_plain(*a, **kw)) if plain else None},
                  rounds)
    entry = dict(geometry=label, slab=list(packed.shape), dtype=str(packed.dtype)[6:],
                 per_table=per_table, win=window_len(per_table), rows=int(s0.shape[0]),
                 windows_per_row=int(s0.shape[1]), library_ms=None, **t)
    return with_bound(entry, bounds.k1_call(packed, s0, sizes, qk, per_table, shared_slab))


def k1_line(phase, e, err=None):
    plain = "not timed" if e["plain_ms"] is None else f"{e['plain_ms']:.3f} ms"
    chk = "" if err is None else f"max |err| {err:.3g} (mask on/off, every window); "
    log(f"phase {phase} K1 {e['geometry']}: slab {e['slab']} {e['dtype']}, win "
        f"{e['win']}, {e['rows']} rows x {e['windows_per_row']} windows: {chk}"
        f"tile-major {e['ms']:.3f} ms, plain {plain}; "
        f"bound {e['bound_ms']:.3f} ms ({e['bound_by']}; f32 FFMA floor "
        f"{e['ffma_bound_ms']:.3f} ms): {100 * e['share_of_bound']:.1f}% of it")


def k1_scale_time(label, packed, scale, s0, sizes, qk, per_table, rounds=ROUNDS):
    """K1 with the per-row scale, the same K1 call without it and the
    plain version with it, mask off, in alternating rounds on the same
    windows, with the bound of the call with the scale.  No one PyTorch
    call computes K1: library_ms is None."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_window_dots, slab_window_dots_plain, window_len,
    )

    a = (packed, s0, sizes, qk, per_table)
    t = rounds_ms({"ms": lambda: slab_window_dots(*a, mask=False, packed_scale=scale),
                   "unscaled_ms": lambda: slab_window_dots(*a, mask=False),
                   "plain_ms": lambda: slab_window_dots_plain(*a, mask=False,
                                                              packed_scale=scale)},
                  rounds)
    entry = dict(geometry=label, slab=list(packed.shape), dtype=str(packed.dtype)[6:],
                 per_table=per_table, win=window_len(per_table), rows=int(s0.shape[0]),
                 windows_per_row=int(s0.shape[1]), library_ms=None, **t)
    return with_bound(entry, bounds.k1_call(packed, s0, sizes, qk, per_table,
                                            packed_scale=scale))


def serve_requests(tmp, idx_path, corpus_path, q_host, true_host, args):
    """Three requests of REQ_Q queries through `serve_cli retrieve` with
    `args`; yields (request, seconds, recall@TOP_K against the planted
    truth).  Raises on a non-zero exit or a malformed answer."""
    from crypto_rec_tpu_torch import serve_cli

    for req in range(3):
        lo = req * REQ_Q
        qpath = os.path.join(tmp, f"q{req}.csv")
        with open(qpath, "w") as f:
            for i in range(lo, lo + REQ_Q):
                f.write(",".join([f"u{i}"] + [f"{v:.7g}" for v in q_host[i]]) + "\n")
        out = os.path.join(tmp, f"out{req}.tsv")
        t0 = time.perf_counter()
        rc = serve_cli.main(["retrieve", "--index", idx_path, "--corpus", corpus_path,
                             "--queries", qpath, "--top-k", str(TOP_K), *args,
                             "-o", out])
        t_req = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"serve_cli exited {rc}")
        with open(out) as f:
            lines = f.read().splitlines()
        if len(lines) != REQ_Q:
            raise AssertionError(f"request {req}: {len(lines)} lines")
        hits = 0
        for i, line in zip(range(lo, lo + REQ_Q), lines):
            toks = line.split("\t")
            if toks[0] != f"u{i}" or len(toks) != 1 + TOP_K:
                raise AssertionError(f"request {req}: bad line {line[:80]!r}")
            rows = {int(t.split(":")[0]) for t in toks[1:]}
            hits += len(rows & set(true_host[i].tolist()))
        yield req, t_req, hits / (REQ_Q * TOP_K)

# bench.py's euclidean and cube legs on the same corpus (bench.py:516-569,
# :623-766): euclidean p-stable k = 5, L = 4, w = 20, n / 4 buckets,
# window 768; cubes of k = 13 bits; q = 32,768; int8 slabs throughout.
E_K, E_L, E_W, E_DIV, E_PT, E_FLOOR = 5, 4, 20.0, 4, 768, 0.98
CK, CQ, GEOM_Q = 13, 32768, 1024
# (name, metric, cubes, probes per cube, per_probe, w, recall@10 floor);
# each floor sits a little under the JAX package's recall at the same
# point (BENCH_r05.json), except the single euclidean cube's: its recall
# depends on the draw of its 13 functions (0.63-0.87 over eight seeds on
# this corpus, tools/chip_probes/euclid_cube_draws.py; the JAX package's
# own draw gives 0.84 through the port), so its floor sits under the
# lowest draw seen
CUBE_LEGS = (
    ("cosine MultiCube", "cosine", 2, 12, 488, 1.0, 0.99),
    ("single cosine cube", "cosine", 1, 16, 976, 1.0, 0.96),
    ("euclidean cube", "euclidean", 1, 64, 976, 8.0, 0.60),
    ("euclidean MultiCube", "euclidean", 3, 24, 976, 8.0, 0.96),
)


def _counters():
    from crypto_rec_tpu_torch.ops.kernels.binned import binned_dots
    from crypto_rec_tpu_torch.ops.kernels.blkslab import blk_window_dots
    from crypto_rec_tpu_torch.ops.kernels.cfpredict import cf_predict
    from crypto_rec_tpu_torch.ops.kernels.int4slab import slab_window_dots_int4
    from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids
    from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_window_dots
    from crypto_rec_tpu_torch.ops.kernels.slabvariants import (
        i8_dots, load_floor, rounded_query_dots,
    )
    from crypto_rec_tpu_torch.ops.kernels.deduptopk import dedup_topk
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk

    return (signproj_bucket_ids, slab_window_dots, window_topk, binned_dots,
            slab_window_dots_int4, load_floor, rounded_query_dots, i8_dots, blk_window_dots,
            cf_predict, dedup_topk)


def zero_counts():
    for fn in _counters():
        fn.launches = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in _counters()}


def gen(seed):
    return torch.Generator().manual_seed(seed)


def unit(x):
    return torch.nn.functional.normalize(x.float(), dim=1)


def grouped(s0, sizes, q_kernel, group=8):
    """[q, T] windows -> T/group replicated query rows of `group` windows,
    the shared-slab K1 call of the cube paths."""
    R = s0.shape[1] // group
    return (s0.reshape(-1, group), sizes.reshape(-1, group),
            q_kernel.repeat_interleave(R, dim=0))


def check_topk(scores, ids, q, n, label):
    """Shapes, ids in range, finite and descending scores on real ids."""
    if tuple(scores.shape) != (q, TOP_K) or tuple(ids.shape) != (q, TOP_K):
        raise AssertionError(f"{label}: output shapes {tuple(ids.shape)}")
    if not bool(((ids >= -1) & (ids < n)).all()):
        raise AssertionError(f"{label}: row id out of range")
    real = ids >= 0
    if not bool(torch.isfinite(scores[real]).all()):
        raise AssertionError(f"{label}: non-finite score on a returned row")
    if not bool((scores[:, :-1] >= scores[:, 1:]).all()):
        raise AssertionError(f"{label}: scores not descending")


def compare_k1(label, packed, s0, sizes, qk, per_table, shared_slab):
    """Phase 8: K1 checked on every window of the geometry, then timed."""
    err = k1_check(label, packed, s0, sizes, qk, per_table, shared_slab)
    e = k1_time(label, packed, s0, sizes, qk, per_table, shared_slab)
    e["max_abs_err"] = err
    k1_line(8, e, err)
    return e


def phase8(corpus, queries):
    """K1 at the three new geometries and K2 at L = 1, each against its
    plain version.  The slabs and windows come from the paths' own build
    and window functions on the planted corpus."""
    from crypto_rec_tpu_torch.models.lsh.hypercube import build_multicube, multicube_windows
    from crypto_rec_tpu_torch.models.lsh.index import build_index, pack_index, query_hashes
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        augment_queries, euclid_window_offsets,
    )

    geoms = []
    qn = BATCHES[0]
    qs = queries[:qn]
    eidx = pack_index(build_index(gen(SEED + 21), corpus, "euclidean", E_K, E_L,
                                  lsh_bucket_div=E_DIV, euclidean_h_w=E_W),
                      corpus, dtype=torch.int8, augment=True)
    qb, qd = query_hashes(eidx, qs)
    s0, sizes = euclid_window_offsets(eidx.bucket_starts, eidx.packed_detailed, qb, qd, E_PT)
    q_aug = augment_queries(qs, eidx.packed_aug_scale, eidx.packed.shape[2])
    geoms.append(compare_k1(f"euclidean LSH, augmented int8, q = {qn}", eidx.packed,
                            s0, sizes, q_aug, E_PT, False))
    del eidx, s0, sizes, q_aug
    torch.cuda.empty_cache()

    qs = queries[:GEOM_Q]
    mc = build_multicube(gen(SEED + 7), corpus, "cosine", 2, CK, 1.0,
                         corpus_dtype=torch.int8)
    proj = mc.cubes[0].family.proj
    k2 = check_k2(corpus, proj, CK, 1)
    k2["geometry"] += " (cosine cube vertices)"
    k2_line(8, k2)
    rows = grouped(*multicube_windows(mc, qs, 12, 488), unit(qs))
    geoms.append(compare_k1(f"cosine MultiCube, shared slab int8, q = {GEOM_Q}",
                            mc.packed, *rows, 488, True))
    del mc, rows
    torch.cuda.empty_cache()

    mc = build_multicube(gen(SEED + 8), corpus, "euclidean", 3, CK, 8.0,
                         corpus_dtype=torch.int8)
    q_aug = augment_queries(qs, mc.packed_aug_scale, mc.packed.shape[2])
    rows = grouped(*multicube_windows(mc, qs, 24, 976), q_aug)
    geoms.append(compare_k1(f"euclidean MultiCube, shared augmented int8, q = {GEOM_Q}",
                            mc.packed, *rows, 976, True))
    del mc, rows
    torch.cuda.empty_cache()
    return geoms, k2


def phase9(corpus, queries, true_idx):
    """Euclidean p-stable LSH, counted: build, int8 augmented pack and
    top-10 retrieval (2x over-fetch, exact rerank) at q = 32,768."""
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, query_hashes, retrieve_topk,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        augment_queries, euclid_window_offsets,
    )
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    qs = queries[:CQ]
    zero_counts()
    t0 = time.perf_counter()
    eidx = build_index(gen(SEED + 21), corpus, "euclidean", E_K, E_L,
                       lsh_bucket_div=E_DIV, euclidean_h_w=E_W)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    pidx = pack_index(eidx, corpus, dtype=torch.int8, augment=True)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0

    def run():
        return retrieve_topk(pidx, qs, corpus, top_k=TOP_K, per_table=E_PT)

    scores, ids = run()
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"phase 9 euclidean LSH launches (build + pack + retrieve, q={CQ}): {launches}")
    if not launches["slab_window_dots"]:
        raise AssertionError("euclidean LSH: K1 did not run")
    check_s1("euclidean LSH", launches)
    s1_check_kept(9)
    check_topk(scores, ids, CQ, N, "euclidean LSH")
    # the reranked scores are the returned rows' true negated distances
    dist = (qs[:256, None, :] - corpus[ids[:256].clamp(min=0).long()]).norm(dim=2)
    if not torch.allclose(-scores[:256], dist, rtol=1e-4, atol=1e-4):
        raise AssertionError("euclidean LSH: scores are not the rows' distances")
    recall = recall_at_k(ids, true_idx[:CQ])
    t_ret = wall_ms(run)
    t_dev = cuda_ms(run)

    def windows():   # hash, fingerprint-run search, augmented queries
        qb, qd = query_hashes(pidx, qs)
        return (*euclid_window_offsets(pidx.bucket_starts, pidx.packed_detailed,
                                       qb, qd, E_PT),
                augment_queries(qs, pidx.packed_aug_scale, pidx.packed.shape[2]))

    t_win = cuda_ms(windows)
    s0, sizes, q_aug = windows()
    k1 = k1_time(f"euclidean LSH, augmented int8, q = {CQ}", pidx.packed, s0, sizes,
                 q_aug, E_PT, False, rounds=3)
    k1_line(9, k1)
    t_k1 = k1["ms"]
    log(f"phase 9 euclidean LSH k={E_K} L={E_L} w={E_W} window {E_PT} int8 augmented "
        f"(slabs {list(pidx.packed.shape)}): build {t_build:.3f} s, pack {t_pack:.3f} s; "
        f"q={CQ}: retrieval {t_ret:.3f} ms ({CQ / t_ret * 1e3:,.0f} q/s); device "
        f"{t_dev:.3f} ms = windows {t_win:.3f} + K1 {t_k1:.3f} + stage 1, dedup and "
        f"rerank {t_dev - t_win - t_k1:.3f}; recall@{TOP_K} {recall:.4f} (floor {E_FLOOR})")
    if recall < E_FLOOR:
        raise AssertionError(f"euclidean LSH recall@{TOP_K} {recall:.4f} < {E_FLOOR}")
    del pidx, s0, sizes, q_aug
    torch.cuda.empty_cache()
    return eidx, dict(launches=launches, build_s=t_build, pack_s=t_pack,
                      retrieval_ms=t_ret, qps=CQ / t_ret * 1e3, device_ms=t_dev,
                      windows_ms=t_win, k1_ms=t_k1, recall=recall, floor=E_FLOOR,
                      k1=k1)


def cube_leg(corpus, queries, true_idx, name, metric, cubes, probes, per_probe, w,
             floor, seed):
    """One cube leg of phase 10, counted: build (+ pack), retrieve."""
    from crypto_rec_tpu_torch.models.lsh.hypercube import (
        build_hypercube, build_multicube, cube_retrieve_topk, cube_windows,
        multicube_retrieve_topk, multicube_windows, pack_cube,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import augment_queries
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    qs = queries[:CQ]
    zero_counts()
    t0 = time.perf_counter()
    if cubes > 1:
        obj = build_multicube(gen(seed), corpus, metric, cubes, CK, w,
                              corpus_dtype=torch.int8)

        def run():
            return multicube_retrieve_topk(obj, qs, TOP_K, probes, per_probe)

        def windows():
            return multicube_windows(obj, qs, probes, per_probe)
    else:
        obj = pack_cube(build_hypercube(gen(seed), corpus, metric, CK, w), corpus,
                        dtype=torch.int8, augment=metric == "euclidean")

        def run():
            return cube_retrieve_topk(obj, qs, corpus, TOP_K, probes, per_probe)

        def windows():
            return cube_windows(obj, qs, probes, per_probe)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    scores, ids = run()
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"phase 10 {name} launches (build + pack + retrieve, q={CQ}): {launches}")
    if not launches["slab_window_dots"]:
        raise AssertionError(f"{name}: K1 did not run")
    if metric == "cosine" and not launches["signproj_bucket_ids"]:
        raise AssertionError(f"{name}: K2 did not run")
    check_s1(name, launches)
    s1_check_kept(10)
    check_topk(scores, ids, CQ, N, name)
    recall = recall_at_k(ids, true_idx[:CQ])
    del scores, ids
    t_ret = wall_ms(run, reps=3)
    t_dev = cuda_ms(run, reps=3)
    qk = (unit(qs) if metric == "cosine"
          else augment_queries(qs, obj.packed_aug_scale, obj.packed.shape[2]))
    t_win = cuda_ms(windows, reps=3)      # probe vertices (K2 for cosine) + offsets
    rows = grouped(*windows(), qk)
    # the plain version takes seconds a call on the euclidean cubes: it is
    # checked at their geometry in phase 8 and not timed here
    k1 = k1_time(f"{name}, q = {CQ}", obj.packed, *rows, per_probe, True,
                 plain=metric == "cosine", rounds=3)
    k1_line(10, k1)
    t_k1 = k1["ms"]
    log(f"phase 10 {name}: C={cubes} k={CK} probes={probes}/cube window {per_probe} "
        f"(slab {list(obj.packed.shape)}): build + pack {t_build:.3f} s; q={CQ}: "
        f"retrieval {t_ret:.3f} ms ({CQ / t_ret * 1e3:,.0f} q/s); device {t_dev:.3f} ms "
        f"= probes {t_win:.3f} + K1 {t_k1:.3f} + stage 1, dedup and scores "
        f"{t_dev - t_win - t_k1:.3f}; recall@{TOP_K} {recall:.4f} (floor {floor})")
    if recall < floor:
        raise AssertionError(f"{name}: recall@{TOP_K} {recall:.4f} < {floor}")
    del obj, rows
    torch.cuda.empty_cache()
    return dict(launches=launches, build_pack_s=t_build, retrieval_ms=t_ret,
                qps=CQ / t_ret * 1e3, device_ms=t_dev, windows_ms=t_win, k1_ms=t_k1,
                recall=recall, floor=floor, k1=k1)


def phase11(eidx, corpus, q_host, true_host):
    """Serving a saved euclidean archive: `retrieve --pack --augment`."""
    import numpy as np
    from crypto_rec_tpu_torch import checkpoint

    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        idx_path = os.path.join(tmp, "idx.npz")
        checkpoint.save_index(idx_path, eidx)           # unpacked
        corpus_path = os.path.join(tmp, "corpus.npz")
        np.savez(corpus_path, vectors=corpus.cpu().numpy())
        out = []
        for req, t_req, recall in serve_requests(
                tmp, idx_path, corpus_path, q_host, true_host,
                ["--per-table", str(E_PT), "--pack", "--augment"]):
            log(f"phase 11 request {req}: {REQ_Q} queries answered in {t_req:.2f} s "
                f"(restore + bf16 augmented pack + retrieve), recall@{TOP_K} "
                f"{recall:.4f} (floor {E_FLOOR})")
            if recall < E_FLOOR:
                raise AssertionError(f"request {req}: served recall too low")
            out.append(dict(seconds=t_req, recall=recall))
    launches = read_counts()
    log(f"phase 11 launches: {launches}")
    if not launches["slab_window_dots"]:
        raise AssertionError("serving: K1 did not run")
    check_s1("serving --pack --augment", launches)
    return dict(launches=launches, requests=out)


# the probe kernels' operating point (benchmarks/experiments/): cosine
# k = 13, L = 8, window 488, q = 8,192 (P6: 32,768); kernel-vs-plain errors
# on the first CHECK_Q queries
PQ, P6Q, CHECK_Q, RECALL_TOL = 8192, 32768, 2048, 0.002
DOT_TOL = dict(rtol=1e-5, atol=1e-4)      # summation order only (as phase 8)


def _close(label, got, want):
    """Dots within DOT_TOL -> max |err|; raises otherwise."""
    if got.shape != want.shape or not torch.allclose(got, want, **DOT_TOL):
        raise AssertionError(f"{label}: kernel and plain differ beyond rtol 1e-5, atol 1e-4")
    return float((got - want).abs().max())


def _same_recall(label, ids_k, ids_p, truth):
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    rk, rp = recall_at_k(ids_k, truth), recall_at_k(ids_p, truth)
    log(f"phase 12 {label}: recall@{TOP_K} kernel path {rk:.4f}, plain path {rp:.4f}")
    if abs(rk - rp) > RECALL_TOL:
        raise AssertionError(f"{label}: kernel recall {rk:.4f} vs plain {rp:.4f}")
    return dict(recall=rk, plain_recall=rp)


def _timed_pair(kern, plain, p, row_bytes, windows=None, bound=None):
    """Kernel and plain version in alternating rounds, with the bound of the kernel's call on its windows: covered slab rows x
    row_bytes, the queries and the kernel's outputs, 2 d FLOP a window lane
    on bf16 tensor cores.  windows: (row0 [q, L] absolute first rows, win)
    of the kernel's own geometry; None takes K1's (32-row aligned starts).
    bound: a function of the kernel's outputs giving the bound in its
    place (P2 / P4: `bounds.variant_call`).  No one PyTorch call computes
    a probe kernel's function (a gather and an einsum are two): library_ms
    is None."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _geometry, window_len

    t = rounds_ms({"ms": kern, "plain_ms": plain})
    outs = [o for o in kern() if isinstance(o, torch.Tensor)]
    if bound is not None:
        return with_bound(dict(library_ms=None, **t), bound(outs))
    row0, win = windows or (_geometry(p.packed, p.s0, None, p.per_table, False)[2],
                            window_len(p.per_table))
    b = bounds.window_call(row0, win, p.packed.shape[0] * p.packed.shape[1], row_bytes,
                           p.packed.shape[2], inputs=(p.qv,), outputs=outs)
    return with_bound(dict(library_ms=None, **t), b)


def check_binned(p):
    """P3 binned dots against the plain version at nbins 128 and 256:
    vals within DOT_TOL, aligned starts equal, no winning lane differing
    where the bin's best and second-best dots differ by more than the
    tolerance; times at q = PQ; the recall of both retrieval paths."""
    from crypto_rec_tpu_torch.ops.kernels.binned import (
        binned_dots, binned_dots_plain, binned_topk,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_window_dots_plain, window_len,
    )

    dname = str(p.packed.dtype)[6:]
    c = (p.packed, p.s0[:CHECK_Q], p.qv[:CHECK_Q], p.per_table)
    dots, _ = slab_window_dots_plain(c[0], c[1], None, c[2], c[3], mask=False)
    out = []
    for nbins in (128, 256):
        vk, pk, ak = binned_dots(*c, nbins)
        vp, pp, ap = binned_dots_plain(*c, nbins)
        torch.cuda.synchronize()
        if not torch.equal(ak, ap):
            raise AssertionError("binned: aligned starts differ")
        err = _close(f"binned {dname} nbins {nbins}", vk, vp)
        top2 = torch.topk(dots.reshape(CHECK_Q, -1, nbins), 2, dim=1).values
        clear = top2[:, 0] - top2[:, 1] > DOT_TOL["atol"] + DOT_TOL["rtol"] * top2[:, 0].abs()
        bad = int(((pk != pp) & clear).sum())
        if bad:
            raise AssertionError(f"binned {dname} nbins {nbins}: {bad} winners differ")
        a = (p.packed, p.s0, p.qv, p.per_table, nbins)
        res = dict(geometry=f"{dname} nbins {nbins}, q = {PQ}", max_abs_err=err,
                   pos_near_ties=int((~clear).sum()),
                   **_timed_pair(lambda: binned_dots(*a), lambda: binned_dots_plain(*a),
                                 p, p.packed.shape[2] * p.packed.element_size()))
        win = window_len(p.per_table)
        ids = [binned_topk(*f(*a), p.packed_rows, win, p.n_rows, TOP_K)[1]
               for f in (binned_dots, binned_dots_plain)]
        res.update(_same_recall(f"P3 binned {dname} nbins {nbins}", *ids, p.true_idx))
        log(f"phase 12 binned_dots {dname} nbins {nbins}: max |err| {err:.3g} over "
            f"{CHECK_Q} queries, 0 winners differ ({res['pos_near_ties']} near-tie bins "
            f"not compared); q={PQ}: tile-major {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.3f} ms ({100 * res['share_of_bound']:.1f}%)")
        out.append(res)
    return out


def check_int4(p):
    """P6 int4 dots against the plain version (DOT_TOL), times at q = P6Q,
    recall of both retrieval paths."""
    from crypto_rec_tpu_torch.ops.kernels.int4slab import (
        repack_int4, slab_topk_int4, slab_window_dots_int4, slab_window_dots_int4_plain,
    )

    p4 = repack_int4(p.packed)
    c = (p4, p.s0[:CHECK_Q], p.qv[:CHECK_Q], p.per_table)
    (dk, ak), (dp, ap) = slab_window_dots_int4(*c), slab_window_dots_int4_plain(*c)
    torch.cuda.synchronize()
    if not torch.equal(ak, ap):
        raise AssertionError("int4: aligned starts differ")
    err = _close("int4 dots", dk, dp)
    a = (p4, p.s0, p.qv, p.per_table)
    res = dict(geometry=f"uint8 {list(p4.shape)}, q = {P6Q}", max_abs_err=err,
               **_timed_pair(lambda: slab_window_dots_int4(*a),
                             lambda: slab_window_dots_int4_plain(*a), p,
                             p.packed.shape[2] / 2))
    ids = [slab_topk_int4(*f(*a), p.packed_rows, p.n_rows, TOP_K)[1]
           for f in (slab_window_dots_int4, slab_window_dots_int4_plain)]
    res.update(_same_recall("P6 int4", *ids, p.true_idx))
    log(f"phase 12 slab_window_dots_int4: max |err| {err:.3g} over {CHECK_Q} queries; "
        f"q={P6Q}: tile-major {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
        f"({100 * res['share_of_bound']:.1f}%)")
    return res


def check_variants(p16, p8):
    """P2 / P4 variant modes, the tile-major kernels of probetile.cu,
    against their plain versions: load_floor output and XOR fold exact
    (bf16 and int8), rounded_query (bf16) within DOT_TOL, i8_dot (int8) bit
    for bit; times at q = PQ and each one's bound (`bounds.variant_call`: load_floor no
    operations, i8_dot int8 tensor cores with int8 queries); the recall of
    the i8_dot retrieval path against its plain path."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_topk
    from crypto_rec_tpu_torch.ops.kernels.slabvariants import (
        quantize_queries, slab_window_variant, slab_window_variant_plain,
    )

    out = []
    for p, mode in ((p16, "load_floor"), (p8, "load_floor"), (p16, "rounded_query"),
                    (p8, "i8_dot")):
        dname = str(p.packed.dtype)[6:]
        qv = quantize_queries(p.qv) if mode == "i8_dot" else p.qv
        c = (p.packed, p.s0[:CHECK_Q], qv[:CHECK_Q], p.per_table, mode)
        got, want = slab_window_variant(*c), slab_window_variant_plain(*c)
        torch.cuda.synchronize()
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"{mode}: aligned starts differ")
        if mode == "rounded_query":
            err = _close(f"{mode} {dname}", got[0], want[0])
        elif not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{mode} {dname}: kernel and plain differ (must be exact)")
        else:
            err = 0.0
        a = (p.packed, p.s0, qv, p.per_table, mode)
        res = dict(geometry=f"{mode} {dname}, q = {PQ}", max_abs_err=err,
                   **_timed_pair(lambda: slab_window_variant(*a),
                                 lambda: slab_window_variant_plain(*a), p,
                                 p.packed.shape[2] * p.packed.element_size(),
                                 bound=lambda outs: bounds.variant_call(*a[:3], p.per_table,
                                                                        mode, outs)))
        if mode == "i8_dot":
            ids = [slab_topk(*f(*a), p.packed_rows, p.n_rows, TOP_K)[1]
                   for f in (slab_window_variant, slab_window_variant_plain)]
            res.update(_same_recall("P4 mxu_i8", *ids, p.true_idx))
        log(f"phase 12 slab_window_variant {mode} {dname}: max |err| {err:.3g} over "
            f"{CHECK_Q} queries{' (output and fold exact)' if len(got) == 3 else ''}; q={PQ}: "
            f"tile-major {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.3f} ms ({100 * res['share_of_bound']:.1f}%, {res['bound_by']})")
        out.append(res)
    return out


def check_blk(p):
    """P5 blocked dots (the tile-major kernel) against the plain version
    (DOT_TOL), times at q = PQ, and the bound on
    P5's own windows: 128-row aligned starts blk0 * 128, blk_window_len
    lanes."""
    from crypto_rec_tpu_torch.ops.kernels.blkslab import (
        B, _geometry_blk, blk_window_dots, blk_window_dots_plain, to_blk,
    )

    dname = str(p.packed.dtype)[6:]
    blk = to_blk(p.packed)
    c = (blk, p.s0[:CHECK_Q], p.qv[:CHECK_Q], p.per_table)
    (dk, ak), (dp, ap) = blk_window_dots(*c), blk_window_dots_plain(*c)
    torch.cuda.synchronize()
    if not torch.equal(ak, ap):
        raise AssertionError("blk: aligned starts differ")
    err = _close(f"blk {dname}", dk, dp)
    del dk, dp
    a = (blk, p.s0, p.qv, p.per_table)
    win, _, blk0 = _geometry_blk(blk, p.s0, p.per_table)
    res = dict(geometry=f"{dname} {list(blk.shape)}, q = {PQ}", max_abs_err=err,
               **_timed_pair(lambda: blk_window_dots(*a), lambda: blk_window_dots_plain(*a),
                             p, p.packed.shape[2] * p.packed.element_size(),
                             windows=(blk0 * B, win)))
    log(f"phase 12 blk_window_dots {dname}: max |err| {err:.3g} over {CHECK_Q} queries; "
        f"q={PQ}: tile-major {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.3f} ms ({100 * res['share_of_bound']:.1f}%)")
    return res


def check_k1_probes(p16, p8):
    """K1 without the mask as P1 (bf16) and P4's vpu (int8) run it: error
    against the plain version, times at q = PQ, and P4's vpu recall of
    both paths."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_topk, slab_window_dots, slab_window_dots_plain,
    )

    out = []
    for p in (p16, p8):
        dname = str(p.packed.dtype)[6:]
        c = (p.packed, p.s0[:CHECK_Q], p.sizes[:CHECK_Q], p.qv[:CHECK_Q], p.per_table)
        err = _close(f"K1 nomask {dname}", slab_window_dots(*c, mask=False)[0],
                     slab_window_dots_plain(*c, mask=False)[0])
        a = (p.packed, p.s0, p.sizes, p.qv, p.per_table)
        res = dict(geometry=f"mask off {dname}, q = {PQ}", max_abs_err=err,
                   **_timed_pair(lambda: slab_window_dots(*a, mask=False),
                                 lambda: slab_window_dots_plain(*a, mask=False), p,
                                 p.packed.shape[2] * p.packed.element_size()))
        if p is p8:
            ids = [slab_topk(*f(*a, mask=False), p.packed_rows, p.n_rows, TOP_K)[1]
                   for f in (slab_window_dots, slab_window_dots_plain)]
            res.update(_same_recall("P4 vpu", *ids, p.true_idx))
        log(f"phase 12 K1 (P1 dots_nomask) {dname}: max |err| {err:.3g} over {CHECK_Q} "
            f"queries; q={PQ}: tile-major {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms, bound "
            f"{res['bound_ms']:.3f} ms ({100 * res['share_of_bound']:.1f}%)")
        out.append(res)
    return out


def phase12(corpus, queries, true_idx, smi):
    """The probe kernels P1-P6 on one cosine index (k = 13, L = 8, K2) of
    the planted corpus, packed int8 and bf16: each kernel against its plain
    version, then one counted run of the six probes' run_* functions."""
    from crypto_rec_tpu_torch.experiments import _common as PC
    from crypto_rec_tpu_torch.experiments import (
        probe_r3_binned, probe_r3_final, probe_r3_mask, probe_r3_split, probe_r4_blk,
        probe_r5_int4,
    )
    from crypto_rec_tpu_torch.models.lsh.index import pack_index

    log(f"phase 12 probe kernels on {smi}")
    t0 = time.perf_counter()
    index = PC.build_cosine(corpus, SEED + 40)
    pidx8 = pack_index(index, corpus, dtype=torch.int8)
    pidx16 = pack_index(index, corpus, dtype=torch.bfloat16)
    p8 = PC.probe_index(pidx8, queries[:PQ], true_idx=true_idx[:PQ])
    p16 = PC.probe_index(pidx16, queries[:PQ], true_idx=true_idx[:PQ])
    p8w = PC.probe_index(pidx8, queries[:P6Q], true_idx=true_idx[:P6Q])
    del pidx8, pidx16
    torch.cuda.synchronize()
    log(f"phase 12 index: build + int8 and bf16 packs {time.perf_counter() - t0:.3f} s")

    checks = dict(k1=check_k1_probes(p16, p8), binned=check_binned(p8) + check_binned(p16),
                  int4=check_int4(p8w), variants=check_variants(p16, p8),
                  blk=[check_blk(p8), check_blk(p16)])
    torch.cuda.empty_cache()

    # the counted run: the six probes as their entry points run them
    zero_counts()
    res = dict(mask=probe_r3_mask.run_mask(p16), split=probe_r3_split.run_split(p16),
               floor_int8=probe_r3_split.floor_vs_k1(p8),
               binned_bf16=probe_r3_binned.run_binned(p16),
               binned_int8=probe_r3_binned.run_binned(p8),
               final=probe_r3_final.run_final(p16, p8),
               blk_int8=probe_r4_blk.run_blk(p8), blk_bf16=probe_r4_blk.run_blk(p16),
               int4=probe_r5_int4.run_int4(p8w))
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"phase 12 launches (the six probes' runs): {launches}")
    missing = [k for k, v in launches.items()
               if k not in ("signproj_bucket_ids", "cf_predict") and not v]
    if missing:
        raise AssertionError(f"phase 12: kernels not launched: {missing}")
    probe_r3_mask.report(res["mask"], PQ)
    probe_r3_split.report(res["split"], PQ)
    probe_r3_split.report_floor(res["floor_int8"])
    probe_r3_binned.report(res["binned_bf16"], "bf16", PQ)
    probe_r3_binned.report(res["binned_int8"], "int8", PQ)
    probe_r3_final.report(res["final"], PQ)
    probe_r4_blk.report(res["blk_int8"], "int8")
    probe_r4_blk.report(res["blk_bf16"], "bfloat16")
    probe_r5_int4.report(res["int4"], P6Q)
    if not res["mask"]["nomask_ge_masked"]:
        raise AssertionError("P1: maskless scores fall below masked ones")
    for key in ("blk_int8", "blk_bf16"):     # the probe's own parity number
        r = res[key]
        if r["max_abs_diff"] > DOT_TOL["atol"] + DOT_TOL["rtol"] * r["max_abs_dot"]:
            raise AssertionError(f"P5 {key}: blocked and row dots differ")
    return checks, res, launches


# phase 13: the recommender program at the first size at which the JAX
# package's "auto" rule sends phase A to the csr engine (q n = 4e8 >
# 2.56e8); 15 coins is the generator's cap (COIN_NAMES)
PIPE = dict(n_users=20000, n_tweets=400000, n_coins=15, emb_dim=16, p_header=20, seed=5)


class _Records(logging.Handler):
    """Keeps the messages a logger emits."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def phase13(tmp):
    """`python -m crypto_rec_tpu_torch.main -d tweets.tsv -o out.txt -c
    cluster.conf -validate` with the default engine and device, counted:
    K2 must run.  Checks the csr switch and its truncation log, the four
    headers and "Execution Time:" lines, the coin names, the summary; the
    native ingest against one timed Python score_tweets on the same file
    (equal batches); then K2 against its plain version at the pipeline's
    index shape.  The dataset stays in `tmp` for phases
    17 and 21."""
    from crypto_rec_tpu_torch import main as rec_main
    from crypto_rec_tpu_torch.io.ingest import CoinTable, score_tweets
    from crypto_rec_tpu_torch.io.native import score_tweets_native
    from crypto_rec_tpu_torch.io.readers import read_lexicon, read_str_vectors
    from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset
    from crypto_rec_tpu_torch.io.users import build_user_matrix
    from crypto_rec_tpu_torch.config import load_config
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.rec import pipeline

    t0 = time.perf_counter()
    tweets, conf = write_synthetic_dataset(os.path.join(tmp, "ds"), **PIPE)
    t_gen = time.perf_counter() - t0
    out = os.path.join(tmp, "out.txt")
    rec = _Records()
    pipeline.log.addHandler(rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()     # the smoke run's own tensors
    buf = io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = rec_main.main(["-d", tweets, "-o", out, "-c", conf, "-validate"])
        torch.cuda.synchronize()
    finally:
        pipeline.log.removeHandler(rec)
    t_run = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() - held
    if rc != 0:
        raise AssertionError(f"main exited {rc}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"phase 13 main -validate ({PIPE['n_users']} users, {PIPE['n_tweets']} tweets, "
        f"{PIPE['n_coins']} coins; dataset written in {t_gen:.1f} s): {t_run:.1f} s, "
        f"peak device memory {peak / 2**30:.2f} GiB above the {held / 2**30:.2f} GiB "
        f"held before; launches {launches}")
    for line in rec.lines:
        log(f"phase 13 log: {line}")
    if not launches["signproj_bucket_ids"]:
        raise AssertionError("the recommender program: K2 did not run")
    if not any("switching to the csr engine" in m for m in rec.lines):
        raise AssertionError("phase A did not take the csr engine")
    trunc = [m for m in rec.lines if m.startswith("csr engine")]
    if not trunc:
        raise AssertionError("the csr engine logged no truncation stats")
    with open(out) as f:
        lines = f.read().splitlines()
    cfg = load_config(conf)
    coin_rows, _ = read_str_vectors(cfg.query_file, cfg.csv_delimiter)
    names = {r[4] if len(r) > 4 else r[0] for r in coin_rows}
    headers = [x for x in lines if x in ("Cosine LSH", "Clustering Recommendation")]
    times = [x for x in lines if x.startswith("Execution Time: ")]
    recs = [x.split(" ") for x in lines if x not in headers and x not in times]
    if headers != ["Cosine LSH"] * 2 + ["Clustering Recommendation"] * 2:
        raise AssertionError(f"headers {headers}")
    if len(times) != 4:
        raise AssertionError(f"{len(times)} Execution Time lines")
    bad = [r for r in recs if not r[0].startswith("user") or not set(r[1:]) <= names]
    if bad:
        raise AssertionError(f"{len(bad)} lines name no known coin, e.g. {bad[0]}")
    mae = summary["mae_10fold"]
    want = {"phase0", "ingest", "lsh_A", "validate", "lsh_B", "cluster_A", "cluster_B"}
    if set(summary["phase_ms"]) != want or not np.isfinite(mae) or mae <= 0:
        raise AssertionError(f"summary {summary}")
    log(f"phase 13 output: {len(recs)} recommendation lines, headers {headers}, "
        f"{times}; {summary['n_users']} users, {summary['n_fake_users']} virtual "
        f"users; phase ms {summary['phase_ms']}; 10-fold CV MAE {mae:.4f}")
    # the same run again in this process (kernels loaded): the same seed
    # must write the same file, Execution Time lines aside
    out2 = os.path.join(tmp, "out2.txt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec_main.main(["-d", tweets, "-o", out2, "-c", conf, "-validate"])
    warm = json.loads(buf.getvalue().strip().splitlines()[-1])["phase_ms"]
    with open(out2) as f:
        lines2 = f.read().splitlines()
    if [x for x in lines2 if not x.startswith("Execution Time")] != \
            [x for x in lines if x not in times]:
        raise AssertionError("the same seed wrote another output file")
    log(f"phase 13 rerun in the same process: the same file; phase ms {warm}")
    # the program's native ingest against one Python score_tweets
    t0 = time.perf_counter()
    nat = score_tweets_native(tweets, cfg.lexicon_file, cfg.query_file, cfg.csv_delimiter)
    t_nat = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    rows, _ = read_str_vectors(tweets, cfg.csv_delimiter, with_header_p=True)
    py = score_tweets(rows, read_lexicon(cfg.lexicon_file, cfg.csv_delimiter),
                      CoinTable.from_rows(coin_rows))
    t_py = (time.perf_counter() - t0) * 1e3
    same = (nat.user_ids == py.user_ids and nat.tweet_ids == py.tweet_ids
            and nat.n_coins == py.n_coins
            and all(np.array_equal(getattr(nat, f), getattr(py, f))
                    for f in ("tweet_user", "scores", "pair_tweet", "pair_coin")))
    log(f"phase 13 ingest of {nat.n_tweets} tweets: native {t_nat:.0f} ms, Python "
        f"read + score_tweets {t_py:.0f} ms; batches {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("native and Python ingest differ")
    users = build_user_matrix(py)
    # K2 at the shape the pipeline hashes: the real users' ratings
    x = torch.from_numpy(users.ratings).to(DEV)
    proj = CosineLsh.create(gen(SEED + 50), x.shape[1], cfg.k, cfg.L, x.device).proj
    k2 = check_k2(x, proj, cfg.k, cfg.L)
    k2["geometry"] += " (the pipeline's cosine index, d = 15: two zero columns pad it)"
    k2_line(13, k2)
    return (tweets, conf), dict(
        launches=launches, seconds=t_run, dataset_s=t_gen, peak_bytes=peak,
        summary=summary, warm_phase_ms=warm, csr_log=trunc, lines=len(recs), k2=k2,
        ingest_native_ms=t_nat, ingest_python_ms=t_py)


# phase 14: 10-fold CV at BENCH_CV.json's point (benchmarks/bench_cv.py):
# 200,000 users x 128 coins, cosine k = 10, L = 6, fused engine (f32 slabs,
# per-table window = budget 512, win 640), top-20; the JAX package read MAE
# 1.4802 there (BENCH_CV.json)
CV = dict(n=200000, c=128, k=10, L=6, budget=512, top_p=20)
CV_JAX_MAE, CV_MAE_TOL = 1.4802, 0.03


def cv_population(n, c):
    """bench_cv.py's population (rng 13, 64 taste profiles, 30% known) ->
    (full ratings, imputed ratings, known, mean), numpy."""
    import numpy as np

    rng = np.random.default_rng(13)
    profiles = rng.gamma(2.0, 1.0, (64, c)).astype(np.float32)
    assign = rng.integers(0, 64, n)
    full = profiles[assign] + 0.15 * rng.standard_normal((n, c)).astype(np.float32)
    full = np.abs(full).astype(np.float32)
    known = rng.random((n, c)) < 0.3
    known[np.arange(n), rng.integers(0, c, n)] = True
    mean = ((full * known).sum(1) / np.maximum(known.sum(1), 1)).astype(np.float32)
    return full, np.where(known, full, mean[:, None]).astype(np.float32), known, mean


def mean_predictor_mae(full, known, c):
    """bench_cv.py:73-80: the hide-one protocol predicting only the
    re-imputed mean, on the first 20,000 users (rng 99)."""
    import numpy as np

    rng_b = np.random.default_rng(99)
    zeroed = np.where(known, full, 0.0)
    hide_j = np.array([rng_b.choice(np.flatnonzero(k)) for k in known[:20000]])
    rows = np.arange(len(hide_j))
    rest = zeroed[:20000].sum(1) - zeroed[rows, hide_j]
    return float(np.mean(np.abs(full[rows, hide_j] - rest / max(c - 1, 1))))


def phase14():
    """K1 on f32 slabs (d = 128) against its plain version on every window
    of one fold and timed; K2 at the fold's build; then one counted
    ten_fold_mae(engine="fused"): K1 and K2 must run, and the MAE must lie
    within CV_MAE_TOL of the JAX package's."""
    from crypto_rec_tpu_torch.models.lsh.index import build_index, pack_index, query_hashes
    from crypto_rec_tpu_torch.models.rec import validate
    from crypto_rec_tpu_torch.models.rec.engine import RatingSet
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets

    n, c, k, L, budget = CV["n"], CV["c"], CV["k"], CV["L"], CV["budget"]
    t0 = time.perf_counter()
    full, ratings, known, mean = cv_population(n, c)
    users = RatingSet(torch.from_numpy(ratings).cuda(), torch.from_numpy(known).cuda(),
                      torch.from_numpy(mean).cuda())
    log(f"phase 14 population {n} x {c} (bench_cv.py's recipe): "
        f"{time.perf_counter() - t0:.1f} s")
    # fold 0 as ten_fold_mae builds it, from the same draws
    draws = validate.draw_folds(gen(SEED + 17), users, "cosine", k, L, 1.0)
    folds = draws.folds.cuda()
    test = RatingSet(*(t[folds[0]] for t in (users.ratings, users.known, users.mean)))
    train_rows = folds[1:].reshape(-1)
    train = RatingSet(*(t[train_rows] for t in (users.ratings, users.known, users.mean)))
    hidden, _, _ = validate.hide_one_score(None, test.ratings, test.known, c,
                                           hide_idx=draws.hide_idx[0])
    k2 = check_k2(train.ratings, draws.families[0].proj, k, L)
    k2["geometry"] += " (a CV fold's index)"
    k2_line(14, k2)
    pidx = pack_index(build_index(None, train.ratings, "cosine", k, L,
                                  family=draws.families[0]),
                      train.ratings, dtype=torch.float32)
    qb, _ = query_hashes(pidx, hidden.ratings)
    s0, sizes = _window_offsets(pidx.bucket_starts, qb, budget)
    qv = unit(hidden.ratings)
    label = f"CV fold 0, f32 slabs d = {c}, q = {qv.shape[0]}"
    err = k1_check(label, pidx.packed, s0, sizes, qv, budget, False)
    k1 = k1_time(label, pidx.packed, s0, sizes, qv, budget, False)
    k1["max_abs_err"] = err
    k1_line(14, k1, err)
    del pidx, s0, sizes, qv, hidden, train, test
    torch.cuda.empty_cache()

    zero_counts()
    t0 = time.perf_counter()
    mae = validate.ten_fold_mae(gen(SEED + 17), users, "cosine", k, L, 4, 1.0, CV["top_p"],
                                engine="fused", candidate_budget=budget)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    base = mean_predictor_mae(full, known, c)
    log(f"phase 14 ten_fold_mae fused ({n} x {c}, k={k} L={L} budget {budget}, top-"
        f"{CV['top_p']}): {wall:.2f} s wall; MAE {mae:.4f} (JAX package {CV_JAX_MAE}, "
        f"tolerance {CV_MAE_TOL}); mean predictor {base:.4f}; launches {launches}")
    if not (launches["slab_window_dots"] and launches["signproj_bucket_ids"]
            and launches["cf_predict"]):
        raise AssertionError(f"10-fold CV: a kernel did not run: {launches}")
    check_s1("10-fold CV", launches)
    if abs(mae - CV_JAX_MAE) > CV_MAE_TOL:
        raise AssertionError(f"10-fold CV MAE {mae:.4f} is not within {CV_MAE_TOL} "
                             f"of {CV_JAX_MAE}")
    return dict(launches=launches, wall_s=wall, mae=mae, jax_mae=CV_JAX_MAE,
                mean_predictor_mae=base, k1=k1, k2=k2)


# phase 15: score-ranked candidate sets at bench.py's point (budget 256,
# window 488) on the CF leg's 2M x 128 int8 index; the JAX package read
# set recall 0.9997 there
SQ, SBUDGET, SFLOOR = 8192, 256, 0.999


def phase15(pidx, queries, true_idx):
    """candidate_ids_scored, counted (K1 must run), against the planted
    top-10: set recall >= SFLOOR; ids in range and distinct per query.
    K1 at this geometry (the same index, windows and queries) is held
    against its plain version in phase 4."""
    from crypto_rec_tpu_torch.models.lsh.index import candidate_ids_scored
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    qs = queries[:SQ]

    def run():
        return candidate_ids_scored(pidx, qs, budget=SBUDGET, per_table=PER_TABLE)

    zero_counts()
    ids = run()
    torch.cuda.synchronize()
    launches = read_counts()
    if not launches["slab_window_dots"]:
        raise AssertionError("candidate_ids_scored: K1 did not run")
    check_s1("candidate_ids_scored", launches)
    if tuple(ids.shape) != (SQ, SBUDGET) or not bool(((ids >= -1) & (ids < N)).all()):
        raise AssertionError("candidate_ids_scored: shape or ids out of range")
    s = torch.sort(ids, dim=1).values
    if bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any()):
        raise AssertionError("candidate_ids_scored: duplicate ids in a set")
    recall = recall_at_k(ids, true_idx[:SQ])
    t_wall = wall_ms(run)
    t_dev = cuda_ms(run)
    log(f"phase 15 candidate_ids_scored (2M x 128 int8, k={K} L={L}, window {PER_TABLE}, "
        f"budget {SBUDGET}, q={SQ}): {t_wall:.3f} ms host, {t_dev:.3f} ms device, "
        f"{SQ / t_wall * 1e3:,.0f} q/s; set recall@{TOP_K} {recall:.4f} (floor {SFLOOR}); "
        f"launches {launches}")
    if recall < SFLOOR:
        raise AssertionError(f"set recall {recall:.4f} < {SFLOOR}")
    return dict(launches=launches, wall_ms=t_wall, device_ms=t_dev, recall=recall,
                floor=SFLOOR)


# ---- phases 16-21: the card against the CPU, the rest of the package ----

def _rec_arrays(rec):
    return dict(top=rec.top_n.cpu().numpy(), pred=rec.predicted.float().cpu().numpy(),
                sims=rec.sims.float().cpu().numpy(), nb=rec.neighbor_idx.cpu().numpy(),
                valid=rec.neighbor_valid.cpu().numpy(), has=rec.has_neighbors.cpu().numpy())


def run_program(tweets, conf, out, *extra):
    """`main -validate` in this process with `extra` flags -> (rc, summary,
    the Recommendation arrays of the four written phases, in order)."""
    from crypto_rec_tpu_torch import main as rec_main
    from crypto_rec_tpu_torch.models.rec import pipeline

    recs = []
    write = pipeline._write_phase

    def keep(out_f, header, user_ids, rec, coins, timer, phase):
        recs.append(_rec_arrays(rec))
        return write(out_f, header, user_ids, rec, coins, timer, phase)

    buf = io.StringIO()
    pipeline._write_phase = keep
    try:
        with contextlib.redirect_stdout(buf):
            rc = rec_main.main(["-d", tweets, "-o", out, "-c", conf, "-validate", *extra])
    finally:
        pipeline._write_phase = write
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), recs


def _sections(path):
    """Output file -> [{uid: line}] per phase, Execution Time lines left out."""
    secs = []
    with open(path) as f:
        for line in f.read().splitlines():
            if line in ("Cosine LSH", "Clustering Recommendation"):
                secs.append({})
            elif not line.startswith("Execution Time: "):
                secs[-1][line.split(" ")[0]] = line
    return secs


def classify(rc, rg, i):
    """Why user i's line differs between the CPU run (rc) and the card's
    (rg): "tie" when the differing neighbours or coins hold exactly equal
    values, "near" when within 1e-5 relative, else "other"."""
    if rc["has"][i] != rg["has"][i]:
        return "other"
    vc, vg = rc["valid"][i], rg["valid"][i]
    if set(rc["nb"][i][vc].tolist()) != set(rg["nb"][i][vg].tolist()):
        sc, sg = np.sort(rc["sims"][i][vc]), np.sort(rg["sims"][i][vg])
        if sc.shape != sg.shape:
            return "other"
        if np.array_equal(sc, sg):
            return "tie"
        return "near" if np.allclose(sc, sg, rtol=1e-5, atol=0) else "other"
    a = [c for c in rc["top"][i] if c >= 0]
    b = [c for c in rg["top"][i] if c >= 0]
    if len(a) != len(b):
        return "other"
    pa, pb = np.sort(rc["pred"][i][a]), np.sort(rc["pred"][i][b])
    if np.array_equal(pa, pb):
        return "tie"
    near = np.allclose(np.sort(rc["pred"][i][a]), np.sort(rg["pred"][i][b]), rtol=1e-5,
                       atol=0)
    return "near" if near else "other"


# phase 16: a small dataset the CPU runs in seconds
TIE = dict(n_users=4000, n_tweets=60000, n_coins=15, emb_dim=16, seed=7)


def compare_devices(tmp, tweets, conf, row, engine):
    """`main -validate --engine engine` on the card and on the CPU; each
    differing recommendation line classified (`classify`)."""
    runs = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(tmp, f"{engine}_{device}.txt")
        t0 = time.perf_counter()
        rc, summary, recs = run_program(tweets, conf, out, "--engine", engine,
                                        "--device", device)
        if rc != 0 or len(recs) != 4:
            raise AssertionError(f"main --engine {engine} --device {device}: rc {rc}")
        runs[device] = (_sections(out), recs, summary, time.perf_counter() - t0)
    counts = {"differ": 0, "tie": 0, "near": 0, "other": 0}
    examples = []
    for s in range(4):
        gs, cs = runs["cuda"][0][s], runs["cpu"][0][s]
        for uid in sorted(set(gs) | set(cs), key=lambda u: row[u]):
            if gs.get(uid) == cs.get(uid):
                continue
            kind = classify(runs["cpu"][1][s], runs["cuda"][1][s], row[uid])
            counts["differ"] += 1
            counts[kind] += 1
            if len(examples) < 3:
                examples.append(dict(phase=s, cpu=cs.get(uid), card=gs.get(uid), kind=kind))
    return dict(counts, mae_card=runs["cuda"][2]["mae_10fold"],
                mae_cpu=runs["cpu"][2]["mae_10fold"], card_s=runs["cuda"][3],
                cpu_s=runs["cpu"][3], examples=examples)


def phase16():
    """The program on the card against the program on the CPU: `main
    -validate` with each engine twice (--device cuda, --device cpu); the
    files must agree line for line but for exact ties and near-ties in the
    neighbour sims or predicted scores, which are counted and printed."""
    from crypto_rec_tpu_torch.config import load_config
    from crypto_rec_tpu_torch.io.native import score_tweets_native
    from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset
    from crypto_rec_tpu_torch.io.users import build_user_matrix

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tweets, conf = write_synthetic_dataset(os.path.join(tmp, "ds"), **TIE)
        cfg = load_config(conf)
        ids = build_user_matrix(score_tweets_native(
            tweets, cfg.lexicon_file, cfg.query_file, cfg.csv_delimiter)).ids
        row = {u: i for i, u in enumerate(ids)}
        for engine in ("mask", "csr", "fused"):
            r = compare_devices(tmp, tweets, conf, row, engine)
            log(f"phase 16 engine {engine} ({TIE['n_users']} users, {TIE['n_coins']} coins): "
                f"card {r['card_s']:.1f} s, CPU {r['cpu_s']:.1f} s; {r['differ']} "
                f"recommendation lines differ: {r['tie']} exact ties, {r['near']} "
                f"near-ties (1e-5), {r['other']} other; 10-fold MAE card "
                f"{r['mae_card']:.6f}, CPU {r['mae_cpu']:.6f}; e.g. {r['examples']}")
            res[engine] = r
            if r["other"]:
                raise AssertionError(f"engine {engine}: {r['other']} lines differ beyond "
                                     f"a tie or near-tie, e.g. {r['examples']}")
    return res


def phase17(ds, csr_lsh_a_ms):
    """`main -validate --engine fused` on phase 13's dataset, counted: the
    program's 15-coin matrix (d = 15) through packed_retrieve_core; four
    phases written, the MAE, phase A ms beside phase 13's csr."""
    tweets, conf = ds
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fused.txt")
        zero_counts()
        t0 = time.perf_counter()
        rc, summary, recs = run_program(tweets, conf, out, "--engine", "fused")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        secs = _sections(out)
    if rc != 0 or len(secs) != 4 or not all(secs):
        raise AssertionError(f"main --engine fused: rc {rc}, {len(secs)} phases")
    mae = summary["mae_10fold"]
    pm = summary["phase_ms"]
    has = float(np.mean(recs[0]["has"]))
    log(f"phase 17 main -validate --engine fused ({PIPE['n_users']} users, d = "
        f"{PIPE['n_coins']}): {wall:.1f} s; phase A {pm['lsh_A']} ms (phase 13's csr: "
        f"{csr_lsh_a_ms} ms), phase B {pm['lsh_B']} ms; {[len(s) for s in secs]} lines "
        f"per phase, has_neighbors {has:.4f}; MAE {mae:.4f}; launches {launches}")
    if not launches["signproj_bucket_ids"] or not np.isfinite(mae):
        raise AssertionError(f"fused program: K2 did not run or MAE {mae}")
    return dict(launches=launches, seconds=wall, phase_ms=pm, csr_lsh_a_ms=csr_lsh_a_ms,
                mae=mae, lines=[len(s) for s in secs], has_neighbors=has)


# phase 18: the retrieval paths that run no kernel, on phase 5's corpus
NK = dict(q=8192, cube_probes=20, cube_window=976, cube_floor=0.96, floor=0.99)


def phase18(corpus, queries, true_idx, index, q_host, true_host):
    """Serving without --pack (the unpacked path), per-row int8 cosine and
    unaugmented per-row int8 euclidean slabs through packed_retrieve_core,
    a 20-probe cosine cube (the blocked branch), and pack_index_host's
    slabs against pack_index's byte for byte."""
    from crypto_rec_tpu_torch import checkpoint
    from crypto_rec_tpu_torch.models.lsh.hypercube import (
        build_hypercube, cube_retrieve_topk, pack_cube,
    )
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, pack_index_host, retrieve_topk,
    )
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    res = {}
    qs = queries[:NK["q"]]
    with tempfile.TemporaryDirectory() as tmp:
        idx_path = os.path.join(tmp, "idx.npz")
        checkpoint.save_index(idx_path, index)          # unpacked
        corpus_path = os.path.join(tmp, "corpus.npz")
        np.savez(corpus_path, vectors=corpus.cpu().numpy())
        zero_counts()
        reqs = []
        for req, t_req, recall in serve_requests(tmp, idx_path, corpus_path, q_host,
                                                 true_host, ["--per-table", str(PER_TABLE)]):
            log(f"phase 18 serve_cli retrieve without --pack, request {req}: {REQ_Q} "
                f"queries in {t_req:.2f} s (restore + unpacked retrieve), recall@{TOP_K} "
                f"{recall:.4f} (floor {NK['floor']})")
            if recall < NK["floor"]:
                raise AssertionError("unpacked serving: recall too low")
            reqs.append(dict(seconds=t_req, recall=recall))
        res["serve_unpacked"] = dict(requests=reqs, launches=read_counts())

    def leg(name, obj, run, floor):
        scores, ids = run()
        check_topk(scores, ids, NK["q"], N, name)
        recall = recall_at_k(ids, true_idx[:NK["q"]])
        t = wall_ms(run, reps=3)
        log(f"phase 18 {name} (slabs {list(obj.packed.shape)} {str(obj.packed.dtype)[6:]}): "
            f"q={NK['q']} in {t:.3f} ms ({NK['q'] / t * 1e3:,.0f} q/s), recall@{TOP_K} "
            f"{recall:.4f} (floor {floor})")
        if recall < floor:
            raise AssertionError(f"{name}: recall {recall:.4f} < {floor}")
        res[name] = dict(ms=t, qps=NK["q"] / t * 1e3, recall=recall, floor=floor)

    pidx = pack_index(index, corpus, dtype=torch.int8, scale_mode="row")
    leg("cosine per-row int8 (packed_retrieve_core + rerank)", pidx,
        lambda: retrieve_topk(pidx, qs, corpus, TOP_K, per_table=PER_TABLE), NK["floor"])
    res["k1_per_row"] = per_row_k1(pidx, qs, true_idx[:NK["q"]])
    del pidx
    eidx = pack_index(build_index(gen(SEED + 21), corpus, "euclidean", E_K, E_L,
                                  lsh_bucket_div=E_DIV, euclidean_h_w=E_W),
                      corpus, dtype=torch.int8)
    if eidx.packed_scale is None or eidx.packed_sqnorm is None:
        raise AssertionError("euclidean int8 without augment must be per-row with sqnorm")
    leg("euclidean unaugmented per-row int8 (packed_retrieve_core + rerank)", eidx,
        lambda: retrieve_topk(eidx, qs, corpus, TOP_K, per_table=E_PT), E_FLOOR)
    del eidx
    cube = pack_cube(build_hypercube(gen(SEED + 31), corpus, "cosine", CK, 1.0), corpus,
                     dtype=torch.int8)
    leg(f"single cosine cube, {NK['cube_probes']} probes (blocked branch)", cube,
        lambda: cube_retrieve_topk(cube, qs, corpus, TOP_K, NK["cube_probes"],
                                   NK["cube_window"]), NK["cube_floor"])
    del cube
    torch.cuda.empty_cache()
    # pack_index_host: host math, table-by-table upload, against the card's pack
    t0 = time.perf_counter()
    host = pack_index_host(index, corpus.cpu().numpy(), dtype=torch.int8)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev = pack_index(index, corpus, dtype=torch.int8)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    differ = int((host.packed != dev.packed).sum())
    same = (differ == 0 and torch.equal(host.packed_rows, dev.packed_rows)
            and torch.equal(host.packed_gscale, dev.packed_gscale))
    log(f"phase 18 pack_index_host int8 {list(host.packed.shape)}: {t_host:.2f} s (host "
        f"math + upload) against pack_index on the card {t_dev:.2f} s; {differ} slab "
        f"bytes differ, rows and scale {'equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"pack_index_host: {differ} slab bytes differ from pack_index")
    res["pack_index_host"] = dict(host_s=t_host, device_s=t_dev, bytes_differ=differ)
    del host, dev
    torch.cuda.empty_cache()
    return res


def per_row_k1(pidx, qs, truth):
    """Phase 18's per-row int8 index through K1 with packed_scale: against
    its plain version on every window (both mask modes), timed with and
    without the scale; then packed_retrieve_pallas with the scale, counted
    (K1 must run), in production and strict mode, each at recall@10 >= the
    per-row floor."""
    from crypto_rec_tpu_torch.models.lsh.index import query_hashes
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        _window_offsets, packed_retrieve_pallas,
    )
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    q = qs.shape[0]
    qv = unit(qs)
    qb, _ = query_hashes(pidx, qv)
    s0, sizes = _window_offsets(pidx.bucket_starts, qb, PER_TABLE)
    scale = pidx.packed_scale
    label = f"per-row int8 (packed_scale), q = {q}"
    err = k1_check(label, pidx.packed, s0, sizes, qv, PER_TABLE, False, packed_scale=scale)
    e = k1_scale_time(label, pidx.packed, scale, s0, sizes, qv, PER_TABLE)
    e["max_abs_err"] = err
    log(f"phase 18 K1 {label}: slab {e['slab']} int8 + scale {list(scale.shape)}, win "
        f"{e['win']}: max |err| {err:.3g} (mask on/off, every window, atol 1e-4 x max "
        f"scale {float(scale.max()):.3g}); {ROUNDS} alternating rounds: with the scale "
        f"{e['ms']:.3f} ms, without {e['unscaled_ms']:.3f} ms, plain {e['plain_ms']:.3f} "
        f"ms; bound {e['bound_ms']:.3f} ms ({e['bound_by']}, the scale's 4 B a covered "
        f"row counted): {100 * e['share_of_bound']:.1f}% of it")
    del s0, sizes
    out = {}
    for strict in (False, True):
        def run():
            return packed_retrieve_pallas(pidx.packed, pidx.packed_rows, pidx.bucket_starts,
                                          pidx.n_rows, qs, qb, TOP_K, PER_TABLE,
                                          strict=strict, packed_scale=scale)

        zero_counts()
        scores, ids = run()
        torch.cuda.synchronize()
        launches = read_counts()
        check_topk(scores, ids, q, pidx.n_rows, "per-row packed_retrieve_pallas")
        recall = recall_at_k(ids, truth)
        t = wall_ms(run, reps=3)
        mode = "strict" if strict else "production"
        log(f"phase 18 packed_retrieve_pallas per-row int8 ({mode}, q={q}): {t:.3f} ms "
            f"({q / t * 1e3:,.0f} q/s), recall@{TOP_K} {recall:.4f} (floor {NK['floor']}), "
            f"top score {float(scores[:, 0].max()):.4f}; launches {launches}")
        if not launches["slab_window_dots"]:
            raise AssertionError(f"per-row packed_retrieve_pallas: K1 did not run: {launches}")
        check_s1(f"per-row packed_retrieve_pallas ({mode})", launches)
        if recall < NK["floor"]:
            raise AssertionError(f"per-row packed_retrieve_pallas ({mode}): recall "
                                 f"{recall:.4f} < {NK['floor']}")
        out[mode] = dict(ms=t, qps=q / t * 1e3, recall=recall, launches=launches)
    return dict(k1=e, retrieve=out)


OQ = 1024                  # bench.py's oracle queries


def _near_tie_slots(ids_a, ids_b, queries, rows, metric):
    """Slots where two oracles' ids differ, with both ids' distances to
    the query recomputed one pair at a time: -> (slots, max distance gap)."""
    from crypto_rec_tpu_torch.ops.distances import pairwise_distances

    diff = (ids_a != ids_b).nonzero()
    gap = 0.0
    for qi, slot in diff.tolist():
        pair = rows[torch.stack([ids_a[qi, slot], ids_b[qi, slot]]).long()]
        d = pairwise_distances(queries[qi:qi + 1], pair, metric)[0]
        gap = max(gap, float((d[0] - d[1]).abs()))
    return int(diff.shape[0]), gap


def streamed_oracle_2m(corpus, queries_all):
    """Phase 5's 2M x 128 corpus copied to the host: exact_nearest_streamed
    over OQ queries in 2^18-row slices against the resident exact_nearest;
    ids equal but where two rows' distances lie within 1e-5 (f32 products
    of other shapes round differently)."""
    from crypto_rec_tpu_torch.ops.oracle import exact_nearest, exact_nearest_streamed

    host = corpus.cpu().numpy()
    qs = queries_all[:OQ]
    block = 1 << 18
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd, si = exact_nearest_streamed(qs, host, "cosine", TOP_K, corpus_block=block)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t0
    t0 = time.perf_counter()
    rd, ri = exact_nearest(qs, corpus, "cosine", TOP_K, block_rows=128)
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t0
    n_diff, gap = _near_tie_slots(si, ri, qs, corpus, "cosine")
    max_d = float((sd - rd).abs().max())
    slices = -(-host.shape[0] // block)
    log(f"phase 5 streamed oracle ({host.shape[0]} x {host.shape[1]} on the host, "
        f"{slices} slices of {block} rows, {OQ} queries, top-{TOP_K}): {t_stream:.2f} s "
        f"(resident exact_nearest {t_res:.2f} s); {n_diff} ids differ from the resident "
        f"oracle's (largest distance gap between the two ids {gap:.3g}), max |dist diff| "
        f"{max_d:.3g}")
    if gap > 1e-5 or max_d > 1e-5:
        raise AssertionError("streamed oracle disagrees with the resident oracle")
    del host
    return dict(rows=int(corpus.shape[0]), queries=OQ, corpus_block=block, slices=slices,
                seconds=t_stream, resident_seconds=t_res, ids_differ=n_diff,
                max_tie_gap=gap, max_dist_diff=max_d)


# phase 19: bench_100m.py's planted recipe, cut from 100M rows to 16M (4
# chunks of 4M: the 8.2 GB of int8 slabs stay in the card's host memory);
# k = 15 keeps ~122 rows a bucket per chunk (100M at k = 16: ~127)
ST = dict(n=16_000_000, chunks=4, k=15, L=4, window=256, q=16384, floor=0.95)


def phase19():
    """The streamed index: host build (rows generated on the card, copied
    to the host, hashed and packed in numpy, pinned), K1 against its plain
    version on every window of chunk 0; then five rounds, each one pass
    (host clock, and its copies' CUDA-event time) and one copy of every
    chunk's slab, rows and starts host -> device on one stream with nothing
    else running (CUDA events), so the pass and the copy rate it is held
    against share one window; then one counted pass: K1 and K2 must run,
    recall@10 against the planted truth >= the floor, device peak < 3
    chunks."""
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.lsh.streamed import (
        build_streamed_index, streamed_retrieve_topk,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    n, d, q, tk = ST["n"], D, ST["q"], TOP_K
    dev = DEV
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    n_centers = max(1024, n // 128)
    centers = torch.randn(n_centers, d, generator=g, device=dev) * 2.0
    queries = centers[torch.randint(0, n_centers, (q,), generator=g, device=dev)] \
        + 0.3 * torch.randn(q, d, generator=g, device=dev)
    n_planted = q * tk
    stride = n // n_planted
    chunk_rows = -(-n // ST["chunks"])
    # the f32 rows stay on the host for the streamed oracle, as many whole
    # chunks as fit beside the pinned slabs
    kept = oracle_chunks(chunk_rows * d * 4)
    host_rows = np.empty((min(n, kept * chunk_rows), d), dtype=np.float32)

    def chunk_source(ci):
        lo, hi = ci * chunk_rows, min(n, (ci + 1) * chunk_rows)
        x = centers[torch.randint(0, n_centers, (hi - lo,), generator=g, device=dev)]
        x += 0.3 * torch.randn(hi - lo, d, generator=g, device=dev)
        js = torch.arange(-(-lo // stride), min(n_planted, (hi - 1) // stride + 1),
                          device=dev)
        x[js * stride - lo] = queries[js // tk] + 0.15 * torch.randn(
            len(js), d, generator=g, device=dev)
        rows = x.cpu().numpy()
        if ci < kept:
            host_rows[lo:hi] = rows
        return rows

    t0 = time.perf_counter()
    sidx = build_streamed_index(gen(SEED + 61), chunk_source, n, d, ST["k"], ST["L"],
                                ST["chunks"])
    t_build = time.perf_counter() - t0
    del centers
    torch.cuda.empty_cache()
    truth = (torch.arange(n_planted, device=dev) * stride).reshape(q, tk)
    chunk_bytes = (sidx.slabs[0].numel() + sidx.rows[0].numel() * 4
                   + sidx.starts[0].numel() * 4)
    log(f"phase 19 host build ({n} x {d}, {ST['chunks']} chunks of {sidx.chunk_rows}, "
        f"k={ST['k']} L={ST['L']}, rows generated on the card): {t_build:.1f} s, "
        f"host index {sidx.host_bytes() / 1e9:.2f} GB pinned")
    # K1 on every window of chunk 0, against its plain version, and timed
    slab0 = sidx.slabs[0].to(dev)
    qv = unit(queries)
    qb = CosineLsh(torch.from_numpy(sidx.proj).to(dev), ST["k"], ST["L"]).bucket_ids(queries)
    s0, sizes = _window_offsets(sidx.starts[0].to(dev), qb, ST["window"])
    label = f"streamed chunk 0, int8 [{ST['L']}, {sidx.chunk_pad}, {d}], q = {q}"
    err = k1_check(label, slab0, s0, sizes, qv, ST["window"], False)
    k1 = k1_time(label, slab0, s0, sizes, qv, ST["window"], False, rounds=3)
    k1["max_abs_err"] = err
    k1_line(19, k1, err)
    del slab0, s0, sizes
    # passes against copies of every chunk's bytes alone, in alternating rounds
    host = [(sidx.slabs[ci], sidx.rows[ci], sidx.starts[ci]) for ci in range(sidx.n_chunks)]
    dst = [torch.empty(h.shape, dtype=h.dtype, device=dev) for h in host[0]]

    def copy_all():
        for chunk in host:
            for t, h in zip(dst, chunk):
                t.copy_(h, non_blocking=True)

    nbytes = sidx.host_bytes()
    streamed_retrieve_topk(sidx, queries, tk, ST["window"])          # warm
    copy_all()
    torch.cuda.synchronize()
    rounds = {"pass_ms": [], "pass_copy_ms": [], "copy_ms": []}
    for _ in range(5):
        st = {}
        streamed_retrieve_topk(sidx, queries, tk, ST["window"], stats=st)
        rounds["pass_ms"].append(st["wall_s"] * 1e3)
        rounds["pass_copy_ms"].append(st["copy_ms"])
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        copy_all()
        e1.record()
        e1.synchronize()
        rounds["copy_ms"].append(e0.elapsed_time(e1))
    med = {k: statistics.median(v) for k, v in rounds.items()}
    rates = {k.replace("_ms", "_gb_per_s"): nbytes / v / 1e6 for k, v in med.items()}
    log(f"phase 19 five rounds over {nbytes / 1e9:.2f} GB ({sidx.n_chunks} chunks' slabs, "
        f"rows and starts): pass {med['pass_ms']:.1f} ms = {rates['pass_gb_per_s']:.2f} GB/s "
        f"(host clock; its copies {med['pass_copy_ms']:.1f} ms of copy-stream time = "
        f"{rates['pass_copy_gb_per_s']:.2f} GB/s), every chunk copied alone "
        f"{med['copy_ms']:.1f} ms = {rates['copy_gb_per_s']:.2f} GB/s (CUDA events); the pass "
        f"at {100 * med['copy_ms'] / med['pass_ms']:.1f}% of the copy-alone rate; "
        f"rounds {rounds}")
    del dst
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    zero_counts()
    stats = {}
    vals, ids = streamed_retrieve_topk(sidx, queries, tk, ST["window"], stats=stats)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    check_topk(vals, ids, q, n, "streamed")
    recall = recall_at_k(ids, truth)
    log(f"phase 19 streamed pass (q={q}, window {ST['window']}, top-{tk}): "
        f"{stats['wall_s'] * 1e3:.1f} ms, {stats['qps']:,.0f} q/s, "
        f"{stats['stream_gb_per_s']:.2f} GB/s streamed, copy/compute overlap "
        f"{stats.get('overlap_ms', float('nan')):.1f} ms; peak device memory {peak / 1e9:.2f} GB above the "
        f"baseline (3 chunks: {3 * chunk_bytes / 1e9:.2f} GB); recall@{tk} {recall:.4f} "
        f"(floor {ST['floor']}; scale cut 100M -> {n} rows); launches {launches}")
    if not (launches["slab_window_dots"] and launches["signproj_bucket_ids"]):
        raise AssertionError(f"streamed: a kernel did not run: {launches}")
    check_s1("streamed", launches)
    if recall < ST["floor"]:
        raise AssertionError(f"streamed recall {recall:.4f} < {ST['floor']}")
    if peak >= 3 * chunk_bytes:
        raise AssertionError(f"streamed: peak {peak} B >= 3 chunks ({3 * chunk_bytes} B)")
    del sidx, vals, ids
    torch.cuda.empty_cache()
    oracle = streamed_oracle_16m(host_rows, queries[:OQ], truth[:OQ], n, kept)
    del queries, truth, host_rows
    return dict(launches=launches, stats=stats, rounds=rounds, round_medians_ms=med,
                round_rates_gb_per_s=rates, build_s=t_build, peak_bytes=peak, chunk_bytes=chunk_bytes, recall=recall,
                floor=ST["floor"], scale_cut=f"100M -> {n} rows", k1=k1, oracle=oracle)


def oracle_chunks(chunk_f32_bytes):
    """How many of phase 19's chunks' f32 rows the host can keep beside the
    pinned slabs: all of them when MemAvailable exceeds their bytes, the
    pinned index (~8.5 GB) and 8 GB to spare; else the whole chunks that
    fit (printed)."""
    with open("/proc/meminfo") as f:
        avail = next(int(line.split()[1]) * 1024 for line in f
                     if line.startswith("MemAvailable:"))
    spare = avail - 8.5e9 - 8e9
    kept = max(1, min(ST["chunks"], int(spare // chunk_f32_bytes)))
    if kept < ST["chunks"]:
        log(f"phase 19: the host has {avail / 1e9:.1f} GB available, too little for all "
            f"{ST['chunks']} chunks' f32 rows beside the pinned index: the streamed oracle "
            f"runs over {kept} chunks")
    return kept


def streamed_oracle_16m(host_rows, qs, truth, n, kept):
    """exact_nearest_streamed over phase 19's f32 rows on the host, OQ
    queries in 2^20-row slices (bench.py's HOST_ORACLE use): its agreement
    with the planted truth (the share of planted rows among the oracle's
    top-10, >= 0.99) and its seconds.  With fewer than all chunks kept,
    planted rows past them do not count."""
    from crypto_rec_tpu_torch.ops.oracle import exact_nearest_streamed

    rows = host_rows.shape[0]
    block = 1 << 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ids = exact_nearest_streamed(qs, host_rows, "cosine", TOP_K, corpus_block=block)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    hit = (ids[:, None, :] == truth.long()[:, :, None]).any(-1)
    agree = float(hit[truth < rows].float().mean())
    cut = "" if rows == n else f"; cut to {kept} chunks ({rows} rows) by host memory"
    log(f"phase 19 streamed oracle ({rows} x {host_rows.shape[1]} f32 rows on the host, "
        f"{-(-rows // block)} slices of {block}, {qs.shape[0]} queries, top-{TOP_K}): "
        f"{secs:.2f} s; agreement with the planted truth {agree:.4f}{cut}")
    if agree < 0.99:
        raise AssertionError(f"streamed oracle: agreement {agree:.4f} with the planted truth")
    return dict(rows=rows, host_gb=host_rows.nbytes / 1e9, queries=int(qs.shape[0]),
                corpus_block=block, seconds=secs, agreement=agree,
                cut=None if rows == n else f"{kept} of {ST['chunks']} chunks (host memory)")


# phase 20: benchmarks/bench_ivf.py's point on phase 5's corpus
IV = dict(clusters=1953, train=262144, iters=8, q=8192, nprobes=(2, 4, 8, 16), floor=0.99)


def phase20(corpus, queries, true_idx):
    """IVF: build (k-means on the leading train rows, Lloyd over all rows,
    bf16 blocks), then the nprobe sweep with q/s and recall@10 each."""
    from crypto_rec_tpu_torch.models.ivf import build_ivf, ivf_retrieve_topk
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k

    t0 = time.perf_counter()
    idx = build_ivf(gen(SEED + 70), corpus, IV["clusters"], "cosine",
                    max_iterations=IV["iters"], train_rows=IV["train"],
                    block_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    qs = queries[:IV["q"]]
    sweep = {}
    for nprobe in IV["nprobes"]:
        def run():
            return ivf_retrieve_topk(idx, qs, nprobe, TOP_K)
        vals, ids = run()
        check_topk(vals, ids, IV["q"], N, f"IVF nprobe {nprobe}")
        t = wall_ms(run, reps=3)
        sweep[nprobe] = dict(ms=t, qps=IV["q"] / t * 1e3,
                             recall=recall_at_k(ids, true_idx[:IV["q"]]))
    log(f"phase 20 IVF ({IV['clusters']} clusters, k-means on {IV['train']} rows x "
        f"{IV['iters']} iterations, capacity {idx.capacity}, {idx.dropped_rows} rows "
        f"dropped, bf16 blocks {list(idx.blocks.shape)}): build {t_build:.1f} s; q="
        f"{IV['q']}: " + "; ".join(f"nprobe {p}: {r['qps']:,.0f} q/s, recall@{TOP_K} "
                                   f"{r['recall']:.4f}" for p, r in sweep.items()))
    if sweep[16]["recall"] < IV["floor"]:
        raise AssertionError(f"IVF recall at nprobe 16 {sweep[16]['recall']:.4f}")
    res = dict(build_s=t_build, capacity=idx.capacity, dropped_rows=idx.dropped_rows,
               sweep=sweep, floor=IV["floor"])
    del idx
    torch.cuda.empty_cache()
    return res


def phase21(ds):
    """The CLIs on phase 13's dataset, counted apart: cluster_cli on the
    embeddings file (lloyd, lsh and cube under kmeans, then pam with lloyd
    on the first 20,000 rows), each with its silhouette; serve_cli
    recommend on the program's user matrix (save_user_matrix).  K2 must
    run on the lsh and cube assignments and on recommend."""
    from crypto_rec_tpu_torch import checkpoint, cluster_cli, serve_cli
    from crypto_rec_tpu_torch.config import load_config
    from crypto_rec_tpu_torch.io.native import score_tweets_native
    from crypto_rec_tpu_torch.io.users import build_user_matrix

    tweets, conf = ds
    cfg = load_config(conf)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        emb = cfg.proj2_input
        with open(emb) as f:
            head = list(itertools.islice(f, 20000))
        small = os.path.join(tmp, "emb20k.csv")
        with open(small, "w") as f:
            f.writelines(head)
        runs = [("lloyd", "kmeans", emb), ("lsh", "kmeans", emb), ("cube", "kmeans", emb),
                ("lloyd", "pam", small)]
        for assignment, update, path in runs:
            out = os.path.join(tmp, f"{assignment}_{update}.txt")
            zero_counts()
            t0 = time.perf_counter()
            rc = cluster_cli.main(["-i", path, "-o", out, "-c", conf, "--clusters", "6",
                                   "--metric", "cosine", "--delimiter",
                                   cfg.proj2_csv_delimiter, "--assignment", assignment,
                                   "--update", update])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            with open(out) as f:
                text = f.read().splitlines()
            sil = [x for x in text if x.startswith("Silhouette: ")]
            sizes = [int(x.split("size: ")[1].split(",")[0].rstrip("}"))
                     for x in text if x.startswith("CLUSTER-")]
            n_rows = sum(sizes)
            key = f"{assignment}/{update}"
            log(f"phase 21 cluster_cli --assignment {assignment} --update {update} "
                f"({n_rows} rows, k = 6): {wall:.2f} s, sizes {sizes}, {sil[0] if sil else ''}"
                f", {text[-2]}; launches {launches}")
            if rc != 0 or len(sizes) != 6 or not sil:
                raise AssertionError(f"cluster_cli {key}: rc {rc}")
            if assignment != "lloyd" and not launches["signproj_bucket_ids"]:
                raise AssertionError(f"cluster_cli {key}: K2 did not run")
            res[key] = dict(seconds=wall, sizes=sizes, silhouette=sil[0], launches=launches)
        users = build_user_matrix(score_tweets_native(tweets, cfg.lexicon_file,
                                                      cfg.query_file, cfg.csv_delimiter))
        upath = os.path.join(tmp, "users.npz")
        checkpoint.save_user_matrix(upath, users)
        out = os.path.join(tmp, "rec.txt")
        zero_counts()
        t0 = time.perf_counter()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = serve_cli.main(["recommend", "--users", upath, "--coins", cfg.query_file,
                                 "--top-n", "5", "-o", out])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        with open(out) as f:
            lines = f.read().splitlines()
        log(f"phase 21 serve_cli recommend ({len(users.ids)} users): {wall:.2f} s, "
            f"{len(lines)} lines, {err.getvalue().strip()}; launches {launches}")
        if rc != 0 or not lines or not launches["signproj_bucket_ids"]:
            raise AssertionError(f"serve_cli recommend: rc {rc}, launches {launches}")
        res["recommend"] = dict(seconds=wall, lines=len(lines), launches=launches)
    return res


# phase 23: the top-k sites repaired to tie order (equal values lowest
# index first, as lax.top_k): each on tied inputs on both devices
TIES = dict(n=100_000, d=64, patterns=300, q=1024, k=10, cube_q=32768, rerank_q=8192,
            dedup_q=8192)


def _norm2_rows(rng, n, d):
    """n rows of four entries +-1 (norm 2): every dot and squared norm is
    exact in f32, so equal rows give bit-equal distances on both devices."""
    x = np.zeros((n, d), np.float32)
    cols = np.argsort(rng.random((n, d)), axis=1)[:, :4]
    np.put_along_axis(x, cols, rng.choice([-1.0, 1.0], size=(n, 4)).astype(np.float32), 1)
    return x


def _differ(a, b):
    """(rows whose sets differ, rows whose order differs) of two [q, k]
    id arrays."""
    a, b = a.cpu(), b.cpu()
    sets = sum(set(x) != set(y) for x, y in zip(a.tolist(), b.tolist()))
    return sets, int((a != b).any(1).sum())


def phase23():
    """Each `torch.topk` site repaired to ops/topk's tie order, on inputs
    full of exact ties, on the card and on the CPU: exact_nearest and
    exact_nearest_streamed on duplicated rows (both metrics),
    directed_probe_vertices with equal bit margins and subset scores
    (m_bits 5 and None), rerank_exact on duplicated candidates, and the
    epilogue's dedup top-k (`_dedup_topk_pairs`, also candidate_ids_scored's
    stage 2) on tied scores.  Differing sets (and orders) must be 0."""
    from crypto_rec_tpu_torch.models.lsh.hypercube import (
        build_hypercube, directed_probe_vertices,
    )
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.lsh.index import rerank_exact
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _dedup_topk_pairs
    from crypto_rec_tpu_torch.ops.oracle import exact_nearest, exact_nearest_streamed

    rng = np.random.default_rng(SEED + 230)
    cpu = torch.device("cpu")
    t = TIES
    base = _norm2_rows(rng, t["patterns"], t["d"])
    x = torch.from_numpy(base[rng.integers(0, t["patterns"], t["n"])])
    qs = torch.from_numpy(base[rng.integers(0, t["patterns"], t["q"])])
    sites = {}

    def both(name, fn, *args):
        """fn on CPU tensors and on their card copies -> the ids' differences."""
        on = [fn(*(a.to(dv) if isinstance(a, torch.Tensor) else a for a in args))
              for dv in (cpu, DEV)]
        torch.cuda.synchronize()
        sets, order = _differ(on[0], on[1])
        sites[name] = dict(rows=int(on[0].shape[0]), sets_differ=sets, order_differs=order)
        log(f"phase 23 {name}: {sets} of {on[0].shape[0]} sets differ card against CPU, "
            f"{order} orders")

    for metric in ("cosine", "euclidean"):
        both(f"exact_nearest {metric} ({t['n']} rows of {t['patterns']} patterns)",
             lambda a, b: exact_nearest(a, b, metric, t["k"])[1], qs, x)
        both(f"exact_nearest_streamed {metric} (slices of 2^15)",
             lambda a: exact_nearest_streamed(a, x.numpy(), metric, t["k"],
                                              corpus_block=1 << 15)[1], qs)
    d, kb = 16, 13
    proj = torch.from_numpy(rng.integers(-1, 2, size=(d, kb)).astype(np.float32))
    cx = torch.from_numpy(rng.integers(-2, 3, size=(4096, d)).astype(np.float32))
    cq = torch.from_numpy(rng.integers(-2, 3, size=(t["cube_q"], d)).astype(np.float32))

    def probes(q, p, m_bits, probes_n):
        cube = build_hypercube(None, cx.to(q.device), "cosine", kb, 1.0,
                               family=CosineLsh(p, kb, 1))
        return directed_probe_vertices(cube, q, probes_n, m_bits=m_bits)

    for m_bits, probes_n in ((5, 16), (None, 64)):
        both(f"directed_probe_vertices (integer margins, m_bits {m_bits}, {probes_n} probes)",
             lambda q, p: probes(q, p, m_bits, probes_n), cq, proj)
    rq = torch.from_numpy(_norm2_rows(rng, t["rerank_q"], t["d"]))
    cand = torch.from_numpy(np.stack([rng.permutation(t["n"])[:40]
                                      for _ in range(t["rerank_q"])]).astype(np.int32))
    for metric in ("cosine", "euclidean"):
        both(f"rerank_exact {metric} (40 candidates)",
             lambda c, q, i: rerank_exact(c, metric, q, i, t["k"])[1], x, rq, cand)
    ids = torch.from_numpy(rng.integers(0, 2100, size=(t["dedup_q"], 96)).astype(np.int32))
    sc = (ids % 4).float()
    both("_dedup_topk_pairs (scores in 4 levels, 96 survivors, top-20)",
         lambda s_, i_: _dedup_topk_pairs(s_, i_, 2000, 20)[1], sc, ids)
    bad = {k: v for k, v in sites.items() if v["sets_differ"] or v["order_differs"]}
    if bad:
        raise AssertionError(f"tie order differs card against CPU: {bad}")
    return sites


# S1 (window_topk), the stage-1 selection of every K1 path: the shapes it
# launched at (R, m, k) -> the phase that first did, and the first dots of
# phases 5, 9 and 10 at each shape, held against topk_desc after the run
S1 = dict(phase=None, shapes={}, kept={}, checked=set(), dots=[], quiet=False)
S1_CHUNK = 1 << 18         # rows a topk_desc comparison sorts at once
S1_CPU_ROWS = 2048         # rows of each tied block compared with the CPU
S1_TIME_ELEMS = 1 << 29    # values timed at most beside the sort (2 GiB of f32)
# S1's two bodies and the rows each serves
S1_BODIES = [
    dict(source="crypto_rec_tpu_torch/csrc/windowtopk.cu", entry="crt_window_topk",
         serves="rows of m <= 32,768 with k <= 1,024: warp rows (m <= 1,024, k <= 32), "
                "block rows (1,024 < m <= 32,768, or k > 32)"),
    dict(source="crypto_rec_tpu_torch/csrc/windowtopk.cu", entry="crt_window_topk_segments",
         serves="the first level of rows of m > 32,768 (k <= 1,024): block rows on each "
                "32,768-lane segment, then crt_window_topk over the winners (phase 25)"),
    dict(source="crypto_rec_tpu_torch/csrc/windowtopk.cu", entry="crt_window_topk_large",
         serves="k > 1,024: a radix select a row, the winners sorted in scratch (phase 25)"),
]


def s1_record():
    """Route S1's launches through a recorder of their shapes (and, in
    phases 5, 9, 10 and 25, of the first dots at each shape).  The wrapper
    still counts each launch where it makes it."""
    from crypto_rec_tpu_torch.ops.kernels import windowtopk

    launch = windowtopk._select

    def select(values, k):
        key = (int(values.shape[0]), int(values.shape[1]), int(k))
        if not S1["quiet"]:          # not the checks' and timings' own calls
            S1["shapes"].setdefault(key, S1["phase"])
            if S1["phase"] in (5, 9, 10, 25) and key not in S1["checked"]:
                S1["kept"].setdefault(key, values)
        return launch(values, k)

    windowtopk._select = select


def check_s1(label, launches):
    """Every stage-1 site selects K1's dots through S1: a counted run that
    launched K1 must show S1 too."""
    if launches["slab_window_dots"] and not launches["window_topk"]:
        raise AssertionError(f"{label}: K1 ran but S1 (window_topk) did not: {launches}")


def _s1_against_plain(v, k):
    """S1 on all rows of v, against topk_desc S1_CHUNK rows at a time ->
    (S1's output, equal bit for bit in values and indices)."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    got = window_topk(v, k)
    same = True
    for s in range(0, v.shape[0], S1_CHUNK):
        want = topk_desc(v[s:s + S1_CHUNK], k)
        same = same and torch.equal(got[1][s:s + S1_CHUNK], want[1]) and torch.equal(
            got[0][s:s + S1_CHUNK].view(torch.int32), want[0].view(torch.int32))
    torch.cuda.synchronize()
    return got, same


def s1_time(v, k):
    """S1, torch.topk (the library yardstick) and topk_desc (the plain
    version) on the same rows, alternating rounds,
    with S1's bound: on the first S1_TIME_ELEMS // m rows (the sort of more
    would not fit beside them), and then S1 alone on all the rows
    (all_rows_ms)."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    full = v
    v = v[:max(1, S1_TIME_ELEMS // v.shape[1])]
    t = rounds_ms({"ms": lambda: window_topk(v, k),
                   "library_ms": lambda: torch.topk(v, k, dim=1),
                   "plain_ms": lambda: topk_desc(v, k)})
    R, m = v.shape
    e = with_bound(dict(R=int(R), m=int(m), k=int(k), **t), bounds.s1_call(R, m, k))
    e["all_rows"] = int(full.shape[0])
    e["all_rows_ms"] = (e["ms"] if full.shape[0] == R
                        else rounds_ms({"ms": lambda: window_topk(full, k)})["ms"])
    return e


def s1_line(phase, what, e):
    log(f"phase {phase} S1 {what}, timed on [{e['R']}, {e['m']}] k = {e['k']}: {ROUNDS} "
        f"alternating rounds: S1 {e['ms']:.3f} ms, torch.topk {e['library_ms']:.3f}, "
        f"topk_desc {e['plain_ms']:.3f}; bound {e['bound_ms']:.4f} ms (bytes): "
        f"{100 * e['share_of_bound']:.1f}% of it; S1 on all {e['all_rows']} rows "
        f"{e['all_rows_ms']:.3f} ms")


def s1_check_kept(phase):
    """S1 against topk_desc, bit for bit, on the dots the phase's path
    selected from, then timed on them; the dots are let go."""
    S1["quiet"] = True
    for key in list(S1["kept"]):
        v = S1["kept"].pop(key)
        S1["checked"].add(key)
        k = key[2]
        got, same = _s1_against_plain(v, k)
        if not same:
            raise AssertionError(f"S1 differs from topk_desc on phase {phase}'s dots {key}")
        e = s1_time(v, k)
        e.update(phase=phase, input="the path's dots", shape=list(key), max_abs_err=0.0)
        s1_line(phase, f"on the path's dots {list(key)} (equal to topk_desc bit for bit)", e)
        S1["dots"].append(e)
        del v, got
    S1["quiet"] = False
    torch.cuda.empty_cache()


def _s1_tied_rows(R, m, seed):
    """[R, m] f32 rows full of exact ties on the card, made S1_CHUNK rows at
    a time: integer levels -4..4 with each 0 signed at random, +-inf, NaN
    and -inf lanes; every fourth row in {-1, -0.0, 0.0}, every fourth row
    95% -inf (a short masked window)."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    v = torch.empty(R, m, device=DEV)
    for s in range(0, R, S1_CHUNK):
        c = min(S1_CHUNK, R - s)
        b = torch.randint(-4, 5, (c, m), generator=g, device=DEV).float()
        u = torch.randint(0, 1000, (c, m), generator=g, device=DEV)
        r = (s + torch.arange(c, device=DEV))[:, None] % 4
        b = torch.where(r == 3, -(u % 2).float(), b)
        sign = torch.randint(0, 2, (c, m), generator=g, device=DEV).bool()
        b = torch.where((b == 0) & sign, -0.0, b)
        b = torch.where((r == 2) & (u < 950), float("-inf"), b)
        b = torch.where(u < 2, float("nan"), b)
        b = torch.where((u >= 2) & (u < 4), float("inf"), b)
        v[s:s + c] = torch.where((u >= 4) & (u < 40), float("-inf"), b)
    return v


def phase24():
    """S1 at every stage-1 shape the run launched it at, on tied rows
    (integers, +-0, +-inf, NaN, -inf runs): equal to topk_desc bit for bit
    on the card, and to topk_desc on the CPU on the first S1_CPU_ROWS rows
    (0 differing sets and orders); then timed against torch.topk and
    topk_desc at each shape."""
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    out = []
    S1["quiet"] = True
    for i, ((R, m, k), phase) in enumerate(sorted(S1["shapes"].items(),
                                                  key=lambda kv: (kv[1], kv[0]))):
        v = _s1_tied_rows(R, m, SEED + 240 + i)
        got, same = _s1_against_plain(v, k)
        c = min(R, S1_CPU_ROWS)
        cpu = topk_desc(v[:c].cpu(), k)
        sets, orders = _differ(got[1][:c], cpu[1])
        vbits = torch.equal(got[0][:c].cpu().view(torch.int32), cpu[0].view(torch.int32))
        if not same or sets or orders or not vbits:
            raise AssertionError(f"S1 [{R}, {m}] k = {k}: equal to topk_desc on the card "
                                 f"{same}; card against CPU: {sets} sets, {orders} orders "
                                 f"differ, values equal {vbits}")
        e = s1_time(v, k)
        e.update(phase=phase, input="tied rows", shape=[R, m, k], max_abs_err=0.0,
                 cpu_rows=c, sets_differ=sets, order_differs=orders)
        log(f"phase 24 S1 [{R}, {m}] k = {k} (first launched in phase {phase}), tied rows: "
            f"equal to topk_desc bit for bit on the card; {sets} of {c} sets differ card "
            f"against CPU, {orders} orders")
        s1_line(24, "tied rows", e)
        out.append(e)
        del v, got
    S1["quiet"] = False
    torch.cuda.empty_cache()
    return out


# phase 22: the sharded engines (parallel/) on phase 5's corpus and index
# point, under a NCCL process group of world size 1; each mp shard is a
# logical cell of the one process (500,000 rows a shard at mp = 4)
SH = dict(mps=(1, 4), q=8192, budget=256, dense_q=512, routed_budget=512, floor=0.99,
          drift=0.002)
BACKEND = "nccl"


def _merge_in_shard_order(parts, top_k):
    """[(scores [q, k], global ids [q, k])] per shard, shard order -> the
    ops/topk merge of their concatenation."""
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    s = torch.cat([p[0] for p in parts], dim=1)
    i = torch.cat([p[1] for p in parts], dim=1)
    v, pos = topk_desc(s, top_k)
    ids = torch.gather(i, 1, pos)
    return v, torch.where(v > float("-inf"), ids, -1)


def phase22(corpus, queries, true_idx, q_known, q_mean, single_recall, single_qps):
    """The sharded engines at full width on the card, under an initialized
    NCCL group of world size 1: for mp = 1 and 4 logical shards, build,
    int8 pack, sharded_retrieve_topk and sharded_recommend_scored, counted
    (K1 and K2 must run); at mp = 4 the composition check (the four shards'
    single-chip retrieve_topk merged with ops/topk equals the sharded
    result), K1 against its plain version on one shard's windows,
    sharded_recommend_csr, routed_retrieve_topk (csr interior) and the
    dense sharded_recommend at q = 512.  Every engine's neighbour recall@10
    >= 0.99, the retrieval and the scored engine within 0.002 of phase 5's."""
    import torch.distributed as dist

    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, candidate_mask, query_hashes, retrieve_topk,
    )
    from crypto_rec_tpu_torch.models.rec.engine import RatingSet
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets
    from crypto_rec_tpu_torch.ops.oracle import recall_at_k
    from crypto_rec_tpu_torch.parallel.mesh import make_mesh
    from crypto_rec_tpu_torch.parallel.routing import routed_retrieve_topk
    from crypto_rec_tpu_torch.parallel.sharded import shard_rating_set, sharded_recommend
    from crypto_rec_tpu_torch.parallel.sharded_index import (
        build_sharded_index, pack_sharded_index, shard_corpus, shard_view,
        sharded_recommend_csr, sharded_recommend_scored, sharded_retrieve_topk,
    )

    dev = corpus.device
    q = SH["q"]
    qs, truth = queries[:q], true_idx[:q]
    kq = torch.Generator(device=dev).manual_seed(SEED + 11)      # phase 5's ratings
    n_known = torch.rand(N, D, generator=kq, device=dev) < 0.6
    n_mean = (corpus * n_known).sum(1) / n_known.sum(1).clamp(min=1)
    qr, qk, qm = qs, q_known[:q], q_mean[:q]
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group(BACKEND, init_method=f"file://{tmp.name}/store", world_size=1,
                            rank=0, device_id=dev if dev.type == "cuda" else None)
    torch.cuda.reset_peak_memory_stats()
    res = dict(backend=dist.get_backend(), world_size=dist.get_world_size())
    log(f"phase 22 process group: {res['backend']}, world size {res['world_size']}")
    try:
        for mp in SH["mps"]:
            mesh = make_mesh((1, mp), device=dev)
            pc = shard_corpus(mesh, corpus)
            nr, nm = pc, shard_corpus(mesh, n_mean)
            zero_counts()
            t0 = time.perf_counter()
            idx = build_sharded_index(mesh, gen(SEED + 1), pc, "cosine", K, L)
            torch.cuda.synchronize()
            t_build = time.perf_counter() - t0
            t0 = time.perf_counter()
            pidx = pack_sharded_index(mesh, idx, pc, dtype=torch.int8)
            torch.cuda.synchronize()
            t_pack = time.perf_counter() - t0

            def retrieve():
                return sharded_retrieve_topk(mesh, pidx, qs, pc, budget=PER_TABLE,
                                             top_k=TOP_P, per_table=PER_TABLE,
                                             int8_rerank=False)

            def scored():
                return sharded_recommend_scored(mesh, pidx, qr, qk, qm, nr, nm, top_p=TOP_P,
                                                top_n=TOP_N, per_table=PER_TABLE)

            vals, ids = retrieve()
            out = scored()
            torch.cuda.synchronize()
            launches = read_counts()
            if not (launches["slab_window_dots"] and launches["signproj_bucket_ids"]):
                raise AssertionError(f"sharded mp={mp}: a kernel did not run: {launches}")
            check_s1(f"sharded mp={mp}", launches)
            r_ret = recall_at_k(ids[:, :TOP_K], truth)
            r_sc = recall_at_k(out[4][:, :TOP_K], truth)
            if tuple(out[0].shape) != (q, D) or not bool(torch.isfinite(out[0]).all()):
                raise AssertionError(f"sharded mp={mp}: scored predictions malformed")
            t_ret = wall_ms(retrieve, reps=3)
            t_sc = wall_ms(scored, reps=3)
            st = {k: (float(v) if k == "ici_bytes_per_query" else int(v))
                  for k, v in out[5].items()}
            e = dict(build_s=t_build, pack_s=t_pack, launches=launches,
                     retrieval_ms=t_ret, retrieval_qps=q / t_ret * 1e3, retrieval_recall=r_ret,
                     scored_ms=t_sc, scored_users_per_s=q / t_sc * 1e3, scored_recall=r_sc,
                     scored_stats=st)
            log(f"phase 22 mp={mp} ({N // mp} rows a shard, int8, k={K} L={L}, window "
                f"{PER_TABLE}, q={q}): build {t_build:.3f} s, pack {t_pack:.3f} s; "
                f"retrieval {t_ret:.3f} ms = {e['retrieval_qps']:,.0f} q/s (phase 5 single "
                f"chip {single_qps:,.0f}), recall@{TOP_K} {r_ret:.4f}; scored CF "
                f"{t_sc:.3f} ms = {e['scored_users_per_s']:,.0f} users/s, recall@{TOP_K} "
                f"{r_sc:.4f} (phase 5 {single_recall:.4f}); stats {st}; launches {launches}")
            for name, r in (("retrieval", r_ret), ("scored", r_sc)):
                if r < SH["floor"] or abs(r - single_recall) > SH["drift"]:
                    raise AssertionError(f"sharded mp={mp} {name}: recall {r:.4f} against "
                                         f"floor {SH['floor']} and phase 5's {single_recall:.4f}")
            if mp > 1:
                # each shard's own tables and slabs through the single-chip path,
                # ids offset, merged in shard order with ops/topk
                parts = []
                for p in range(mp):
                    s, i = retrieve_topk(shard_view(pidx, p), qs, pc[p], top_k=TOP_P,
                                         per_table=PER_TABLE, int8_rerank=False)
                    parts.append((s, torch.where(i >= 0, i + p * (N // mp), -1)))
                ms, mi = _merge_in_shard_order(parts, TOP_P)
                n_diff = int((mi != ids).sum())
                s_err = float((ms - vals).abs().max())
                log(f"phase 22 composition (mp={mp}): {n_diff} ids differ from the merge of "
                    f"the {mp} single-chip results, max |score diff| {s_err:.3g}")
                if n_diff or s_err > 1e-5:
                    raise AssertionError("sharded retrieval != merged single-chip shards")
                e.update(composition_ids_differ=n_diff, composition_max_abs=s_err)
                view = shard_view(pidx, 0)
                qv = unit(qs)
                qb, _ = query_hashes(view, qv)
                s0, sizes = _window_offsets(view.bucket_starts, qb, PER_TABLE)
                err = k1_check("sharded shard 0", view.packed, s0, sizes, qv, PER_TABLE, False)
                k1 = k1_time(f"sharded mp={mp}, shard 0, q = {q}", view.packed, s0, sizes, qv,
                             PER_TABLE, False, rounds=3)
                k1["max_abs_err"] = err
                k1_line(22, k1, err)
                e["k1"] = k1
                del s0, sizes, qb, parts
                # the csr engine, counted apart
                zero_counts()
                t0 = time.perf_counter()
                csr = sharded_recommend_csr(mesh, idx, qr, qk, qm, nr, nm, budget=SH["budget"],
                                            top_p=TOP_P, top_n=TOP_N)
                torch.cuda.synchronize()
                t_csr = (time.perf_counter() - t0) * 1e3
                r_csr = recall_at_k(csr[4][:, :TOP_K], truth)
                cst = {k: (float(v) if k == "ici_bytes_per_query" else int(v))
                       for k, v in csr[5].items()}
                e.update(csr_ms=t_csr, csr_recall=r_csr, csr_stats=cst,
                         csr_launches=read_counts())
                log(f"phase 22 csr engine (mp={mp}, budget {SH['budget']}): {t_csr:.1f} ms "
                    f"(first call), recall@{TOP_K} {r_csr:.4f}; stats {cst}")
                del csr
            del pidx
            torch.cuda.empty_cache()
            res[f"mp{mp}"] = e
        if res["mp4"]["csr_recall"] < SH["floor"]:
            raise AssertionError(f"csr engine recall {res['mp4']['csr_recall']:.4f}")
        # the routed all-to-all exchange (csr interior) over the same hyperplanes
        mesh = make_mesh((1, 4), device=dev)
        single = build_index(gen(SEED + 1), corpus, "cosine", K, L)
        zero_counts()
        t0 = time.perf_counter()
        rv, ri, rst = routed_retrieve_topk(mesh, single, qs, corpus, top_k=TOP_K,
                                           budget=SH["routed_budget"])
        torch.cuda.synchronize()
        t_routed = (time.perf_counter() - t0) * 1e3
        r_routed = recall_at_k(ri, truth)
        check_topk(rv, ri, q, N, "routed")
        log(f"phase 22 routed (mp=4, csr interior, budget {SH['routed_budget']}): "
            f"{t_routed:.1f} ms with the partition, recall@{TOP_K} {r_routed:.4f}; "
            f"dropped_requests {rst['dropped_requests']}, replication_factor "
            f"{rst['replication_factor']}, ici_bytes_per_query {rst['ici_bytes_per_query']}, "
            f"resident rows a shard {rst['resident_rows_per_shard']}; launches {read_counts()}")
        res["routed"] = dict(ms=t_routed, recall=r_routed, stats=rst, launches=read_counts())
        if r_routed < SH["floor"]:
            raise AssertionError(f"routed recall {r_routed:.4f}")
        # the dense-mask engine at q = 512 (its [q, n] mask and per-cell sims)
        dq = SH["dense_q"]
        mask = candidate_mask(single, qs[:dq])
        del single, rv, ri
        torch.cuda.empty_cache()
        nset = shard_rating_set(mesh, RatingSet(ratings=corpus, known=n_known, mean=n_mean))
        t0 = time.perf_counter()
        rec = sharded_recommend(mesh, RatingSet(qr[:dq], qk[:dq], qm[:dq]), nset, mask,
                                TOP_P, TOP_N)
        torch.cuda.synchronize()
        t_dense = (time.perf_counter() - t0) * 1e3
        r_dense = recall_at_k(rec.neighbor_idx[:, :TOP_K], truth[:dq])
        log(f"phase 22 dense sharded_recommend (mp=4, q={dq}, mask {list(mask.shape)}): "
            f"{t_dense:.1f} ms, recall@{TOP_K} {r_dense:.4f}, has_neighbors "
            f"{float(rec.has_neighbors.float().mean()):.4f}")
        res["dense"] = dict(q=dq, ms=t_dense, recall=r_dense)
        if r_dense < SH["floor"]:
            raise AssertionError(f"dense engine recall {r_dense:.4f}")
        del mask, rec, nset, n_known
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"phase 22 peak device memory {res['peak_bytes'] / 2**30:.2f} GiB")
    torch.cuda.empty_cache()
    return res


# phase 25: the paths at the public sets' widths, on planted corpora made
# from the seed (nothing is downloaded): (a) cosine at the shape of
# dbpedia-openai-1000k-angular, 1,000,000 x 1,536 (index L = 8, k = 13,
# int8 global-scale slabs; the single cosine cube at 40 probes x 992, so S1
# selects over 40,960 lanes); (b) euclidean at GIST-1M's shape, 1,000,000 x
# 960 (p-stable k = 5, L = 4, w scaled with sqrt(d) from phase 9's 20 to
# 55, augmented int8 slabs of d_aug = 1,024); (c) the program's 15 coins
# (phase 13's dataset): ten_fold_mae on the fused and mask engines, and
# candidate_ids_scored on f32 and int8 slabs (K1 at d = 15); (d) K1's
# bodies the paths above leave out: the CF cell's geometry
# (cf-jester-73k-100: int8 and bf16 d = 100) and f32 past d = 256.
WIDE = dict(n=1_000_000, q=8192, oracle_q=1024, floor=0.90,
            cos=dict(d=1536, k=13, L=8, per_table=488, cube_k=13, probes=40,
                     per_probe=992, cube_q=2048),
            euc=dict(d=960, k=5, L=4, w=55.0, div=4, per_table=768),
            cv=dict(budget=64, per_table=256),
            jester=dict(n=73_421, d=100, k=9, L=8, per_table=287, pad=4096, stage1=12,
                        floor=0.99, top_p=20, density=0.56),
            ffma=dict(n=200_000, d=384, k=10, L=4, per_table=256, q=2048),
            s1=((40960, 40, 1600), (131072, 40, 512), (8192, 2048, 2048)),
            s1_cpu_rows=64)
KERNEL_NAMES = dict(slab_window_dots="tile_dots", signproj_bucket_ids="signproj_kernel",
                    window_topk=("block_rows", "warp_rows", "radix_rows"),
                    cf_predict="predict_rows", dedup_topk="d1::")


def device_ms(fn, names, reps=5):
    """The device time per call of fn's kernels whose names contain one of
    `names` (the wrapper's own launch, not its plain-torch work list),
    from a torch.profiler trace of `reps` calls after one warm call."""
    names = (names,) if isinstance(names, str) else names
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
             if e.get("ph") == "X" and e.get("cat") == "kernel"
             and any(n in e.get("name", "") for n in names))
    return us / 1e3 / reps


def wide_k1(label, packed, s0, sizes, qk, per_table, shared, body=None):
    """K1 on a wide path's own windows: against its plain version on every
    window (both masks), then timed (events, beside the plain version)
    with the profiler's device time and the bound.  body: the kernel name the call must launch (its device time is
    then that kernel's alone), or None."""
    e_err = k1_check(label, packed, s0, sizes, qk, per_table, shared)
    e = k1_time(label, packed, s0, sizes, qk, per_table, shared, rounds=3)
    from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_window_dots

    e["device_ms"] = device_ms(lambda: slab_window_dots(packed, s0, sizes, qk, per_table,
                                                        mask=False, shared_slab=shared),
                               body or KERNEL_NAMES["slab_window_dots"])
    if body is not None and not e["device_ms"] > 0:
        raise AssertionError(f"K1 {label}: no {body} kernel ran")
    e["max_abs_err"] = e_err
    k1_line(25, e, e_err)
    log(f"phase 25 K1 {label}: device time of the kernel {e['device_ms']:.3f} ms a call "
        f"(profiler)")
    return e


def wide_k2(x, proj, k, L, label):
    e = check_k2(x, proj, k, L)
    from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids

    e["device_ms"] = device_ms(lambda: signproj_bucket_ids(x, proj, k, L),
                               KERNEL_NAMES["signproj_bucket_ids"])
    e["geometry"] += f" ({label})"
    k2_line(25, e)
    log(f"phase 25 K2 {label}: device time of the kernel {e['device_ms']:.3f} ms a call "
        f"(profiler)")
    return e


def wide_oracle(corpus, queries, metric, ids, label):
    """recall@10 of the path's ids against exact_nearest on the first
    oracle_q queries; raises under the floor."""
    from crypto_rec_tpu_torch.ops.oracle import exact_nearest, recall_at_k

    nq = min(WIDE["oracle_q"], queries.shape[0])
    _, exact = exact_nearest(queries[:nq], corpus, metric, TOP_K, block_rows=256)
    recall = recall_at_k(ids[:nq], exact)
    log(f"phase 25 {label}: recall@{TOP_K} against exact_nearest on {nq} queries "
        f"{recall:.4f} (floor {WIDE['floor']})")
    if recall < WIDE["floor"]:
        raise AssertionError(f"{label}: recall@{TOP_K} {recall:.4f} < {WIDE['floor']}")
    return recall


def wide_launches(label, launches, need):
    log(f"phase 25 {label} launches: {launches}")
    missing = [k for k in need if not launches[k]]
    if missing:
        raise AssertionError(f"{label}: {missing} did not run: {launches}")
    check_s1(label, launches)


def wide_cosine():
    """(a): build (K2 at d = 1,536), int8 pack, retrieve_topk at q = 8,192
    (K2 query hash, K1, S1, dedup, rerank), counted; then the single
    cosine cube at 40 probes x 992, counted; each against exact_nearest,
    each kernel against its plain version on the path's inputs."""
    from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus
    from crypto_rec_tpu_torch.models.lsh.hypercube import (
        build_hypercube, cube_retrieve_topk, cube_windows, pack_cube,
    )
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, query_hashes, retrieve_topk,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets

    c, n, q = WIDE["cos"], WIDE["n"], WIDE["q"]
    t0 = time.perf_counter()
    corpus, queries, _ = planted_clustered_corpus(
        torch.Generator(device=DEV).manual_seed(SEED + 250), n, c["d"], q, TOP_K)
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    index = build_index(gen(SEED + 251), corpus, "cosine", c["k"], c["L"])
    pidx = pack_index(index, corpus, dtype=torch.int8)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores, ids = retrieve_topk(pidx, queries, corpus, TOP_K, per_table=c["per_table"])
    torch.cuda.synchronize()
    t_ret = time.perf_counter() - t0
    launches = read_counts()
    wide_launches("(a) cosine LSH", launches,
                  ("signproj_bucket_ids", "slab_window_dots", "window_topk"))
    s1_check_kept(25)
    check_topk(scores, ids, q, n, "(a) cosine LSH")
    recall = wide_oracle(corpus, queries, "cosine", ids, "(a) cosine LSH")
    del scores, ids
    k2 = wide_k2(corpus, pidx.family.proj, c["k"], c["L"], "(a)'s index build, d = 1,536")
    qv = unit(queries)
    qb, _ = query_hashes(pidx, qv)
    s0, sizes = _window_offsets(pidx.bucket_starts, qb, c["per_table"])
    k1 = wide_k1(f"(a) cosine LSH, int8 d = {c['d']}, q = {q}", pidx.packed, s0, sizes, qv,
                 c["per_table"], False)
    log(f"phase 25 (a) cosine LSH {n} x {c['d']} k={c['k']} L={c['L']} window "
        f"{c['per_table']} (slabs {list(pidx.packed.shape)}, "
        f"{pidx.packed.numel() / 2**30:.2f} GiB): data {t_data:.1f} s, build + pack "
        f"{t_build:.1f} s, retrieve_topk q={q} {t_ret * 1e3:.1f} ms (first call)")
    del index, pidx, s0, sizes
    torch.cuda.empty_cache()

    cq = queries[:c["cube_q"]]
    zero_counts()
    t0 = time.perf_counter()
    cube = pack_cube(build_hypercube(gen(SEED + 252), corpus, "cosine", c["cube_k"], 1.0),
                     corpus, dtype=torch.int8)
    scores, ids = cube_retrieve_topk(cube, cq, corpus, TOP_K, c["probes"], c["per_probe"])
    torch.cuda.synchronize()
    t_cube = time.perf_counter() - t0
    cube_launches = read_counts()
    wide_launches("(a) single cosine cube", cube_launches,
                  ("signproj_bucket_ids", "slab_window_dots", "window_topk"))
    s1_check_kept(25)
    check_topk(scores, ids, cq.shape[0], n, "(a) single cosine cube")
    cube_recall = wide_oracle(corpus, cq, "cosine", ids, "(a) single cosine cube")
    del scores, ids
    rows = grouped(*cube_windows(cube, cq, c["probes"], c["per_probe"]), unit(cq))
    cube_k1 = wide_k1(f"(a) single cosine cube, {c['probes']} probes x {c['per_probe']}, "
                      f"q = {cq.shape[0]}", cube.packed, *rows, c["per_probe"], True)
    log(f"phase 25 (a) single cosine cube k={c['cube_k']} probes={c['probes']} window "
        f"{c['per_probe']} (slab {list(cube.packed.shape)}): build + pack + retrieve "
        f"q={cq.shape[0]} {t_cube:.1f} s")
    del cube, rows, corpus, queries, qv
    torch.cuda.empty_cache()
    return dict(launches=launches, recall=recall, build_pack_s=t_build, k1=k1, k2=k2,
                cube=dict(launches=cube_launches, recall=cube_recall, k1=cube_k1,
                          seconds=t_cube))


def wide_euclidean():
    """(b): p-stable build, augmented int8 pack (d_aug = 1,024), retrieve_topk
    at q = 8,192 (K1, S1, dedup, rerank), counted; against exact_nearest;
    K1 against its plain version on the path's windows."""
    from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, query_hashes, retrieve_topk,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        augment_queries, euclid_window_offsets,
    )

    c, n, q = WIDE["euc"], WIDE["n"], WIDE["q"]
    corpus, queries, _ = planted_clustered_corpus(
        torch.Generator(device=DEV).manual_seed(SEED + 253), n, c["d"], q, TOP_K)
    zero_counts()
    t0 = time.perf_counter()
    index = build_index(gen(SEED + 254), corpus, "euclidean", c["k"], c["L"],
                        lsh_bucket_div=c["div"], euclidean_h_w=c["w"])
    pidx = pack_index(index, corpus, dtype=torch.int8, augment=True)
    scores, ids = retrieve_topk(pidx, queries, corpus, TOP_K, per_table=c["per_table"])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = read_counts()
    wide_launches("(b) euclidean LSH", launches, ("slab_window_dots", "window_topk"))
    s1_check_kept(25)
    check_topk(scores, ids, q, n, "(b) euclidean LSH")
    recall = wide_oracle(corpus, queries, "euclidean", ids, "(b) euclidean LSH")
    del scores, ids
    qb, qd = query_hashes(pidx, queries)
    s0, sizes = euclid_window_offsets(pidx.bucket_starts, pidx.packed_detailed, qb, qd,
                                      c["per_table"])
    q_aug = augment_queries(queries, pidx.packed_aug_scale, pidx.packed.shape[2])
    k1 = wide_k1(f"(b) euclidean LSH, augmented int8 d_aug = {pidx.packed.shape[2]}, "
                 f"q = {q}", pidx.packed, s0, sizes, q_aug, c["per_table"], False)
    log(f"phase 25 (b) euclidean LSH {n} x {c['d']} k={c['k']} L={c['L']} w={c['w']} "
        f"window {c['per_table']} (slabs {list(pidx.packed.shape)}, "
        f"{pidx.packed.numel() / 2**30:.2f} GiB): build + pack + retrieve {t_run:.1f} s")
    del corpus, queries, index, pidx, s0, sizes, q_aug
    torch.cuda.empty_cache()
    return dict(launches=launches, recall=recall, seconds=t_run, k1=k1)


def wide_program(ds):
    """(c): the program's users (phase 13's dataset, 15 coins):
    ten_fold_mae on the fused engine (counted: K2; at d = 15 its
    retrieve_topk takes packed_retrieve_core in both packages, so K1 does
    not run there) beside the mask engine's, then candidate_ids_scored on
    f32 slabs of the users (d = 15, counted: K2, K1 in its f32 body, S1),
    its sets against the CPU's (equal, or equal scores where they differ),
    and on int8 slabs of the same index (rows of 15 B, not 16-byte
    aligned: K1's tensor-core body in 4-element pieces, counted); K1 against its plain
    version on each call's windows."""
    from crypto_rec_tpu_torch.config import load_config
    from crypto_rec_tpu_torch.io.native import read_header_p, score_tweets_native
    from crypto_rec_tpu_torch.io.users import build_user_matrix
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, candidate_ids_scored, pack_index, query_hashes,
    )
    from crypto_rec_tpu_torch.models.rec.engine import RatingSet
    from crypto_rec_tpu_torch.models.rec.validate import ten_fold_mae
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets

    tweets, conf = ds
    cfg = load_config(conf)
    top_p = read_header_p(tweets, cfg.csv_delimiter) or cfg.topP
    users = build_user_matrix(score_tweets_native(tweets, cfg.lexicon_file, cfg.query_file,
                                                  cfg.csv_delimiter))
    real = RatingSet.from_user_matrix(users, DEV)
    maes = {}
    cv_launches = {}
    for engine in ("fused", "mask"):
        zero_counts()
        maes[engine] = ten_fold_mae(gen(SEED + 255), real, "cosine", cfg.k, cfg.L,
                                    cfg.lsh_bucket_div, cfg.euclidean_h_w, top_p,
                                    engine=engine, candidate_budget=cfg.candidate_budget)
        cv_launches[engine] = read_counts()
    log(f"phase 25 (c) ten_fold_mae on the program's {real.ratings.shape[0]} users x "
        f"{real.ratings.shape[1]} coins: fused MAE {maes['fused']:.4f}, mask MAE "
        f"{maes['mask']:.4f}; launches {cv_launches}")
    if not cv_launches["fused"]["signproj_bucket_ids"] or not all(
            np.isfinite(v) for v in maes.values()):
        raise AssertionError(f"(c) 10-fold CV: K2 did not run or MAE {maes}")
    c = WIDE["cv"]
    index = build_index(gen(SEED + 256), real.ratings, "cosine", cfg.k, cfg.L)
    pidx = pack_index(index, real.ratings, dtype=torch.float32)
    zero_counts()
    ids = candidate_ids_scored(pidx, real.ratings, c["budget"], c["per_table"])
    torch.cuda.synchronize()
    launches = read_counts()
    wide_launches("(c) candidate_ids_scored, f32 d = 15", launches,
                  ("signproj_bucket_ids", "slab_window_dots", "window_topk"))
    s1_check_kept(25)
    cpu_idx = dataclasses.replace(
        pidx, **{f: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for f, v in vars(pidx).items() if f != "family"},
        family=dataclasses.replace(pidx.family, proj=pidx.family.proj.cpu()))
    ids_cpu = candidate_ids_scored(cpu_idx, real.ratings.cpu(), c["budget"], c["per_table"])
    qv = unit(real.ratings)
    rows = unit(real.ratings)

    def scores(x, sel):        # the rows' cosine scores, sorted, on the selected queries
        x = x[sel]
        s = (qv[sel][:, None, :] * rows[x.clamp(min=0).long()]).sum(-1)
        return torch.sort(torch.where(x >= 0, s, float("-inf")), dim=1).values

    ids_cpu = ids_cpu.to(DEV)
    differ = (torch.sort(ids, 1).values != torch.sort(ids_cpu, 1).values).any(1)
    s_card, s_cpu = scores(ids, differ), scores(ids_cpu, differ)
    fin = torch.isfinite(s_cpu)
    if not (torch.equal(fin, torch.isfinite(s_card))
            and torch.allclose(s_card[fin], s_cpu[fin], rtol=1e-5, atol=1e-5)):
        raise AssertionError("(c) candidate_ids_scored: card and CPU sets differ beyond "
                             "score ties")
    log(f"phase 25 (c) candidate_ids_scored (budget {c['budget']}, window "
        f"{c['per_table']}, f32 slabs {list(pidx.packed.shape)}): {int(differ.sum())} of "
        f"{ids.shape[0]} sets differ card against CPU, all at equal scores (1e-5)")
    qb, _ = query_hashes(pidx, qv)
    s0, sizes = _window_offsets(pidx.bucket_starts, qb, c["per_table"])
    k1 = [wide_k1(f"(c) candidate sets, f32 d = 15 (f32 body), q = {qv.shape[0]}",
                  pidx.packed, s0, sizes, qv, c["per_table"], False)]
    pidx = pack_index(index, real.ratings, dtype=torch.int8)
    zero_counts()
    ids = candidate_ids_scored(pidx, real.ratings, c["budget"], c["per_table"])
    torch.cuda.synchronize()
    launches_int8 = read_counts()
    if (tuple(ids.shape) != (real.ratings.shape[0], c["budget"])
            or not bool(((ids >= -1) & (ids < real.ratings.shape[0])).all())):
        raise AssertionError(f"(c) candidate_ids_scored, int8 d = 15: ids {tuple(ids.shape)} "
                             f"or out of range")
    wide_launches("(c) candidate_ids_scored, int8 d = 15", launches_int8,
                  ("signproj_bucket_ids", "slab_window_dots", "window_topk"))
    s1_check_kept(25)
    k1.append(wide_k1(f"(c) candidate sets, int8 d = 15 (tensor-core body: rows not "
                      f"16-byte aligned), q = {qv.shape[0]}",
                      pidx.packed, s0, sizes, qv, c["per_table"], False))
    del index, pidx, real, s0, sizes
    torch.cuda.empty_cache()
    return dict(mae=maes, cv_launches=cv_launches, launches=launches,
                launches_int8=launches_int8, sets_differ=int(differ.sum()), k1=k1)


def wide_k1_bodies():
    """(d): the CF cell's geometry (cf-jester-73k-100: a planted 73,421 x
    100 corpus, cosine k = 9, L = 8, window 287, int8 slabs padded by
    4,096 rows): retrieve_topk_pallas over every user as the cell calls it
    (int8_rerank off, 12 lanes a window), counted, each user's own row in
    its top-10; K1 on the path's windows, the tensor-core body reading the
    rows of 100 B as 4-byte words, and on bf16 slabs of the same index
    (rows of 200 B: shifted words); then f32 d = 384 (the FFMA body in
    d-chunks of 256) on a planted 200,000-row index's windows.  Each
    against its plain version, each checked to launch its body."""
    from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, query_hashes, retrieve_topk_pallas,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets

    c = WIDE["jester"]
    corpus, _, _ = planted_clustered_corpus(
        torch.Generator(device=DEV).manual_seed(SEED + 270), c["n"], c["d"], 1, TOP_K)
    index = build_index(gen(SEED + 271), corpus, "cosine", c["k"], c["L"])
    pidx = pack_index(index, corpus, dtype=torch.int8, pad=c["pad"])
    zero_counts()
    scores, ids = retrieve_topk_pallas(pidx, corpus, corpus, TOP_K, per_table=c["per_table"],
                                       int8_rerank=False, stage1_per_table=c["stage1"])
    torch.cuda.synchronize()
    launches = read_counts()
    wide_launches("(d) the CF cell's geometry, int8 d = 100", launches,
                  ("signproj_bucket_ids", "slab_window_dots", "window_topk"))
    s1_check_kept(25)
    check_topk(scores, ids, c["n"], c["n"], "(d) the CF cell's geometry")
    own = float((ids == torch.arange(c["n"], device=ids.device)[:, None]).any(1)
                .float().mean())
    log(f"phase 25 (d) the CF cell's geometry: retrieve_topk_pallas over all {c['n']} users "
        f"(slabs {list(pidx.packed.shape)}, window {c['per_table']}): each user's own row "
        f"in its top-{TOP_K} for {own:.4f} of them (floor {c['floor']})")
    if own < c["floor"]:
        raise AssertionError(f"(d) the CF cell's geometry: own row found for {own:.4f}")
    del scores, ids
    qv = unit(corpus)
    qb, _ = query_hashes(pidx, qv)
    s0, sizes = _window_offsets(pidx.bucket_starts, qb, c["per_table"])
    k1 = [wide_k1(f"(d) the CF cell's geometry, int8 d = 100 (tensor-core body, 4-byte "
                  f"words), q = {c['n']}", pidx.packed, s0, sizes, qv, c["per_table"], False,
                  body="tile_dots_mma")]
    pidx = pack_index(index, corpus, dtype=torch.bfloat16, pad=c["pad"])
    k1.append(wide_k1(f"(d) the CF cell's windows on bf16 slabs, d = 100 (tensor-core body, "
                      f"shifted words), q = {c['n']}", pidx.packed, s0, sizes, qv,
                      c["per_table"], False, body="tile_dots_mma"))
    del corpus, index, pidx, qv, s0, sizes
    f = WIDE["ffma"]
    corpus, queries, _ = planted_clustered_corpus(
        torch.Generator(device=DEV).manual_seed(SEED + 272), f["n"], f["d"], f["q"], TOP_K)
    index = build_index(gen(SEED + 273), corpus, "cosine", f["k"], f["L"])
    pidx = pack_index(index, corpus, dtype=torch.float32)
    qv = unit(queries)
    qb, _ = query_hashes(pidx, qv)
    s0, sizes = _window_offsets(pidx.bucket_starts, qb, f["per_table"])
    k1.append(wide_k1(f"(d) f32 d = {f['d']} (FFMA body, d-chunks of 256), q = {f['q']}",
                      pidx.packed, s0, sizes, qv, f["per_table"], False,
                      body="tile_dots_ffma"))
    del corpus, queries, index, pidx, qv, s0, sizes
    torch.cuda.empty_cache()
    return dict(launches=launches, own_row_found=own, k1=k1)


def wide_cf_engine():
    """(e): the CF engine at the CF cell's shape (cf-jester-73k-100): the
    P = 20 neighbours of all 73,421 users from (d)'s planted corpus and
    index, known density 0.56; recommend_topk_retrieved counted (the
    prediction kernel and S1's top-5 must run), the kernel against
    cf_predict_plain (rtol / atol 1e-5: summation order only), the top-5
    against the stable sort's on the same predictions (equal); the kernel
    timed beside the plain version, with the profiler's device time and
    its byte bound."""
    from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, retrieve_topk_pallas,
    )
    from crypto_rec_tpu_torch.models.rec.engine import RatingSet, recommend_topk_retrieved
    from crypto_rec_tpu_torch.ops import topk
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.cfpredict import cf_predict, cf_predict_plain

    c = WIDE["jester"]
    n, d, P = c["n"], c["d"], c["top_p"]
    corpus, _, _ = planted_clustered_corpus(
        torch.Generator(device=DEV).manual_seed(SEED + 270), n, d, 1, TOP_K)
    pidx = pack_index(build_index(gen(SEED + 271), corpus, "cosine", c["k"], c["L"]),
                      corpus, dtype=torch.int8, pad=c["pad"])
    sims, nb = retrieve_topk_pallas(pidx, corpus, corpus, P, per_table=c["per_table"],
                                    int8_rerank=False, stage1_per_table=c["stage1"])
    del pidx
    known = torch.rand(n, d, generator=torch.Generator(device=DEV).manual_seed(SEED + 274),
                       device=DEV) < c["density"]
    users = RatingSet(corpus, known, (corpus * known).sum(1) / known.sum(1).clamp(min=1))
    zero_counts()
    rec = recommend_topk_retrieved(users, users, sims, nb, TOP_N)
    torch.cuda.synchronize()
    launches = read_counts()
    label = f"(e) the CF engine at the CF cell's shape, q = {n}, P = {P}, c = {d}"
    wide_launches(label, launches, ("cf_predict", "window_topk"))
    valid = nb >= 0
    args = (corpus, known, users.mean, corpus, users.mean, sims,
            torch.clamp(nb, min=0) * valid, valid)
    want = cf_predict_plain(*args)
    err = float((rec.predicted - want).abs().max())
    if not torch.allclose(rec.predicted, want, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{label}: kernel against plain, max |err| {err:.3g}")
    vals, idx = topk._topk_padded(torch.where(~known, rec.predicted, topk.NEG_INF), TOP_N)
    if not torch.equal(rec.top_n, torch.where(vals > topk.NEG_INF, idx, -1)):
        raise AssertionError(f"{label}: S1's top-{TOP_N} differs from the stable sort's")
    e = rounds_ms(dict(ms=lambda: cf_predict(*args), plain_ms=lambda: cf_predict_plain(*args),
                       library_ms=None), rounds=3)
    e = with_bound(dict(e, geometry=label, max_abs_err=err),
                   bounds.cf_predict_call(n, P, d, n, nb.element_size()))
    e["device_ms"] = device_ms(lambda: cf_predict(*args), KERNEL_NAMES["cf_predict"])
    log(f"phase 25 {label}: max |err| {err:.3g} against the plain version; top-{TOP_N} "
        f"equal to the stable sort's; {e['ms']:.3f} ms a call (events; plain "
        f"{e['plain_ms']:.3f}), device time of the kernel {e['device_ms']:.4f} ms (profiler), "
        f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
        f"{100 * e['bound_ms'] / e['device_ms']:.1f}% of it by device time; "
        f"neighbour slots used {float(valid.float().mean()):.4f}; {CARD}")
    del corpus, known, users, sims, nb, rec, want, args
    torch.cuda.empty_cache()
    return dict(launches=launches, kernel=e)


def wide_s1_tied():
    """S1 past one launch on tied rows: [R, 40,960] and [R, 131,072] at
    k = 40 (two levels), [R, 8,192] at k = 2,048 (the radix select): equal
    to topk_desc bit for bit on the card, and on the CPU on the first rows;
    timed beside torch.topk and topk_desc, with the profiler's device time."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    out = []
    S1["quiet"] = True
    for i, (m, k, R) in enumerate(WIDE["s1"]):
        v = _s1_tied_rows(R, m, SEED + 260 + i)
        got, same = _s1_against_plain(v, k)
        c = min(R, WIDE["s1_cpu_rows"])
        cpu = topk_desc(v[:c].cpu(), k)
        sets, orders = _differ(got[1][:c], cpu[1])
        vbits = torch.equal(got[0][:c].cpu().view(torch.int32), cpu[0].view(torch.int32))
        if not same or sets or orders or not vbits:
            raise AssertionError(f"S1 [{R}, {m}] k = {k}: equal to topk_desc on the card "
                                 f"{same}; card against CPU: {sets} sets, {orders} orders "
                                 f"differ, values equal {vbits}")
        e = s1_time(v, k)
        e["device_ms"] = device_ms(lambda: window_topk(v, k), KERNEL_NAMES["window_topk"])
        e.update(phase=25, input="tied rows", shape=[R, m, k], max_abs_err=0.0, cpu_rows=c,
                 sets_differ=sets, order_differs=orders)
        log(f"phase 25 S1 [{R}, {m}] k = {k}, tied rows: equal to topk_desc bit for bit on "
            f"the card; {sets} of {c} sets differ card against CPU, {orders} orders; "
            f"device time of the kernels {e['device_ms']:.3f} ms a call (profiler)")
        s1_line(25, "tied rows", e)
        out.append(e)
        del v, got
    S1["quiet"] = False
    torch.cuda.empty_cache()
    return out


def wide_launches_of(wide, name):
    """Phase 25's counted runs' launches of one kernel, by path."""
    return {"wide cosine LSH": wide["cosine"]["launches"][name],
            "wide cosine cube": wide["cosine"]["cube"]["launches"][name],
            "wide euclidean LSH": wide["euclidean"]["launches"][name],
            "wide candidate sets f32 d = 15": wide["program"]["launches"][name],
            "wide candidate sets int8 d = 15": wide["program"]["launches_int8"][name],
            "wide CF cell geometry int8 d = 100": wide["bodies"]["launches"][name]}


def phase25(ds):
    """Wide rows: (a), (b), (c) and (d) above, then S1 on tied rows past one
    launch.  -> results; each path's launches must show its kernels."""
    t0 = time.perf_counter()
    res = dict(cosine=wide_cosine(), euclidean=wide_euclidean(), program=wide_program(ds),
               bodies=wide_k1_bodies(), cf=wide_cf_engine(), s1_tied=wide_s1_tied())
    res["seconds"] = time.perf_counter() - t0
    log(f"phase 25 wide rows: {res['seconds']:.1f} s")
    return res


# D1 at the two cells' stage-1 shapes: (q, windows T, window lanes, kk, top_k,
# slab rows n_pad, corpus rows)
D1 = dict(cf=dict(q=73_421, T=8, win=384, kk=12, k=20, n_pad=77_824, n_rows=73_421),
          batch=dict(q=8192, T=8, win=640, kk=40, k=40, n_pad=1_000_448, n_rows=1_000_000))


def d1_case(c, seed):
    """S1's lanes over random dots at a cell's shape ([q T, win] -> kk a
    window), with random window starts into T CSR tables of pad-ended rows
    (a table's rows in one random order, so the tables share rows as the
    index's do)."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk

    g = torch.Generator(device=DEV).manual_seed(seed)
    q, T, win, kk = c["q"], c["T"], c["win"], c["kk"]
    s1, lane = window_topk(torch.randn(q * T, win, generator=g, device=DEV), kk)
    aligned = torch.randint(0, c["n_pad"] - win + 1, (q, T), generator=g, device=DEV,
                            dtype=torch.int32)
    perm = torch.randperm(c["n_pad"], generator=g, device=DEV)
    rows = torch.where(perm < c["n_rows"], perm, c["n_rows"]).to(torch.int32).expand(T, -1)
    return s1.reshape(q, T * kk), lane.reshape(q, T * kk), (aligned, rows.contiguous(), win, kk)


def phase26():
    """D1 alone at both cells' shapes, on S1's lanes of random dots: one
    launch, bit for bit the plain route (`lane_ids` + `dedup_topk_plain`),
    timed against it in alternating rounds (events), the profiler's device
    ms of the kernel, its byte bound (`bounds.dedup_call`) and the share."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.deduptopk import (
        dedup_topk, dedup_topk_plain, lane_ids,
    )

    res = {}
    for name, c in D1.items():
        s1, lane, win = d1_case(c, SEED + 261)
        n_rows, k = c["n_rows"], c["k"]
        zero_counts()
        got = dedup_topk(s1, lane, n_rows, k, *win)
        torch.cuda.synchronize()
        if read_counts()["dedup_topk"] != 1:
            raise AssertionError(f"phase 26 {name}: {read_counts()['dedup_topk']} D1 launches")

        def plain():
            return dedup_topk_plain(s1, lane_ids(s1, lane, *win, n_rows), n_rows, k)

        want = plain()
        if not (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                and torch.equal(got[1], want[1])):
            raise AssertionError(f"phase 26 {name}: D1 differs from the plain route")
        label = f"D1 at the {name} cell's shape [{c['q']}, {s1.shape[1]}] -> {k}"
        e = rounds_ms(dict(ms=lambda: dedup_topk(s1, lane, n_rows, k, *win),
                           plain_ms=plain, library_ms=None))
        e = with_bound(dict(e, geometry=label, max_abs_err=0.0),
                       bounds.dedup_call(c["q"], s1.shape[1], k, lane.element_size(), c["T"]))
        e["device_ms"] = device_ms(lambda: dedup_topk(s1, lane, n_rows, k, *win),
                                   KERNEL_NAMES["dedup_topk"])
        kept = float((got[1] >= 0).float().mean())
        log(f"phase 26 {label}: bit for bit the plain route; {e['ms']:.4f} ms a call "
            f"(events; plain {e['plain_ms']:.3f}), device {e['device_ms']:.4f} ms (profiler), "
            f"bound {e['bound_ms']:.4f} ms ({e['bound_by']}), "
            f"{100 * e['bound_ms'] / e['device_ms']:.1f}% of it by device time; output slots "
            f"filled {kept:.4f}; {CARD}")
        res[name] = e
        del s1, lane, win, got, want
        torch.cuda.empty_cache()
    return res


def main() -> int:
    global T_START
    T_START = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "crypto_rec_tpu_torch")):
        print("chip_smoke: no crypto_rec_tpu_torch/ beside the script; run it from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, here)
    from crypto_rec_tpu_torch import checkpoint
    from crypto_rec_tpu_torch.config import RecConfig
    from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, query_hashes, retrieve_topk_pallas,
    )
    from crypto_rec_tpu_torch.models.rec.engine import (
        RatingSet, recommend_topk_retrieved,
    )
    from crypto_rec_tpu_torch.models.rec.pipeline import lsh_phase
    from crypto_rec_tpu_torch.ops.kernels import build
    from crypto_rec_tpu_torch.ops.kernels.cfpredict import cf_predict
    from crypto_rec_tpu_torch.ops.kernels.deduptopk import dedup_topk
    from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        _window_offsets, slab_topk, slab_window_dots, window_len,
    )
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.oracle import exact_nearest, recall_at_k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- 1. device ----
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD = smi
    log(smi)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- 2. kernel build ----
    t0 = time.perf_counter()
    lib_path = build.library_path()
    build.library()
    log(f"phase 2 build: {time.perf_counter() - t0:.2f} s "
        f"({lib_path.relative_to(build.BUILD_DIR.parent.parent)})")
    s1_record()

    # ---- 3. K2 against its plain version ----
    gen = torch.Generator(device=dev).manual_seed(SEED)
    corpus, queries_all, true_all = planted_clustered_corpus(
        gen, N, D, max(BATCHES), TOP_K)
    proj = CosineLsh.create(torch.Generator().manual_seed(SEED + 1), D, K, L, dev).proj
    k2 = check_k2(corpus, proj, K, L)
    k2["geometry"] += " (the index build)"
    k2_line(3, k2)

    # ---- 4. K1 against its plain version (the slice's int8 index) ----
    index = pack_index(build_index(None, corpus, "cosine", K, L,
                                   family=CosineLsh(proj, K, L)),
                       corpus, dtype=torch.int8)
    qv = torch.nn.functional.normalize(queries_all[:BATCHES[0]], dim=1)
    qb, _ = query_hashes(index, qv)
    s0, sizes = _window_offsets(index.bucket_starts, qb, PER_TABLE)
    k1_geoms = []
    k1_err = k1_check("CF leg", index.packed, s0, sizes, qv, PER_TABLE, False)
    k1_main = k1_time(f"CF leg, q = {BATCHES[0]}", index.packed, s0, sizes, qv,
                      PER_TABLE, False)
    k1_main["max_abs_err"] = k1_err
    k1_line(4, k1_main, k1_err)
    # a hot tile: half the queries on the first query's buckets
    hot = BATCHES[0] // 2
    s0h, sizesh = s0.clone(), sizes.clone()
    s0h[:hot], sizesh[:hot] = s0[0], sizes[0]
    err_hot = k1_check("hot tile", index.packed, s0h, sizesh, qv, PER_TABLE, False)
    e = k1_time(f"CF leg, hot tile ({hot} queries on one window set), q = {BATCHES[0]}",
                index.packed, s0h, sizesh, qv, PER_TABLE, False)
    e["max_abs_err"] = err_hot
    k1_line(4, e, err_hot)
    k1_geoms.append(e)
    k1_err = max(k1_err, err_hot)
    del index, s0h, sizesh

    # ---- 5. the slice end to end ----
    kq = torch.Generator(device=dev).manual_seed(SEED + 11)
    n_known = torch.rand(N, D, generator=kq, device=dev) < 0.6
    n_mean = (corpus * n_known).sum(1) / n_known.sum(1).clamp(min=1)
    nset = RatingSet(ratings=corpus, known=n_known, mean=n_mean)
    q_known = torch.rand(max(BATCHES), D, generator=kq, device=dev) < 0.6
    q_mean = (queries_all * q_known).sum(1) / q_known.sum(1).clamp(min=1)
    counters = (signproj_bucket_ids, slab_window_dots, window_topk, cf_predict, dedup_topk)
    S1["phase"] = 5

    # The counted main-path run: build, pack, retrieve and score one batch.
    # Counts are zeroed just before it and read just after; every other
    # launch (the comparisons above, the timings below) is left out.
    qset0 = RatingSet(ratings=queries_all[:BATCHES[0]],
                      known=q_known[:BATCHES[0]], mean=q_mean[:BATCHES[0]])
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    index = build_index(torch.Generator().manual_seed(SEED + 1), corpus,
                        "cosine", K, L)
    sync()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    pidx = pack_index(index, corpus, dtype=torch.int8)
    sync()
    t_pack = time.perf_counter() - t0
    rec0 = recommend_topk_retrieved(
        qset0, nset,
        *retrieve_topk_pallas(pidx, qset0.ratings, corpus, top_k=TOP_P,
                              per_table=PER_TABLE, int8_rerank=False,
                              stage1_per_table=12),
        TOP_N)
    sync()
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"phase 5 main-path launches (build + pack + retrieve + CF, "
        f"q={BATCHES[0]}): {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    log(f"phase 5 index: build {t_build:.3f} s, int8 pack {t_pack:.3f} s "
        f"(slabs {tuple(pidx.packed.shape)}, "
        f"{pidx.packed.numel() / 2**30:.2f} GiB)")
    recall0 = recall_at_k(rec0.neighbor_idx[:, :TOP_K], true_all[:BATCHES[0]])
    if recall0 < 0.99:
        raise AssertionError(f"recall@{TOP_K} {recall0:.4f} < 0.99 on the counted run")
    del rec0
    e2e = {}
    for qn in BATCHES:
        qs = queries_all[:qn]
        qset = RatingSet(ratings=qs, known=q_known[:qn], mean=q_mean[:qn])

        def retrieve():
            return retrieve_topk_pallas(
                pidx, qs, corpus, top_k=TOP_P, per_table=PER_TABLE,
                int8_rerank=False, stage1_per_table=12)

        sims, nidx = retrieve()
        t_ret = wall_ms(retrieve)
        t_cf = wall_ms(lambda: recommend_topk_retrieved(qset, nset, sims, nidx, TOP_N))
        t_e2e = wall_ms(lambda: recommend_topk_retrieved(qset, nset, *retrieve(), TOP_N))
        rec = recommend_topk_retrieved(qset, nset, *retrieve(), TOP_N)
        recall = recall_at_k(rec.neighbor_idx[:, :TOP_K], true_all[:qn])
        if tuple(rec.predicted.shape) != (qn, D) or tuple(rec.top_n.shape) != (qn, TOP_N):
            raise AssertionError("CF: output shapes")
        if not bool(torch.isfinite(rec.predicted).all()):
            raise AssertionError("CF: non-finite predictions")
        if not bool(((rec.top_n >= -1) & (rec.top_n < D)).all()):
            raise AssertionError("CF: top-n coin index out of range")
        # the recommended coins are unknown to the user, best first
        picked = rec.top_n.clamp(min=0).long()
        if bool(torch.gather(qset.known, 1, picked)[rec.top_n >= 0].any()):
            raise AssertionError("CF: recommended a known coin")
        # the device pieces of one retrieval, for the time breakdown
        qv = torch.nn.functional.normalize(qs, dim=1)
        t_hash = cuda_ms(lambda: query_hashes(pidx, qv))
        qb, _ = query_hashes(pidx, qv)
        s0, sizes = _window_offsets(pidx.bucket_starts, qb, PER_TABLE)
        k1 = k1_time(f"CF leg, q = {qn}", pidx.packed, s0, sizes, qv, PER_TABLE, False,
                     rounds=3)
        k1_line(5, k1)
        k1_geoms.append(k1)
        t_k1 = k1["ms"]
        dots, a0 = slab_window_dots(pidx.packed, s0, sizes, qv, PER_TABLE, mask=False)
        t_epi = cuda_ms(lambda: slab_topk(dots, a0, pidx.packed_rows, N, TOP_P,
                                          exact=False, stage1_per_table=12))
        del dots, a0
        e2e[qn] = dict(retrieval_ms=t_ret, cf_ms=t_cf, e2e_ms=t_e2e,
                       users_per_s=qn / t_e2e * 1e3, recall=recall)
        log(f"phase 5 q={qn}: retrieval {t_ret:.3f} ms ({qn / t_ret * 1e3:,.0f} q/s), "
            f"CF scoring {t_cf:.3f} ms, end to end {t_e2e:.3f} ms = "
            f"{qn / t_e2e * 1e3:,.0f} users/s, neighbour recall@{TOP_K} {recall:.4f}; "
            f"device: hash {t_hash:.3f} ms, K1 {t_k1:.3f} ms, epilogue {t_epi:.3f} ms")
        if recall < 0.99:
            raise AssertionError(f"recall@{TOP_K} {recall:.4f} < 0.99 at q={qn}")
    # exact-NN oracle on a small input: the retrieved top-10 against the
    # brute-force top-10 (the planted rows are the true nearest)
    _, exact = exact_nearest(queries_all[:256], corpus, "cosine", TOP_K)
    _, got = retrieve_topk_pallas(pidx, queries_all[:256], corpus, top_k=TOP_K,
                                  per_table=PER_TABLE, int8_rerank=False)
    oracle_recall = recall_at_k(got, exact)
    log(f"phase 5 oracle: recall@{TOP_K} against exact NN on 256 queries "
        f"{oracle_recall:.4f}")
    if oracle_recall < 0.99:
        raise AssertionError("retrieval disagrees with the exact oracle")
    oracle_streamed = streamed_oracle_2m(corpus, queries_all)
    s1_check_kept(5)

    # ---- 6. lsh_phase(engine="fused") ----
    # phases 6-7 are counted apart: they must reach the kernels too
    S1["phase"] = 6
    for fn in counters:
        fn.launches = 0
    cfg = RecConfig(k=K, L=L, candidate_budget=PER_TABLE, pack_dtype="int8",
                    engine="fused")
    qn = BATCHES[0]
    qset = RatingSet(ratings=queries_all[:qn], known=q_known[:qn], mean=q_mean[:qn])
    t0 = time.perf_counter()
    rec = lsh_phase(SEED + 2, qset, nset, cfg, top_n=TOP_N, top_p=TOP_P)
    sync()
    t_phase = time.perf_counter() - t0
    has = float(rec.has_neighbors.float().mean())
    recall = recall_at_k(rec.neighbor_idx[:, :TOP_K], true_all[:qn])
    log(f"phase 6 lsh_phase fused (build + pack + retrieve + CF, q={qn}): "
        f"{t_phase:.3f} s, has_neighbors {has:.4f}, recall@{TOP_K} {recall:.4f}")
    if tuple(rec.predicted.shape) != (qn, D) or tuple(rec.top_n.shape) != (qn, TOP_N):
        raise AssertionError("lsh_phase: output shapes")
    if has < 0.99:
        raise AssertionError(f"lsh_phase: only {has:.4f} of queries have neighbours")
    del rec

    # ---- 7. serving ----
    import numpy as np

    S1["phase"] = 7

    q_host = queries_all.cpu().numpy()
    true_host = true_all.cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        idx_path = os.path.join(tmp, "idx.npz")
        checkpoint.save_index(idx_path, index)          # unpacked
        corpus_path = os.path.join(tmp, "corpus.npz")
        np.savez(corpus_path, vectors=corpus.cpu().numpy())
        for req, t_req, recall in serve_requests(
                tmp, idx_path, corpus_path, q_host, true_host,
                ["--per-table", str(PER_TABLE), "--pack"]):
            log(f"phase 7 request {req}: {REQ_Q} queries answered in {t_req:.2f} s "
                f"(restore + bf16 pack + retrieve), recall@{TOP_K} {recall:.4f}")
            if recall < 0.99:
                raise AssertionError(f"request {req}: served recall too low")
    launches67 = {fn.__name__: fn.launches for fn in counters}
    log(f"phase 7 launches in phases 6-7: {launches67}")
    if not all(launches67.values()):
        raise AssertionError(f"a kernel did not run in phases 6-7: {launches67}")


    # ---- 8-11. euclidean LSH, cubes and MultiCubes on the same corpus ----
    del index, nset, n_known, qset, qset0, sims, nidx     # pidx: phase 15
    torch.cuda.empty_cache()
    S1["phase"] = 8
    geoms, k2_l1 = phase8(corpus, queries_all)
    k1_geoms += geoms
    S1["phase"] = 9
    eidx, euclid = phase9(corpus, queries_all, true_all)
    paths = {"euclidean LSH": euclid}
    S1["phase"] = 10
    for i, leg in enumerate(CUBE_LEGS):
        paths[leg[0]] = cube_leg(corpus, queries_all, true_all, *leg, seed=SEED + 30 + i)
    k1_geoms += [r.pop("k1") for r in paths.values()]
    S1["phase"] = 11
    serving = phase11(eidx, corpus, q_host, true_host)
    del eidx
    torch.cuda.empty_cache()
    S1["phase"] = 12
    probe_checks, probes, probe_launches = phase12(corpus, queries_all, true_all, smi)
    torch.cuda.empty_cache()

    # ---- 13-15. the recommender program, 10-fold CV, scored candidate sets ----
    ds_dir = tempfile.TemporaryDirectory()
    S1["phase"] = 13
    ds, program = phase13(ds_dir.name)
    S1["phase"] = 14
    cv = phase14()
    S1["phase"] = 15
    scored = phase15(pidx, queries_all, true_all)

    # ---- 16-21. card against CPU, and the rest of the single-chip package ----
    S1["phase"] = 16
    card_vs_cpu = phase16()
    S1["phase"] = 17
    program_fused = phase17(ds, program["summary"]["phase_ms"]["lsh_A"])
    index = dataclasses.replace(pidx, packed=None, packed_rows=None, packed_gscale=None)
    del pidx
    torch.cuda.empty_cache()
    S1["phase"] = 18
    nonkernel = phase18(corpus, queries_all, true_all, index, q_host, true_host)
    del index
    S1["phase"] = 19
    streamed = phase19()
    S1["phase"] = 20
    ivf = phase20(corpus, queries_all, true_all)
    S1["phase"] = 21
    clis = phase21(ds)

    # ---- 22. the sharded engines, NCCL at world size 1 ----
    S1["phase"] = 22
    sharded = phase22(corpus, queries_all, true_all, q_known, q_mean, e2e[BATCHES[0]]["recall"],
                      BATCHES[0] / e2e[BATCHES[0]]["retrieval_ms"] * 1e3)
    k1_sharded = sharded["mp4"].pop("k1")

    # ---- 23. the repaired top-k sites, card against CPU on tied inputs ----
    S1["phase"] = 23
    ties = phase23()
    k1_per_row = nonkernel["k1_per_row"]["k1"]

    # ---- 24. S1 at every stage-1 shape of the run, on tied rows ----
    S1["phase"] = 24
    s1_tied = phase24()

    # ---- 25. the paths at the public sets' widths ----
    S1["phase"] = 25
    wide = phase25(ds)
    ds_dir.cleanup()

    # ---- 26. D1, the dedup top-k, alone at both cells' shapes ----
    d1 = phase26()
    wide_k1 = [wide["cosine"]["k1"], wide["cosine"]["cube"]["k1"],
               wide["euclidean"]["k1"]] + wide["program"]["k1"] + wide["bodies"]["k1"]

    def path_launches(name):
        return {p: r["launches"][name] for p, r in paths.items()}

    cf_shape = [BATCHES[0] * L, window_len(PER_TABLE), 12]
    s1_main = next((e for e in S1["dots"] if e["shape"] == cf_shape), None)
    if s1_main is None:
        raise AssertionError(f"S1 was not checked at the CF point {cf_shape}: "
                             f"{[e['shape'] for e in S1['dots']]}")

    row_keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "share_of_bound")
    kernels = [
        dict(name="signproj_bucket_ids", route="cuda",
             source="crypto_rec_tpu_torch/csrc/signproj.cu",
             replaces="crypto_rec_tpu/ops/pallas/signproj.py:61",
             launches=launches["signproj_bucket_ids"], max_abs_err=k2["max_abs_err"],
             **{key: k2[key] for key in row_keys}, card=CARD,
             geometries=[k2, k2_l1, program["k2"], cv["k2"], wide["cosine"]["k2"]],
             path_launches=dict(path_launches("signproj_bucket_ids"),
                                program=program["launches"]["signproj_bucket_ids"],
                                cv=cv["launches"]["signproj_bucket_ids"],
                                program_fused=program_fused["launches"]["signproj_bucket_ids"],
                                streamed=streamed["launches"]["signproj_bucket_ids"],
                                **{f"cluster_cli {a}": r["launches"]["signproj_bucket_ids"]
                                   for a, r in clis.items() if a != "recommend"},
                                serve_recommend=clis["recommend"]["launches"][
                                    "signproj_bucket_ids"],
                                **{f"sharded {m}": sharded[m]["launches"]["signproj_bucket_ids"]
                                   for m in ("mp1", "mp4")},
                                **wide_launches_of(wide, "signproj_bucket_ids"))),
        dict(name="slab_window_dots", route="cuda",
             source="crypto_rec_tpu_torch/csrc/slabtile.cu",
             replaces="crypto_rec_tpu/ops/pallas/slabscore.py:360",
             launches=launches["slab_window_dots"],
             max_abs_err=max(k1_err, k1_per_row["max_abs_err"],
                             *(e["max_abs_err"] for e in wide_k1)),
             **{key: k1_main[key] for key in row_keys}, card=CARD,
             geometries=[k1_main] + k1_geoms + [streamed["k1"], k1_sharded, k1_per_row]
             + wide_k1,
             path_launches=dict(path_launches("slab_window_dots"),
                                scored_sets=scored["launches"]["slab_window_dots"],
                                **{f"per-row int8 {m}": r["launches"]["slab_window_dots"]
                                   for m, r in nonkernel["k1_per_row"]["retrieve"].items()},
                                streamed=streamed["launches"]["slab_window_dots"],
                                program_fused=program_fused["launches"]["slab_window_dots"],
                                serve_unpacked=nonkernel["serve_unpacked"]["launches"][
                                    "slab_window_dots"],
                                **{f"sharded {m}": sharded[m]["launches"]["slab_window_dots"]
                                   for m in ("mp1", "mp4")},
                                **wide_launches_of(wide, "slab_window_dots"))),
        dict(name="slab_window_dots", route="cuda",
             source="crypto_rec_tpu_torch/csrc/slabtile.cu",
             replaces="crypto_rec_tpu/ops/pallas/slabscore.py:360",
             launches=cv["launches"]["slab_window_dots"], max_abs_err=cv["k1"]["max_abs_err"],
             **{key: cv["k1"][key] for key in row_keys}, card=CARD, geometries=[cv["k1"]],
             note="f32 slabs, d = 128 (f32 FFMA): the 10-fold CV leg, phase 14"),
        dict(name="window_topk", route="cuda",
             source="crypto_rec_tpu_torch/csrc/windowtopk.cu",
             replaces="crypto_rec_tpu/ops/pallas/slabscore.py:486",
             launches=launches["window_topk"],
             max_abs_err=max(e["max_abs_err"] for e in S1["dots"] + s1_tied + wide["s1_tied"]),
             **{key: s1_main.get(key) for key in row_keys}, card=CARD,
             geometries=S1["dots"] + s1_tied + wide["s1_tied"],
             path_launches=dict(
                 path_launches("window_topk"), phases_6_7=launches67["window_topk"],
                 serving_euclidean=serving["launches"]["window_topk"],
                 probes=probe_launches["window_topk"], cv=cv["launches"]["window_topk"],
                 scored_sets=scored["launches"]["window_topk"],
                 **{f"per-row int8 {m}": r["launches"]["window_topk"]
                    for m, r in nonkernel["k1_per_row"]["retrieve"].items()},
                 streamed=streamed["launches"]["window_topk"],
                 **{f"sharded {m}": sharded[m]["launches"]["window_topk"]
                    for m in ("mp1", "mp4")},
                 **wide_launches_of(wide, "window_topk")),
             bodies=S1_BODIES,
             note="S1, the stage-1 selection of K1's dots; no Pallas kernel: it replaces "
                  "the XLA selections jax.lax.approx_max_k / lax.top_k at "
                  "crypto_rec_tpu/ops/pallas/slabscore.py:486, :501, :503 and "
                  "models/lsh/hypercube.py:473, :674, :778; equal to topk_desc bit for "
                  "bit; library_ms: torch.topk; row: the CF point, phase 5, q = 8,192"),
    ]

    cf_row = wide["cf"]["kernel"]
    kernels.append(dict(
        name="cf_predict", route="cuda", source="crypto_rec_tpu_torch/csrc/cfpredict.cu",
        replaces="none: XLA ops at crypto_rec_tpu/models/rec/engine.py:61 (predict_scores)",
        launches=launches["cf_predict"], max_abs_err=cf_row["max_abs_err"],
        **{key: cf_row.get(key) for key in row_keys}, card=CARD, geometries=[cf_row],
        path_launches=dict(path_launches("cf_predict"), phases_6_7=launches67["cf_predict"],
                           program=program["launches"]["cf_predict"],
                           cv=cv["launches"]["cf_predict"],
                           program_fused=program_fused["launches"]["cf_predict"],
                           **{f"sharded {m}": sharded[m]["launches"]["cf_predict"]
                              for m in ("mp1", "mp4")},
                           cf_cell_shape=wide["cf"]["launches"]["cf_predict"]),
        note="the CF engine's prediction (engine.predict_scores on CUDA tensors); row: the "
             "CF cell's shape, phase 25 (e), q = 73,421, P = 20, c = 100"))

    kernels.append(dict(
        name="dedup_topk", route="cuda", source="crypto_rec_tpu_torch/csrc/deduptopk.cu",
        replaces="none: XLA ops at crypto_rec_tpu/ops/pallas/slabscore.py:399 "
                 "(_dedup_topk_pairs)",
        launches=launches["dedup_topk"], max_abs_err=0.0,
        **{key: d1["cf"].get(key) for key in row_keys}, card=CARD,
        geometries=[d1["cf"], d1["batch"]],
        path_launches=dict(path_launches("dedup_topk"), phases_6_7=launches67["dedup_topk"],
                           cv=cv["launches"]["dedup_topk"],
                           **{f"sharded {m}": sharded[m]["launches"]["dedup_topk"]
                              for m in ("mp1", "mp4")}),
        note="the dedup top-k epilogue (slab_topk's stage 2 and _dedup_topk_pairs on CUDA "
             "tensors), bit for bit the plain route; row: the CF cell's shape, phase 26"))

    def probe_row(name, source, replaces, rows, **extra):
        """A probe kernel's row: launches from phase 12's counted run, the
        worst error and the first geometry's times."""
        return dict(name=name, route="cuda", source=f"crypto_rec_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=probe_launches[name],
                    max_abs_err=max(r["max_abs_err"] for r in rows),
                    **{key: rows[0].get(key) for key in row_keys}, card=CARD,
                    geometries=rows, **extra)

    variants = probe_checks["variants"]
    kernels += [
        probe_row("slab_window_dots", "slabtile.cu",
                  "benchmarks/experiments/probe_r3_mask.py:114", probe_checks["k1"],
                  note="P1 dots_nomask, and the vpu modes of P2 and P4: K1 with mask off"),
        probe_row("binned_dots", "probetile.cu",
                  "benchmarks/experiments/probe_r3_binned.py:98", probe_checks["binned"],
                  note="tile-major on the tensor cores"),
        probe_row("load_floor", "probetile.cu",
                  "benchmarks/experiments/probe_r3_split.py:156", variants[:2],
                  note="mode load_floor (zeros), tile-major with no product (bf16, int8)"),
        probe_row("rounded_query_dots", "probetile.cu",
                  "benchmarks/experiments/probe_r3_split.py:156", variants[2:3],
                  note="mode rounded_query (mxu_rep, mxu_tile), tile-major on the tensor "
                       "cores"),
        probe_row("i8_dots", "probetile.cu",
                  "benchmarks/experiments/probe_r3_final.py:99", variants[3:],
                  note="mode i8_dot (mxu_i8), tile-major on the int8 tensor cores"),
        probe_row("blk_window_dots", "probetile.cu",
                  "benchmarks/experiments/probe_r4_blk.py:132", probe_checks["blk"],
                  note="tile-major on the tensor cores"),
        probe_row("slab_window_dots_int4", "probetile.cu",
                  "benchmarks/experiments/probe_r5_int4.py:139", [probe_checks["int4"]],
                  note="tile-major on the tensor cores"),
    ]
    for r in (cv, program):
        r.pop("k1", None)
        r.pop("k2")
    for r in (wide["cosine"], wide["cosine"]["cube"], wide["euclidean"], wide["program"],
              wide["bodies"]):
        r.pop("k1")
    wide["cosine"].pop("k2")
    wide.pop("s1_tied")
    streamed.pop("k1")
    nonkernel["k1_per_row"].pop("k1")
    wall = time.perf_counter() - T_START
    log(f"chip_smoke wall time: {wall:.1f} s")
    print(json.dumps({"kernels": kernels, "e2e": e2e, "paths": paths,
                      "serving_euclidean": serving, "probes": probes, "program": program,
                      "cv": cv, "scored_sets": scored, "card_vs_cpu": card_vs_cpu,
                      "program_fused": program_fused, "nonkernel_paths": nonkernel,
                      "streamed": streamed, "ivf": ivf, "clis": clis, "sharded": sharded,
                      "oracle_streamed": oracle_streamed, "ties": ties, "wide": wide,
                      "s1_shapes": [dict(shape=list(k), phase=p)
                                    for k, p in sorted(S1["shapes"].items())],
                      "wall_s": wall,
                      "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
