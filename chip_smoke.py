#!/usr/bin/env python3
"""Smoke run of the PyTorch / Hopper port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's serving paths at `bench.py`'s operating points on one
2M x 128 planted corpus on the card, then the recommender program and its
10-fold CV, in fifteen phases; each phase raises on failure:

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
     against the planted truth must reach 0.99;
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
     write the same file; K2 against its plain version at the pipeline's
     index shape (d = 15);
 14. 10-fold CV at BENCH_CV.json's point (200,000 users x 128 coins,
     bench_cv.py's population, cosine k = 10, L = 6, budget 512, fused):
     K1 on f32 slabs (d = 128, win 640) against its plain version on every
     window of one fold and timed, K2 at the fold's build; then one
     counted ten_fold_mae: K1 and K2 must run, and the MAE must lie within
     0.03 of the JAX package's 1.4802 (the mean predictor's MAE beside it);
 15. candidate_ids_scored on phase 5's 2M x 128 int8 index at q = 8,192,
     budget 256, counted: K1 must run, set recall@10 against the planted
     truth >= 0.999.

Times are CUDA-event medians of alternating rounds: K2 against its
previous design (`signproj_bucket_ids_prev`), one torch.matmul(x, proj)
(the library yardstick, TF32 off) and the plain version; K1 against its
row-wise body (`slab_window_dots_rowwise`) and the plain version at every
geometry of phases 4, 5, 8, 9 and 10 (the plain version is not timed on
the two euclidean cubes, where a call takes seconds; phase 8 checks it
at their geometry).  Each time stands beside its bound
(`ops/kernels/bounds.py`: unique bytes over 3.35 TB/s against FLOPs over
the unit's peak) and the card's nvidia-smi line.

Each kernel wrapper counts its launches.  The counts are zeroed just before
each path's counted run (phase 5: build, pack, retrieve and CF-score 8,192
users; phases 9 and 10: build, pack and retrieve; phases 6-7 and 11 as
wholes; phase 12: the six probes; phase 13: the program's run; phase 14:
ten_fold_mae; phase 15: one candidate_ids_scored call) and read just
after it; each kernel of the path must show > 0.
The comparisons and timings run outside those windows.  The second-to-last
line is a JSON object with each kernel's route, source, main-path launches,
error against its plain version, times, bound and share of it, every
geometry and each path's launches; the last line is {"ok": true,
"device": ...}.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

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
    its previous design, one torch.matmul(x, proj) (the library yardstick,
    TF32 off) and the plain version in alternating rounds."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.signproj import (
        signproj_bucket_ids, signproj_bucket_ids_plain, signproj_bucket_ids_prev,
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
                   "prev_ms": lambda: signproj_bucket_ids_prev(corpus, proj, k, L),
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
        f"{ROUNDS} alternating rounds: kernel {e['ms']:.3f} ms, previous design "
        f"{e['prev_ms']:.3f}, torch.matmul {e['library_ms']:.3f}, plain "
        f"{e['plain_ms']:.3f}; bound {e['bound_ms']:.3f} ms ({e['bound_by']}, "
        f"{e['peak']}): {100 * e['share_of_bound']:.1f}% of it")


def k1_check(label, packed, s0, sizes, qk, per_table, shared_slab):
    """The tile-major K1 against its plain version on every given window,
    both mask modes: aligned starts equal, masked lanes equal, dots within
    rtol 1e-5 / atol 1e-4.  -> max |err| over the finite lanes."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_window_dots, slab_window_dots_plain,
    )

    err = 0.0
    for mask in (True, False):
        a = (packed, s0, sizes, qk, per_table)
        dk, ak = slab_window_dots(*a, mask=mask, shared_slab=shared_slab)
        dp, ap = slab_window_dots_plain(*a, mask=mask, shared_slab=shared_slab)
        torch.cuda.synchronize()
        if not torch.equal(ak, ap):
            raise AssertionError(f"K1 {label}: aligned starts differ")
        fin = torch.isfinite(dp)
        if not torch.equal(fin, torch.isfinite(dk)):
            raise AssertionError(f"K1 {label}: masked lanes differ")
        if not torch.allclose(dk[fin], dp[fin], rtol=1e-5, atol=1e-4):
            raise AssertionError(f"K1 {label}: dots differ beyond rtol 1e-5, atol 1e-4")
        err = max(err, float((dk[fin] - dp[fin]).abs().max()))
        del dk, dp, fin
    return err


def k1_time(label, packed, s0, sizes, qk, per_table, shared_slab, plain=True,
            rounds=ROUNDS):
    """The tile-major K1, its row-wise body and (plain=True) the plain
    version, mask off, in alternating rounds on the same windows, with the
    call's bound.  K1 has no one PyTorch call for a library yardstick (a
    gather and an einsum are two): library_ms is None."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_window_dots, slab_window_dots_plain, slab_window_dots_rowwise, window_len,
    )

    a = (packed, s0, sizes, qk, per_table)
    kw = dict(mask=False, shared_slab=shared_slab)
    t = rounds_ms({"ms": lambda: slab_window_dots(*a, **kw),
                   "prev_ms": lambda: slab_window_dots_rowwise(*a, **kw),
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
        f"tile-major {e['ms']:.3f} ms, row-wise {e['prev_ms']:.3f} ms, plain {plain}; "
        f"bound {e['bound_ms']:.3f} ms ({e['bound_by']}; f32 FFMA floor "
        f"{e['ffma_bound_ms']:.3f} ms): {100 * e['share_of_bound']:.1f}% of it")


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
    from crypto_rec_tpu_torch.ops.kernels.int4slab import slab_window_dots_int4
    from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids
    from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_window_dots
    from crypto_rec_tpu_torch.ops.kernels.slabvariants import slab_window_variant

    return (signproj_bucket_ids, slab_window_dots, binned_dots, slab_window_dots_int4,
            slab_window_variant, blk_window_dots)


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


def _timed_pair(kern, plain, p, row_bytes, rowwise=None):
    """Kernel and plain version (and K1's row-wise body) in alternating
    rounds, with the bound of the kernel's call on the probe's windows:
    covered slab rows x row_bytes, the queries and the kernel's outputs,
    2 d FLOP a window lane on bf16 tensor cores.  No one PyTorch call
    computes a probe kernel's function (a gather and an einsum are two):
    library_ms is None."""
    from crypto_rec_tpu_torch.ops.kernels import bounds
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _geometry, window_len

    t = rounds_ms({"ms": kern, "prev_ms": rowwise, "plain_ms": plain})
    if rowwise is None:
        del t["prev_ms"]
    outs = [o for o in kern() if isinstance(o, torch.Tensor)]
    row0 = _geometry(p.packed, p.s0, None, p.per_table, False)[2]
    b = bounds.window_call(row0, window_len(p.per_table),
                           p.packed.shape[0] * p.packed.shape[1], row_bytes,
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
            f"not compared); q={PQ}: kernel {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms")
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
        f"q={P6Q}: kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms")
    return res


def check_variants(p16, p8):
    """P2 / P4 variant modes against their plain versions: load_floor
    output and XOR fold exact (bf16 and int8), rounded_query (bf16) within
    DOT_TOL, i8_dot (int8) bit for bit; times at q = PQ; the recall of the
    i8_dot retrieval path against its plain path."""
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
                                 p.packed.shape[2] * p.packed.element_size()))
        if mode == "i8_dot":
            ids = [slab_topk(*f(*a), p.packed_rows, p.n_rows, TOP_K)[1]
                   for f in (slab_window_variant, slab_window_variant_plain)]
            res.update(_same_recall("P4 mxu_i8", *ids, p.true_idx))
        log(f"phase 12 slab_window_variant {mode} {dname}: max |err| {err:.3g} over "
            f"{CHECK_Q} queries{' (output and fold exact)' if len(got) == 3 else ''}; q={PQ}: "
            f"kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms")
        out.append(res)
    return out


def check_blk(p):
    """P5 blocked dots against the plain version (DOT_TOL), times at q = PQ."""
    from crypto_rec_tpu_torch.ops.kernels.blkslab import (
        blk_window_dots, blk_window_dots_plain, to_blk,
    )

    dname = str(p.packed.dtype)[6:]
    blk = to_blk(p.packed)
    c = (blk, p.s0[:CHECK_Q], p.qv[:CHECK_Q], p.per_table)
    (dk, ak), (dp, ap) = blk_window_dots(*c), blk_window_dots_plain(*c)
    torch.cuda.synchronize()
    if not torch.equal(ak, ap):
        raise AssertionError("blk: aligned starts differ")
    err = _close(f"blk {dname}", dk, dp)
    a = (blk, p.s0, p.qv, p.per_table)
    res = dict(geometry=f"{dname} {list(blk.shape)}, q = {PQ}", max_abs_err=err,
               **_timed_pair(lambda: blk_window_dots(*a), lambda: blk_window_dots_plain(*a),
                             p, p.packed.shape[2] * p.packed.element_size()))
    log(f"phase 12 blk_window_dots {dname}: max |err| {err:.3g} over {CHECK_Q} queries; "
        f"q={PQ}: kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms")
    return res


def check_k1_probes(p16, p8):
    """K1 without the mask as P1 (bf16) and P4's vpu (int8) run it: error
    against the plain version, times at q = PQ, and P4's vpu recall of
    both paths."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_topk, slab_window_dots, slab_window_dots_plain, slab_window_dots_rowwise,
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
                                 p.packed.shape[2] * p.packed.element_size(),
                                 rowwise=lambda: slab_window_dots_rowwise(*a, mask=False)))
        if p is p8:
            ids = [slab_topk(*f(*a, mask=False), p.packed_rows, p.n_rows, TOP_K)[1]
                   for f in (slab_window_dots, slab_window_dots_plain)]
            res.update(_same_recall("P4 vpu", *ids, p.true_idx))
        log(f"phase 12 K1 (P1 dots_nomask) {dname}: max |err| {err:.3g} over {CHECK_Q} "
            f"queries; q={PQ}: tile-major {res['ms']:.3f} ms, row-wise "
            f"{res['prev_ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, bound "
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
    missing = [k for k, v in launches.items() if k != "signproj_bucket_ids" and not v]
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


def phase13():
    """`python -m crypto_rec_tpu_torch.main -d tweets.tsv -o out.txt -c
    cluster.conf -validate` with the default engine and device, counted:
    K2 must run.  Checks the csr switch and its truncation log, the four
    headers and "Execution Time:" lines, the coin names, the summary; then
    K2 against its plain version at the pipeline's index shape."""
    import numpy as np
    from crypto_rec_tpu_torch import main as rec_main
    from crypto_rec_tpu_torch.io.ingest import CoinTable, score_tweets
    from crypto_rec_tpu_torch.io.readers import read_lexicon, read_str_vectors
    from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset
    from crypto_rec_tpu_torch.io.users import build_user_matrix
    from crypto_rec_tpu_torch.config import load_config
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.rec import pipeline

    with tempfile.TemporaryDirectory() as tmp:
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
        # K2 at the shape the pipeline hashes: the real users' ratings
        rows, _ = read_str_vectors(tweets, cfg.csv_delimiter, with_header_p=True)
        users = build_user_matrix(score_tweets(
            rows, read_lexicon(cfg.lexicon_file, cfg.csv_delimiter),
            CoinTable.from_rows(coin_rows)))
        x = torch.from_numpy(users.ratings).cuda()
        proj = CosineLsh.create(gen(SEED + 50), x.shape[1], cfg.k, cfg.L, x.device).proj
        k2 = check_k2(x, proj, cfg.k, cfg.L)
        k2["geometry"] += " (the pipeline's cosine index, d = 15: two zero columns pad it)"
        k2_line(13, k2)
    return dict(launches=launches, seconds=t_run, dataset_s=t_gen, peak_bytes=peak,
                summary=summary, warm_phase_ms=warm, csr_log=trunc, lines=len(recs), k2=k2)


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
    if not (launches["slab_window_dots"] and launches["signproj_bucket_ids"]):
        raise AssertionError(f"10-fold CV: a kernel did not run: {launches}")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
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
    from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        _window_offsets, slab_topk, slab_window_dots,
    )
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
    counters = (signproj_bucket_ids, slab_window_dots)

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

    # ---- 6. lsh_phase(engine="fused") ----
    # phases 6-7 are counted apart: they must reach the kernels too
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
    geoms, k2_l1 = phase8(corpus, queries_all)
    k1_geoms += geoms
    eidx, euclid = phase9(corpus, queries_all, true_all)
    paths = {"euclidean LSH": euclid}
    for i, leg in enumerate(CUBE_LEGS):
        paths[leg[0]] = cube_leg(corpus, queries_all, true_all, *leg, seed=SEED + 30 + i)
    k1_geoms += [r.pop("k1") for r in paths.values()]
    serving = phase11(eidx, corpus, q_host, true_host)
    del eidx
    torch.cuda.empty_cache()
    probe_checks, probes, probe_launches = phase12(corpus, queries_all, true_all, smi)
    torch.cuda.empty_cache()

    # ---- 13-15. the recommender program, 10-fold CV, scored candidate sets ----
    program = phase13()
    cv = phase14()
    scored = phase15(pidx, queries_all, true_all)
    del pidx

    def path_launches(name):
        return {p: r["launches"][name] for p, r in paths.items()}

    row_keys = ("ms", "prev_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "share_of_bound")
    kernels = [
        dict(name="signproj_bucket_ids", route="cuda",
             source="crypto_rec_tpu_torch/csrc/signproj.cu",
             replaces="crypto_rec_tpu/ops/pallas/signproj.py:61",
             launches=launches["signproj_bucket_ids"], max_abs_err=k2["max_abs_err"],
             **{key: k2[key] for key in row_keys}, card=CARD,
             geometries=[k2, k2_l1, program["k2"], cv["k2"]],
             path_launches=dict(path_launches("signproj_bucket_ids"),
                                program=program["launches"]["signproj_bucket_ids"],
                                cv=cv["launches"]["signproj_bucket_ids"])),
        dict(name="slab_window_dots", route="cuda",
             source="crypto_rec_tpu_torch/csrc/slabtile.cu",
             replaces="crypto_rec_tpu/ops/pallas/slabscore.py:360",
             launches=launches["slab_window_dots"], max_abs_err=k1_err,
             **{key: k1_main[key] for key in row_keys}, card=CARD,
             geometries=[k1_main] + k1_geoms,
             path_launches=dict(path_launches("slab_window_dots"),
                                scored_sets=scored["launches"]["slab_window_dots"])),
        dict(name="slab_window_dots", route="cuda",
             source="crypto_rec_tpu_torch/csrc/slabtile.cu",
             replaces="crypto_rec_tpu/ops/pallas/slabscore.py:360",
             launches=cv["launches"]["slab_window_dots"], max_abs_err=cv["k1"]["max_abs_err"],
             **{key: cv["k1"][key] for key in row_keys}, card=CARD, geometries=[cv["k1"]],
             note="f32 slabs, d = 128 (f32 FFMA): the 10-fold CV leg, phase 14"),
    ]

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
        probe_row("binned_dots", "binned.cu", "benchmarks/experiments/probe_r3_binned.py:98",
                  probe_checks["binned"]),
        probe_row("slab_window_variant", "slabvariants.cu",
                  "benchmarks/experiments/probe_r3_split.py:156", variants[:3],
                  note="modes load_floor (zeros) and rounded_query (mxu_rep, mxu_tile)"),
        probe_row("slab_window_variant", "slabvariants.cu",
                  "benchmarks/experiments/probe_r3_final.py:99", variants[3:],
                  note="mode i8_dot (mxu_i8)"),
        probe_row("blk_window_dots", "blkslab.cu", "benchmarks/experiments/probe_r4_blk.py:132",
                  probe_checks["blk"]),
        probe_row("slab_window_dots_int4", "int4slab.cu",
                  "benchmarks/experiments/probe_r5_int4.py:139", [probe_checks["int4"]]),
    ]
    for r in (cv, program):
        r.pop("k1", None)
        r.pop("k2")
    print(json.dumps({"kernels": kernels, "e2e": e2e, "paths": paths,
                      "serving_euclidean": serving, "probes": probes, "program": program,
                      "cv": cv, "scored_sets": scored, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
