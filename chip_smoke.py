#!/usr/bin/env python3
"""Smoke run of the PyTorch / Hopper port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's serving paths at `bench.py`'s operating points on one
2M x 128 planted corpus on the card, in eleven phases; each phase raises
on failure:

  1. device: nvidia-smi's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles csrc/*.cu for sm_90a (seconds printed);
  3. K2 (sign-projection hash) against its plain version, 2M x 128 rows;
  4. K1 (slab-window dots) against its plain version, both mask modes;
  5. the fused LSH -> CF slice end to end at q = 8,192 and 32,768 (cosine
     k = 13, L = 8, int8 slabs, top-20 neighbours, top-5 coins): index
     build (K2), pack, retrieval (K1), CF scoring; neighbour recall@10
     against the planted truth must reach 0.99;
  6. lsh_phase(engine="fused") on the same users;
  7. serving: serve_cli answers three requests from a saved index;
  8. K1 against its plain version at the new geometries (augmented int8
     [4, n_pad, 256]; shared-slab cosine MultiCube [1, 2 n_pad, 128];
     shared-slab augmented MultiCube [1, 3 n_pad, 256]) and K2 at L = 1;
  9. euclidean p-stable LSH (k = 5, L = 4, w = 20, window 768, int8
     augmented slabs) at q = 32,768, recall@10 floor 0.98;
 10. the cube family at q = 32,768, k = 13, int8: cosine MultiCube (C = 2,
     12 probes), single cosine cube (16 probes), euclidean cube (64
     probes), euclidean MultiCube (C = 3, 24 probes), each with its
     recall@10 floor (CUBE_LEGS);
 11. serving: `serve_cli retrieve --pack --augment` answers three requests
     from a saved euclidean index.

Each kernel wrapper counts its launches.  The counts are zeroed just before
each path's counted run (phase 5: build, pack, retrieve and CF-score 8,192
users; phases 9 and 10: build, pack and retrieve; phases 6-7 and 11 as
wholes) and read just after it; each kernel of the path must show > 0.
The comparisons and timings run outside those windows.  The second-to-last
line is a JSON object with each kernel's route, source, main-path launches,
error against its plain version, times, the new geometries and each path's
launches; the last line is {"ok": true, "device": ...}.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import json
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
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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


def check_k2(corpus, proj, k, L):
    """K2 against its plain version on every corpus row.  A row may differ
    only where a projection lies within 1e-5 |x||r| of 0 (f32 summation
    order decides its sign); any other difference raises."""
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
    return dict(rows_differ=int(bad.sum()), rows_near_zero=int(near0.sum()),
                max_abs_err=float((ids_k - ids_p).abs().max()),
                ms=cuda_ms(lambda: signproj_bucket_ids(corpus, proj, k, L)),
                plain_ms=cuda_ms(lambda: signproj_bucket_ids_plain(corpus, proj, k, L)))


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
    from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids
    from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_window_dots

    return signproj_bucket_ids, slab_window_dots


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


def compare_k1(label, packed, s0, sizes, qk, per_table, shared_slab, n_err, n_time):
    """K1 against its plain version on the first n_err rows of windows,
    both mask modes (aligned starts equal, dots within rtol 1e-5, atol
    1e-4), then CUDA-event times of both on the first n_time rows."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        slab_window_dots, slab_window_dots_plain,
    )

    err = 0.0
    for mask in (True, False):
        a = (packed, s0[:n_err], sizes[:n_err], qk[:n_err], per_table)
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
    a = (packed, s0[:n_time], sizes[:n_time], qk[:n_time], per_table)
    ms = cuda_ms(lambda: slab_window_dots(*a, mask=False, shared_slab=shared_slab))
    plain_ms = cuda_ms(lambda: slab_window_dots_plain(*a, mask=False,
                                                      shared_slab=shared_slab), reps=3)
    win = (per_table + 32 + 127) // 128 * 128
    log(f"phase 8 K1 {label}: slab {list(packed.shape)} {str(packed.dtype)[6:]}, "
        f"win {win}: max |err| {err:.3g} over {n_err} rows x {s0.shape[1]} windows "
        f"(mask on/off); {n_time} rows: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return dict(geometry=label, slab=list(packed.shape), dtype=str(packed.dtype)[6:],
                per_table=per_table, win=win, windows_per_row=int(s0.shape[1]),
                rows_timed=n_time, max_abs_err=err, ms=ms, plain_ms=plain_ms)


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
    geoms.append(compare_k1("1 euclidean LSH, augmented int8", eidx.packed, s0, sizes,
                            q_aug, E_PT, False, 256, qn))
    del eidx, s0, sizes, q_aug
    torch.cuda.empty_cache()

    qs = queries[:GEOM_Q]
    mc = build_multicube(gen(SEED + 7), corpus, "cosine", 2, CK, 1.0,
                         corpus_dtype=torch.int8)
    proj = mc.cubes[0].family.proj
    k2 = check_k2(corpus, proj, CK, 1)
    log(f"phase 8 K2 signproj L = 1 [{N}, {D}] x [{D}, {CK}]: {k2['rows_differ']} rows "
        f"differ ({k2['rows_near_zero']} rows have a projection within 1e-5 |x||r| "
        f"of 0); kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms")
    rows = grouped(*multicube_windows(mc, qs, 12, 488), unit(qs))
    geoms.append(compare_k1("2 cosine MultiCube, shared slab int8", mc.packed, *rows,
                            488, True, 256 * 3, GEOM_Q * 3))
    del mc, rows
    torch.cuda.empty_cache()

    mc = build_multicube(gen(SEED + 8), corpus, "euclidean", 3, CK, 8.0,
                         corpus_dtype=torch.int8)
    q_aug = augment_queries(qs, mc.packed_aug_scale, mc.packed.shape[2])
    rows = grouped(*multicube_windows(mc, qs, 24, 976), q_aug)
    geoms.append(compare_k1("3 euclidean MultiCube, shared augmented int8", mc.packed,
                            *rows, 976, True, 256 * 9, GEOM_Q * 9))
    del mc, rows
    torch.cuda.empty_cache()
    return geoms, dict(geometry="L = 1, k = 13 (cosine cube vertices)", **k2)


def phase9(corpus, queries, true_idx):
    """Euclidean p-stable LSH, counted: build, int8 augmented pack and
    top-10 retrieval (2x over-fetch, exact rerank) at q = 32,768."""
    from crypto_rec_tpu_torch.models.lsh.index import (
        build_index, pack_index, query_hashes, retrieve_topk,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        augment_queries, euclid_window_offsets, slab_window_dots,
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
    t_k1 = cuda_ms(lambda: slab_window_dots(pidx.packed, s0, sizes, q_aug, E_PT, mask=False))
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
                      windows_ms=t_win, k1_ms=t_k1, recall=recall, floor=E_FLOOR)


def cube_leg(corpus, queries, true_idx, name, metric, cubes, probes, per_probe, w,
             floor, seed):
    """One cube leg of phase 10, counted: build (+ pack), retrieve."""
    from crypto_rec_tpu_torch.models.lsh.hypercube import (
        build_hypercube, build_multicube, cube_retrieve_topk, cube_windows,
        multicube_retrieve_topk, multicube_windows, pack_cube,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        augment_queries, slab_window_dots,
    )
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
    t_k1 = cuda_ms(lambda: slab_window_dots(obj.packed, *rows, per_probe, mask=False,
                                            shared_slab=True), reps=3)
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
                recall=recall, floor=floor)


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
        _window_offsets, slab_topk, slab_window_dots, slab_window_dots_plain,
    )
    from crypto_rec_tpu_torch.ops.oracle import exact_nearest, recall_at_k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
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
    k2_err, k2_ms, k2_plain_ms = k2["max_abs_err"], k2["ms"], k2["plain_ms"]
    log(f"phase 3 K2 signproj [{N}, {D}] x [{D}, {L * K}]: {k2['rows_differ']} rows "
        f"differ ({k2['rows_near_zero']} rows have a projection within 1e-5 |x||r| "
        f"of 0); kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms")

    # ---- 4. K1 against its plain version (the slice's int8 index) ----
    index = pack_index(build_index(None, corpus, "cosine", K, L,
                                   family=CosineLsh(proj, K, L)),
                       corpus, dtype=torch.int8)
    qv = torch.nn.functional.normalize(queries_all[:BATCHES[0]], dim=1)
    qb, _ = query_hashes(index, qv)
    s0, sizes = _window_offsets(index.bucket_starts, qb, PER_TABLE)
    k1_err = 0.0
    for mask in (True, False):
        a = (index.packed, s0[:256], sizes[:256], qv[:256], PER_TABLE)
        dk, ak = slab_window_dots(*a, mask=mask)
        dp, ap = slab_window_dots_plain(*a, mask=mask)
        sync()
        if not torch.equal(ak, ap):
            raise AssertionError("K1: aligned starts differ")
        if not torch.allclose(dk, dp, rtol=1e-5, atol=1e-4):
            raise AssertionError("K1: dots differ beyond rtol 1e-5, atol 1e-4")
        fin = torch.isfinite(dp)
        if not torch.equal(fin, torch.isfinite(dk)):
            raise AssertionError("K1: masked lanes differ")
        k1_err = max(k1_err, float((dk[fin] - dp[fin]).abs().max()))
    a = (index.packed, s0, sizes, qv, PER_TABLE)
    k1_ms = cuda_ms(lambda: slab_window_dots(*a, mask=False))
    k1_plain_ms = cuda_ms(lambda: slab_window_dots_plain(*a, mask=False))
    log(f"phase 4 K1 slab_window_dots int8 [8 x {index.packed.shape[1]} x {D}], "
        f"256 queries, mask on/off: max |err| {k1_err:.3g}; q={BATCHES[0]}: "
        f"kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms")
    del index, a

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
        t_k1 = cuda_ms(lambda: slab_window_dots(pidx.packed, s0, sizes, qv,
                                                PER_TABLE, mask=False))
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
    del index, pidx, nset, n_known, qset, qset0, sims, nidx
    torch.cuda.empty_cache()
    geoms, k2_l1 = phase8(corpus, queries_all)
    eidx, euclid = phase9(corpus, queries_all, true_all)
    paths = {"euclidean LSH": euclid}
    for i, leg in enumerate(CUBE_LEGS):
        paths[leg[0]] = cube_leg(corpus, queries_all, true_all, *leg, seed=SEED + 30 + i)
    serving = phase11(eidx, corpus, q_host, true_host)

    def path_launches(name):
        return {p: r["launches"][name] for p, r in paths.items()}

    kernels = [
        dict(name="signproj_bucket_ids", route="cuda",
             source="crypto_rec_tpu_torch/csrc/signproj.cu",
             replaces="crypto_rec_tpu/ops/pallas/signproj.py:61",
             launches=launches["signproj_bucket_ids"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms, geometries=[k2_l1],
             path_launches=path_launches("signproj_bucket_ids")),
        dict(name="slab_window_dots", route="cuda",
             source="crypto_rec_tpu_torch/csrc/slabscore.cu",
             replaces="crypto_rec_tpu/ops/pallas/slabscore.py:360",
             launches=launches["slab_window_dots"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms, geometries=geoms,
             path_launches=path_launches("slab_window_dots")),
    ]
    print(json.dumps({"kernels": kernels, "e2e": e2e, "paths": paths,
                      "serving_euclidean": serving, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
