#!/usr/bin/env python3
"""Smoke run of the PyTorch / Hopper port on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It drives the port's fused LSH -> CF serving path at the CF bench point of
`bench.py` (2M x 128 planted corpus, cosine k = 13, L = 8, int8 global-scale
slabs, top-20 neighbours, top-5 coins) on the card, in seven phases; each
phase raises on failure:

  1. device: nvidia-smi's name and power limit, torch and CUDA versions;
  2. build: nvcc compiles csrc/*.cu for sm_90a (seconds printed);
  3. K2 (sign-projection hash) against its plain version, 2M x 128 rows;
  4. K1 (slab-window dots) against its plain version, both mask modes;
  5. the slice end to end at q = 8,192 and 32,768: index build (K2),
     int8 pack, retrieval (K1), CF scoring; recall@10 of the neighbours
     against the planted truth must reach 0.99;
  6. lsh_phase(engine="fused") on the same users;
  7. serving: serve_cli answers three requests from a saved index.

Each kernel wrapper counts its launches.  The counts are zeroed just before
one main-path run (build, pack, retrieve and CF-score 8,192 users) and read
just after it; each must be > 0, and they are the `launches` printed.  The
comparisons and timings run outside that window.  The second-to-last line
is a JSON object with each kernel's route, source, launches, error against
its plain version and times; the last line is {"ok": true, "device": ...}.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

N, D, K, L = 2_000_000, 128, 13, 8
PER_TABLE = 488            # bench.py's window: 2 * N / 2^k
TOP_P, TOP_N, TOP_K = 20, 5, 10
BATCHES = (8192, 32768)
SEED = 0


def log(msg: str) -> None:
    print(msg, flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from crypto_rec_tpu_torch import checkpoint, serve_cli
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
    from crypto_rec_tpu_torch.ops.kernels.signproj import (
        signproj_bucket_ids, signproj_bucket_ids_plain,
    )
    from crypto_rec_tpu_torch.ops.kernels.slabscore import (
        _window_offsets, slab_topk, slab_window_dots, slab_window_dots_plain,
    )
    from crypto_rec_tpu_torch.ops.oracle import exact_nearest, recall_at_k

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize

    def cuda_ms(fn, reps=5):
        """Median device time of fn() over reps runs (CUDA events), warm."""
        fn()
        sync()
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
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

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
    ids_k = signproj_bucket_ids(corpus, proj, K, L)
    ids_p = signproj_bucket_ids_plain(corpus, proj, K, L)
    bad = (ids_k != ids_p).any(dim=1)
    near0 = torch.zeros(N, dtype=torch.bool, device=dev)
    for s in range(0, N, 1 << 18):
        x = corpus[s:s + (1 << 18)]
        acc = (x @ proj).abs()
        lim = 1e-5 * x.norm(dim=1, keepdim=True) * proj.norm(dim=0)[None, :]
        near0[s:s + (1 << 18)] = (acc <= lim).any(dim=1)
    n_bad, n_unexplained = int(bad.sum()), int((bad & ~near0).sum())
    k2_err = float((ids_k - ids_p).abs().max())
    k2_ms = cuda_ms(lambda: signproj_bucket_ids(corpus, proj, K, L))
    k2_plain_ms = cuda_ms(lambda: signproj_bucket_ids_plain(corpus, proj, K, L))
    log(f"phase 3 K2 signproj [{N}, {D}] x [{D}, {L * K}]: {n_bad} rows differ "
        f"({int(near0.sum())} rows have a projection within 1e-5 |x||r| of 0); "
        f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.3f} ms")
    if n_unexplained:
        raise AssertionError(f"K2: {n_unexplained} rows differ away from 0")
    del ids_k, ids_p, bad, near0

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

    with tempfile.TemporaryDirectory() as tmp:
        idx_path = os.path.join(tmp, "idx.npz")
        checkpoint.save_index(idx_path, index)          # unpacked
        np.savez(os.path.join(tmp, "corpus.npz"), vectors=corpus.cpu().numpy())
        q_host = queries_all.cpu().numpy()
        true_host = true_all.cpu().numpy()
        for req in range(3):
            lo = req * 1024
            qpath = os.path.join(tmp, f"q{req}.csv")
            with open(qpath, "w") as f:
                for i in range(lo, lo + 1024):
                    f.write(",".join([f"u{i}"] + [f"{v:.7g}" for v in q_host[i]]) + "\n")
            out = os.path.join(tmp, f"out{req}.tsv")
            t0 = time.perf_counter()
            rc = serve_cli.main([
                "retrieve", "--index", idx_path,
                "--corpus", os.path.join(tmp, "corpus.npz"), "--queries", qpath,
                "--top-k", str(TOP_K), "--per-table", str(PER_TABLE), "--pack",
                "-o", out,
            ])
            t_req = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"serve_cli exited {rc}")
            with open(out) as f:
                lines = f.read().splitlines()
            if len(lines) != 1024:
                raise AssertionError(f"request {req}: {len(lines)} lines")
            hits = 0
            for i, line in zip(range(lo, lo + 1024), lines):
                toks = line.split("\t")
                if toks[0] != f"u{i}" or len(toks) != 1 + TOP_K:
                    raise AssertionError(f"request {req}: bad line {line[:80]!r}")
                rows = {int(t.split(":")[0]) for t in toks[1:]}
                hits += len(rows & set(true_host[i].tolist()))
            log(f"phase 7 request {req}: 1024 queries answered in {t_req:.2f} s "
                f"(restore + bf16 pack + retrieve), recall@{TOP_K} "
                f"{hits / (1024 * TOP_K):.4f}")
            if hits < 0.99 * 1024 * TOP_K:
                raise AssertionError(f"request {req}: served recall too low")
    launches67 = {fn.__name__: fn.launches for fn in counters}
    log(f"phase 7 launches in phases 6-7: {launches67}")
    if not all(launches67.values()):
        raise AssertionError(f"a kernel did not run in phases 6-7: {launches67}")

    kernels = [
        dict(name="signproj_bucket_ids", route="cuda",
             source="crypto_rec_tpu_torch/csrc/signproj.cu",
             replaces="crypto_rec_tpu/ops/pallas/signproj.py:61",
             launches=launches["signproj_bucket_ids"], max_abs_err=k2_err,
             ms=k2_ms, plain_ms=k2_plain_ms),
        dict(name="slab_window_dots", route="cuda",
             source="crypto_rec_tpu_torch/csrc/slabscore.cu",
             replaces="crypto_rec_tpu/ops/pallas/slabscore.py:360",
             launches=launches["slab_window_dots"], max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain_ms),
    ]
    print(json.dumps({"kernels": kernels, "e2e": e2e, "card": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
