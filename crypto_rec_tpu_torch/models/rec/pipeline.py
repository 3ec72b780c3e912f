"""End-to-end recommendation pipeline — the reference's main.cpp.

Phases mirror reference main.cpp:36-390:
  0. cluster the "project 2" tweet embeddings (k-means++/Lloyd, cosine)
     (main.cpp:81-111);
  1. ingest tweets, score sentiment, build real + virtual ("fake") user
     matrices (main.cpp:120-137);
  A. cosine-LSH CF over real users, top-5 (main.cpp:149-185);
  V. optional 10-fold CV MAE (main.cpp:393-437);
  B. cosine-LSH CF with the virtual users as the index, top-2
     (main.cpp:195-230);
  A'. euclidean k-means clustering of real users, neighbours = cluster
     co-members, top-5 (main.cpp:240-325);
  B'. euclidean k-means++ clustering of virtual users, each real user joins
     the nearest centroid's cluster, top-2 (main.cpp:334-381).

Each phase's queries run as one batched call on the device.  Each phase
draws from its own generator, seeded from (cfg.seed, the phase's tag), so
turning -validate on or off changes no other phase's output.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Hashable, List, Optional

import numpy as np
import torch

from crypto_rec_tpu_torch.config import RecConfig
from crypto_rec_tpu_torch.io.ingest import CoinTable, score_tweets
from crypto_rec_tpu_torch.io.readers import (
    read_dense_vectors, read_lexicon, read_str_vectors, write_recommendations,
)
from crypto_rec_tpu_torch.io.users import build_cluster_user_matrix, build_user_matrix
from crypto_rec_tpu_torch.models.cluster.assign import lloyd_assign
from crypto_rec_tpu_torch.models.cluster.kmeans import kmeans
from crypto_rec_tpu_torch.models.cluster.silhouette import silhouette
from crypto_rec_tpu_torch.models.lsh.index import (
    build_index, candidate_ids, candidate_mask, pack_dtype, pack_index, retrieve_topk,
)
from crypto_rec_tpu_torch.models.rec.engine import (
    RatingSet, Recommendation, recommend, recommend_from_ids, recommend_topk_retrieved,
)
from crypto_rec_tpu_torch.models.rec.validate import ten_fold_mae
from crypto_rec_tpu_torch.utils.logging import get_logger
from crypto_rec_tpu_torch.utils.timing import PhaseTimer

log = get_logger(__name__)

# engine="auto" switches from the dense [q, n] candidate mask to the CSR
# engine when the mask would exceed this many elements (~1 GB of f32);
# module-level so tests can lower it
AUTO_MASK_MAX_ELEMS = 256e6


def phase_seed(seed: int, tag: int) -> int:
    """The seed of one phase's generator: a hash of (seed, tag), so phases
    draw independent streams."""
    return int(np.random.SeedSequence([seed % 2**64, tag]).generate_state(1, np.uint64)[0]
               >> 1)


def phase_generator(seed: int, tag: int) -> torch.Generator:
    return torch.Generator().manual_seed(phase_seed(seed, tag))


@dataclasses.dataclass
class PipelineResult:
    phase_ms: Dict[str, int]
    mae: Optional[float]
    n_users: int
    n_fake_users: int
    silhouettes: Optional[Dict[str, float]] = None  # phase -> global mean


def _write_phase(out, header: str, user_ids: List[str], rec: Recommendation,
                 coins: CoinTable, timer: PhaseTimer, phase: str) -> None:
    out.write(header + "\n")
    top = rec.top_n.cpu().numpy()
    has = rec.has_neighbors.cpu().numpy()
    for i, uid in enumerate(user_ids):
        if has[i]:   # the reference skips users with empty buckets (main.cpp:161)
            write_recommendations(out, uid, top[i], coins.queries, name_index=4)
    out.write(f"Execution Time: {timer.ms(phase)}\n")


def _csr_recommend(index, queries: RatingSet, index_set: RatingSet, cfg: RecConfig,
                   top_n: int, top_p: int) -> Recommendation:
    """The csr engine: count-ranked candidate ids + gathered scoring.  The
    truncation stats (one host read) are logged only when INFO would print
    them: the engine approximates the reference's whole-bucket union
    (lsh_cube.hpp:77-106), and how much the budget cut is reported."""
    log_stats = log.isEnabledFor(logging.INFO)
    res = candidate_ids(index, queries.ratings, budget=cfg.candidate_budget,
                        with_stats=log_stats)
    if not log_stats:
        return recommend_from_ids(queries, index_set, res, top_p=top_p, top_n=top_n)
    ids, stats = res
    dropped = stats["budget_dropped"].cpu()
    n_over = int((dropped > 0).sum())
    if n_over:
        log.warning(
            "csr engine truncated candidate unions for %d/%d queries (max dropped "
            "%d rows; budget=%d) — results may diverge from the reference's "
            "whole-bucket semantics", n_over, ids.shape[0], int(dropped.max()),
            cfg.candidate_budget)
    else:
        log.info("csr engine: no candidate truncation (budget=%d, max union %d rows)",
                 cfg.candidate_budget, int(stats["unique_candidates"].max()))
    return recommend_from_ids(queries, index_set, ids, top_p=top_p, top_n=top_n)


def lsh_phase(
    seed: int,
    queries: RatingSet,
    index_set: RatingSet,
    cfg: RecConfig,
    top_n: int,
    top_p: int,
    index_cache: Optional[dict] = None,
    index_token: Optional[Hashable] = None,
) -> Recommendation:
    """One cosine-LSH recommendation phase (build + batched query).

    cfg.engine: "mask" materializes the dense [q, n] candidate mask (exact
    get_LSH_combined_buckets semantics, lsh_cube.hpp:77-106); "csr" gathers
    fixed-budget, count-ranked candidate ids (cfg.candidate_budget) and
    scores only those — O(q * budget) memory; "fused" packs the rating rows
    into cfg.pack_dtype slabs and retrieves the top-P neighbours with
    `retrieve_topk` (K1) — window truncation (cfg.candidate_budget rows per
    table) is its recall tradeoff; "auto" picks csr once the mask would
    exceed AUTO_MASK_MAX_ELEMS, else mask.

    The hyperplanes come from a CPU `torch.Generator` seeded with `seed`,
    so one seed gives one index on every device.  index_cache (a dict)
    memoizes the built index — with its slabs, for the fused engine —
    under (seed, index_token); the caller names the index set with the
    token, so a cache is never keyed on an object's identity.
    """
    if index_cache is not None and index_token is None:
        raise ValueError("index_cache needs an index_token naming index_set")
    cache_key = (seed, index_token)
    index = index_cache.get(cache_key) if index_cache is not None else None
    if index is None:
        index = build_index(
            torch.Generator().manual_seed(seed), index_set.ratings, "cosine",
            cfg.k, cfg.L,
        )
        if index_cache is not None:
            index_cache[cache_key] = index
    engine = cfg.engine
    if engine == "auto":
        q_n = queries.ratings.shape[0] * index_set.ratings.shape[0]
        engine = "csr" if q_n > AUTO_MASK_MAX_ELEMS else "mask"
        if engine == "csr":
            log.info("engine=auto: dense mask would be %.0f MB, switching to the csr "
                     "engine (candidate_budget=%d); truncation is accounted below",
                     q_n * 4 / 2**20, cfg.candidate_budget)
    if engine == "csr":
        return _csr_recommend(index, queries, index_set, cfg, top_n, top_p)
    if engine == "fused":
        dtype = pack_dtype(cfg.pack_dtype)
        if index.packed is None or index.packed.dtype != dtype:
            index = pack_index(index, index_set.ratings, dtype=dtype)
            if index_cache is not None:
                index_cache[cache_key] = index       # cache WITH the slabs
        sims, nidx = retrieve_topk(
            index, queries.ratings, index_set.ratings, top_k=top_p,
            per_table=cfg.candidate_budget,
        )
        return recommend_topk_retrieved(queries, index_set, sims, nidx, top_n)
    if engine != "mask":
        raise ValueError(f"unknown engine {engine!r} (mask | csr | fused | auto)")
    mask = candidate_mask(index, queries.ratings, filtered=True)
    return recommend(queries, index_set, mask, top_p=top_p, top_n=top_n)


def cluster_phase(
    generator: torch.Generator,
    queries: RatingSet,
    member_set: RatingSet,
    cfg: RecConfig,
    top_n: int,
    init: str,
    self_cluster: bool,
    with_silhouette: bool = False,
):
    """One clustering recommendation phase -> (Recommendation, global
    silhouette or None).

    self_cluster=True: queries ARE the clustered set; neighbours = co-members
    (phase A', main.cpp:246-269).  False: the member_set is clustered and
    each query joins the nearest centroid's cluster (phase B',
    main.cpp:340-373).  Every co-member is a neighbour (top_p = members);
    `recommend` bounds its gather by query blocks."""
    # Clamp k to the member count (the reference's rand_selection would spin
    # forever when cluster_num exceeds the population, initialization.hpp:52-64).
    n_members = member_set.ratings.shape[0]
    k_clusters = max(1, min(cfg.cluster_num, n_members))
    km = kmeans(generator, member_set.ratings, k_clusters, "euclidean",
                cfg.max_algo_iterations, cfg.min_dist_kmeans, init=init)
    if self_cluster:
        q_labels = km.labels
    else:
        q_labels, _ = lloyd_assign(queries.ratings, km.centroids, "euclidean")
    mask = q_labels[:, None] == km.labels[None, :]
    rec = recommend(queries, member_set, mask, top_p=n_members, top_n=top_n)
    sil = None
    if with_silhouette:
        # the reference ships silhouette but leaves the calls commented out
        # (main.cpp:106,257) — here it's a flag
        sil = float(silhouette(member_set.ratings, km.labels, km.centroids, k_clusters,
                               "euclidean")[-1])
    return rec, sil


def run_pipeline(
    input_file: str,
    output_file: str,
    cfg: RecConfig,
    validate: bool = False,
    with_silhouette: bool = False,
    device=torch.device("cuda"),
) -> PipelineResult:
    """The reference program end to end on `device`: phases 0, ingest, A,
    (V), B, A', B' in the JAX package's order; writes the four-phase output
    file and returns the phase times, MAE and user counts."""
    device = torch.device(device)
    timer = PhaseTimer(device)

    # ---- Phase 0: embedding clustering (main.cpp:81-111) ----
    with timer.phase("phase0"):
        emb_ids, emb = read_dense_vectors(cfg.proj2_input, cfg.proj2_csv_delimiter)
        km0 = kmeans(phase_generator(cfg.seed, 0), torch.from_numpy(emb).to(device),
                     cfg.proj2_cluster_num, "cosine", cfg.max_algo_iterations,
                     cfg.min_dist_kmeans, init="kmeans++")
        emb_labels = km0.labels.cpu().numpy()

    # ---- Phase 1: ingest (main.cpp:120-137) ----
    with timer.phase("ingest"):
        rows, p_header = read_str_vectors(input_file, cfg.csv_delimiter, with_header_p=True)
        top_p = p_header if p_header else cfg.topP
        coin_rows, _ = read_str_vectors(cfg.query_file, cfg.csv_delimiter)
        coins = CoinTable.from_rows(coin_rows)
        batch = score_tweets(rows, read_lexicon(cfg.lexicon_file, cfg.csv_delimiter),
                             coins)
        users = build_user_matrix(batch)
        # map phase-0 embeddings (one per tweet id) to clusters
        tweet_pos = {tid: i for i, tid in enumerate(batch.tweet_ids)}
        tweet_cluster = np.zeros(batch.n_tweets, np.int32)
        tweet_mask = np.zeros(batch.n_tweets, bool)
        for eid, lab in zip(emb_ids, emb_labels):
            pos = tweet_pos.get(eid)
            if pos is not None:
                tweet_cluster[pos] = lab
                tweet_mask[pos] = True
        fake_users = build_cluster_user_matrix(batch, tweet_cluster,
                                               cfg.proj2_cluster_num, tweet_mask)
        real = RatingSet.from_user_matrix(users, device)
        fake = RatingSet.from_user_matrix(fake_users, device)
    log.info("ingest: %d tweets, %d users, %d virtual users, P=%d",
             batch.n_tweets, users.n_users, fake_users.n_users, top_p)

    mae = None
    sil_a = sil_b = None
    index_cache: dict = {}   # one build (+ pack) per distinct (seed, index set)
    with open(output_file, "w", encoding="utf-8") as out:
        # ---- Phase A: cosine LSH, real users (main.cpp:149-185) ----
        with timer.phase("lsh_A"):
            rec_a = lsh_phase(phase_seed(cfg.seed, 1), real, real, cfg, top_n=5,
                              top_p=top_p, index_cache=index_cache, index_token="real")
        _write_phase(out, "Cosine LSH", users.ids, rec_a, coins, timer, "lsh_A")
        del rec_a

        if validate:
            with timer.phase("validate"):
                mae = ten_fold_mae(phase_generator(cfg.seed, 5), real, "cosine", cfg.k,
                                   cfg.L, cfg.lsh_bucket_div, cfg.euclidean_h_w, top_p)
            log.info("10-fold CV MAE: %.4f", mae)

        # ---- Phase B: cosine LSH, virtual-user index (main.cpp:195-230) ----
        with timer.phase("lsh_B"):
            rec_b = lsh_phase(phase_seed(cfg.seed, 2), real, fake, cfg, top_n=2,
                              top_p=top_p, index_cache=index_cache, index_token="fake")
        _write_phase(out, "Cosine LSH", users.ids, rec_b, coins, timer, "lsh_B")
        del rec_b, index_cache

        # ---- Phase A': euclidean clustering, real users (main.cpp:240-325) ----
        with timer.phase("cluster_A"):
            rec_c, sil_a = cluster_phase(phase_generator(cfg.seed, 3), real, real, cfg,
                                         top_n=5, init="random", self_cluster=True,
                                         with_silhouette=with_silhouette)
        _write_phase(out, "Clustering Recommendation", users.ids, rec_c, coins, timer,
                     "cluster_A")
        del rec_c

        # ---- Phase B': euclidean clustering of virtual users (main.cpp:334-381) ----
        with timer.phase("cluster_B"):
            rec_d, sil_b = cluster_phase(phase_generator(cfg.seed, 4), real, fake, cfg,
                                         top_n=2, init="kmeans++", self_cluster=False,
                                         with_silhouette=with_silhouette)
        _write_phase(out, "Clustering Recommendation", users.ids, rec_d, coins, timer,
                     "cluster_B")

    sils = None
    if with_silhouette:
        sils = {"cluster_A": sil_a, "cluster_B": sil_b}
        log.info("silhouettes: %s", sils)
    return PipelineResult(
        phase_ms={k: timer.ms(k) for k in timer.phases},
        mae=mae,
        n_users=users.n_users,
        n_fake_users=fake_users.n_users,
        silhouettes=sils,
    )
