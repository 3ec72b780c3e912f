"""Synthetic data: the planted clustered corpus (the recall benchmark
protocol of `bench.py`) and a dataset in the reference's file formats.

`planted_clustered_corpus` follows the JAX package's protocol; its random
numbers come from a `torch.Generator` and so differ from JAX's, the
distribution is the same.  `write_synthetic_dataset` draws from numpy's
`default_rng(seed)` in the JAX package's order, so one seed writes the same
bytes through either package.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch


def planted_clustered_corpus(
    generator: torch.Generator,
    n: int,
    d: int,
    n_queries: int,
    top_k: int,
    n_centers: int = 0,
    cluster_noise: float = 0.3,
    planted_noise: float = 0.15,
    n_chunks: int = 32,
):
    """Clustered corpus with planted ground truth, on `generator.device`.

    Returns (corpus [n, d], queries [n_queries, d], true_idx [n_queries,
    top_k] int32).  Cluster centres are N(0, 1) x 2; queries are a random
    centre + cluster_noise N(0, 1).  Rows [0, n_queries * top_k) are each
    query's planted true neighbours (query + planted_noise N(0, 1)), the
    rest are cluster points (centre + cluster_noise N(0, 1)).  The corpus is
    written chunk by chunk into one preallocated tensor, so peak memory is
    the corpus plus one chunk's temporaries.

    The planted rows are the unambiguous top-k (distance margin ~2x), so
    recall measures retrieval rather than float-noise tie ordering.
    """
    dev = generator.device
    if n_centers <= 0:
        n_centers = max(1024, n // 128)
    g = generator
    centers = torch.randn(n_centers, d, generator=g, device=dev) * 2.0
    qc = torch.randint(0, n_centers, (n_queries,), generator=g, device=dev)
    queries = centers[qc] + cluster_noise * torch.randn(
        n_queries, d, generator=g, device=dev
    )
    n_planted = n_queries * top_k

    corpus = torch.empty(n, d, dtype=torch.float32, device=dev)
    chunk = -(-n // n_chunks)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        m = e - s
        cidx = torch.randint(0, n_centers, (m,), generator=g, device=dev)
        rows = centers[cidx]
        rows += cluster_noise * torch.randn(m, d, generator=g, device=dev)
        if s < n_planted:
            p = min(e, n_planted) - s          # rows [s, s + p) are planted
            qidx = torch.arange(s, s + p, device=dev) // top_k
            rows[:p] = queries[qidx] + planted_noise * torch.randn(
                p, d, generator=g, device=dev
            )
        corpus[s:e] = rows
    true_idx = (
        torch.arange(n_queries, dtype=torch.int32, device=dev)[:, None] * top_k
        + torch.arange(top_k, dtype=torch.int32, device=dev)[None, :]
    )
    return corpus, queries, true_idx


COIN_NAMES = [
    "bitcoin", "ethereum", "ripple", "litecoin", "cardano",
    "polkadot", "stellar", "dogecoin", "monero", "tezos",
    "eos", "tron", "cosmos", "iota", "dash",
]


def write_synthetic_dataset(
    out_dir: str,
    n_users: int = 60,
    n_tweets: int = 400,
    n_coins: int = 8,
    emb_dim: int = 16,
    p_header: int = 4,
    seed: int = 0,
) -> Tuple[str, str]:
    """Write the four files the reference pipeline reads (main.cpp:120-123)
    under out_dir: tokenized tweets with the "P <value>" header line, coin
    query variations (column 4 is the display name), a sentiment lexicon,
    and the "project 2" tweet embeddings; plus a cluster.conf.  Users have
    latent coin preferences and use positive words for the coins they like.
    n_coins is capped at len(COIN_NAMES).  -> (tweets path, conf path)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    n_coins = min(n_coins, len(COIN_NAMES))

    pos_words = [f"goodword{i}" for i in range(30)]
    neg_words = [f"badword{i}" for i in range(30)]
    lex_path = os.path.join(out_dir, "lexicon.tsv")
    with open(lex_path, "w") as f:
        for w in pos_words:
            f.write(f"{w}\t{rng.uniform(0.5, 3.0):.3f}\n")
        for w in neg_words:
            f.write(f"{w}\t{-rng.uniform(0.5, 3.0):.3f}\n")

    coins_path = os.path.join(out_dir, "coins.tsv")
    with open(coins_path, "w") as f:
        for i in range(n_coins):
            base = COIN_NAMES[i]
            row = [base, base.upper(), base[:3], f"#{base}", base.capitalize()]
            f.write("\t".join(row) + "\n")

    tweets_path = os.path.join(out_dir, "tweets.tsv")
    prefs = rng.random((n_users, n_coins))
    with open(tweets_path, "w") as f:
        f.write(f"P\t{p_header}\n")
        for t in range(n_tweets):
            u = int(rng.integers(0, n_users))
            coin = int(rng.integers(0, n_coins))
            liked = prefs[u, coin] > 0.4
            words = list(
                rng.choice(pos_words if liked else neg_words, size=rng.integers(1, 5))
            )
            words.append(COIN_NAMES[coin])
            if rng.random() < 0.3:
                words.append(COIN_NAMES[coin].upper())
            f.write("\t".join([f"user{u}", f"tw{t}"] + words) + "\n")

    emb_path = os.path.join(out_dir, "proj2.csv")
    with open(emb_path, "w") as f:
        for t in range(n_tweets):
            vec = rng.normal(size=emb_dim)
            f.write(",".join([f"tw{t}"] + [f"{v:.5f}" for v in vec]) + "\n")

    conf_path = os.path.join(out_dir, "cluster.conf")
    with open(conf_path, "w") as f:
        f.write("\n".join([
            f"proj_2_input {emb_path}",
            "proj_2_csv_delimiter ,",
            "proj_2_number_of_clusters 10",
            "number_of_clusters 6",
            "number_of_hash_functions 4",
            "number_of_hash_tables 5",
            "csv_delimiter 9 // ASCII tab",
            "lsh_bucket_div 4",
            "euclidean_h_w 0.4",
            "cube_probes 5",
            "cube_range_c 1",
            "max_algo_iterations 10",
            "min_dist_kmeans 0.05",
            "metric_type cosine",
            f"lexicon_file {lex_path}",
            f"query_file {coins_path}",
        ]) + "\n")
    return tweets_path, conf_path
