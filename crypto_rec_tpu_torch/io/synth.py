"""Planted clustered corpus: the recall benchmark protocol of `bench.py`.

Same protocol as the JAX package's `io/synth.planted_clustered_corpus`;
the random numbers come from a `torch.Generator` and so differ from JAX's,
the distribution is the same.
"""

from __future__ import annotations

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
