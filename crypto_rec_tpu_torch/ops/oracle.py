"""Brute-force exact nearest-neighbour oracle + recall.

The batched exact-NN sweep is the ground truth for recall@k measurements
(the reference ships the same oracles unused: min_vector_euclidean_dist /
min_vector_cosine_dist, reference lib/utils.hpp:107-140).
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.distances import pairwise_distances


def exact_nearest(
    queries: torch.Tensor,
    index: torch.Tensor,
    metric: str,
    k: int,
    block_rows: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: [q, d] vs [n, d] -> (dists [q, k], idx [q, k]) ascending.

    Streams query blocks so the [q, n] distance matrix never materializes.
    """
    dists, idx = [], []
    for s in range(0, queries.shape[0], block_rows):
        d = pairwise_distances(queries[s:s + block_rows], index, metric)
        negd, i = torch.topk(-d, k, dim=1)
        dists.append(-negd)
        idx.append(i)
    return torch.cat(dists), torch.cat(idx)


def recall_at_k(retrieved_idx: torch.Tensor, true_idx: torch.Tensor) -> float:
    """Mean fraction of true_idx [q, k] found in retrieved_idx [q, m].

    Negative entries in retrieved_idx are padding and never match.
    """
    r = retrieved_idx.long()
    matches = r[:, None, :] == true_idx.long()[:, :, None]
    hit = torch.any(matches & (r[:, None, :] >= 0), dim=-1)
    return float(hit.float().mean())
