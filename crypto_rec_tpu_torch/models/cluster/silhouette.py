"""Silhouette cluster evaluation.

Reference (reference lib/clustering_phases/silhouette.hpp):
* per centroid, find its nearest other centroid (:36-58);
* per point i: a(i) = mean distance to co-members (divided by count-1 when
  the cluster has more than one member, :89-112), b(i) = mean distance to
  the members of the neighbour cluster (:114-136), s = (b - a) / max(a, b);
* per-cluster mean silhouettes plus the global mean in the last slot
  (:64-80).

The reference's O(n^2) pair loops become blocked [block, n] distance
products; per-cluster sums are one [block, n] x [n, k] one-hot product per
block, so no distance is stored twice.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.distances import pairwise_distances


def silhouette(
    x: torch.Tensor,
    labels: torch.Tensor,
    centroids: torch.Tensor,
    k: int,
    metric: str,
    block_rows: int = 1024,
) -> torch.Tensor:
    """-> [k + 1] per-cluster mean silhouettes, global mean last."""
    lab = labels.long()
    onehot = torch.nn.functional.one_hot(lab, k).float()           # [n, k]
    dcc = pairwise_distances(centroids, centroids, metric)
    dcc = torch.where(torch.eye(k, dtype=torch.bool, device=x.device), float("inf"), dcc)
    nearest = torch.argmin(dcc, dim=1)                              # [k]
    counts = onehot.sum(0)                                          # [k]

    s = []
    for b in range(0, x.shape[0], block_rows):
        lb = lab[b:b + block_rows]
        sums = pairwise_distances(x[b:b + block_rows], x, metric) @ onehot   # [b, k]
        own = torch.gather(sums, 1, lb[:, None])[:, 0]
        a_i = own / torch.clamp(counts[lb] - 1.0, min=1.0)          # :109-111
        neigh = nearest[lb]
        b_i = torch.gather(sums, 1, neigh[:, None])[:, 0] / torch.clamp(counts[neigh], min=1.0)
        s.append((b_i - a_i) / torch.clamp(torch.maximum(a_i, b_i), min=1e-30))
    s = torch.cat(s)
    per_cluster = (onehot.T @ s) / torch.clamp(counts, min=1.0)
    return torch.cat([per_cluster, s.mean()[None]])
