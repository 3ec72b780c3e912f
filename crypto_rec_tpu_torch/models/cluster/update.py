"""Centroid update: k-means mean update and PAM medoid swap.

Reference (reference lib/clustering_phases/update.hpp):
* k_means — new center = mean of its members (:42-58); clustering goes on
  iff at least one center moved more than `min_dist`, in which case ALL
  centers move to the new means; otherwise the old centers are kept
  (:63-85);
* pam_lloyds — per cluster, medoid = member minimizing the summed
  intra-cluster distance; swap if it differs from the current centroid
  (:90-142).

Deviation kept from the JAX package: an empty cluster keeps its previous
centroid (the reference leaves the zero vector, cust_vector.hpp:187-194).

The member sums are one_hot(labels)^T @ x as a float64 matrix product:
`index_add_` / `scatter_add_` use atomics on CUDA, whose order changes the
sums' last bits from run to run, and near `min_dist` that can flip whether
clustering goes on.  A GEMM has a fixed reduction order, and float64 takes
TF32 out of the question; the means are cast back to f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.distances import pairwise_distances


def _onehot(labels: torch.Tensor, k: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels.long(), k).to(dtype)   # [n, k]


def kmeans_update(
    x: torch.Tensor,
    labels: torch.Tensor,
    old_centroids: torch.Tensor,
    k: int,
    metric: str,
    min_dist: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (centroids [k, d], continue_clustering 0-d bool tensor) per
    update.hpp:37-86."""
    onehot = _onehot(labels, k, torch.float64)
    sums = onehot.T @ x.double()                                   # [k, d]
    counts = onehot.sum(0)
    means = (sums / torch.clamp(counts, min=1.0)[:, None]).to(x.dtype)
    new_c = torch.where((counts > 0)[:, None], means, old_centroids)
    # each centroid's move.  Euclidean: |new - old| directly — the expanded
    # |a|^2 + |b|^2 - 2 a.b of pairwise_distances loses ~sqrt(eps) |c| to
    # cancellation, more than a typical min_dist, and would never report
    # an unmoved centroid as unmoved
    if metric == "euclidean":
        moved = torch.linalg.vector_norm(new_c - old_centroids, dim=1)
    else:
        moved = torch.diagonal(pairwise_distances(new_c, old_centroids, metric))
    cont = torch.any(moved > min_dist)
    return torch.where(cont, new_c, old_centroids), cont


def pam_update(
    x: torch.Tensor,
    labels: torch.Tensor,
    medoid_idx: torch.Tensor,   # [k] current medoid row indexes
    k: int,
    metric: str,
    block_rows: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PAM-Lloyd medoid update (update.hpp:90-142).

    -> (new medoid row indexes [k] int32, any_swapped 0-d bool tensor).
    cost[i] = sum of distances from i to its co-members, computed in row
    blocks as D[block, n] @ onehot(labels), then each row's own-cluster
    column.  Ties go to the lowest row, like the reference's "<" scan
    (update.hpp:121-125)."""
    onehot = _onehot(labels, k, torch.float32)                     # [n, k]
    own_cost = torch.cat([
        torch.gather(pairwise_distances(x[s:s + block_rows], x, metric) @ onehot,
                     1, labels[s:s + block_rows, None].long())[:, 0]
        for s in range(0, x.shape[0], block_rows)
    ])
    member = onehot.T.bool()                                        # [k, n]
    per_cluster = torch.where(member, own_cost[None, :], float("inf"))
    new_medoids = torch.argmin(per_cluster, dim=1).to(torch.int32)
    new_medoids = torch.where(member.any(dim=1), new_medoids, medoid_idx.to(torch.int32))
    return new_medoids, torch.any(new_medoids != medoid_idx)
