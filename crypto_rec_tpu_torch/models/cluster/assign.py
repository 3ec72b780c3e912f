"""Cluster assignment: Lloyd argmin and LSH/hypercube reverse range search.

Reference (reference lib/clustering_phases/assignment.hpp):
* lloyds_assignment — per point, argmin distance over centroids (:54-80);
* lloyds_for_remaining — same, only for still-unassigned points (:83-105);
* lsh_range_assignment / cube_range_assignment — "reverse" assignment:
  each centroid queries the index for its candidate bucket union, a
  doubling-radius pass assigns/steals points, and Lloyd's mops up the
  leftovers (:108-152);
* range_assignment — radius starts at (min pairwise centroid distance) / 2
  and doubles until a round assigns nothing (:155-217).  As in the JAX
  package the radius doubles once per round, not once per centroid.

Lloyd is one [n, d] x [d, k] distance product + argmin (ties to the lowest
centroid).  Range assignment computes the distances once and runs one
masked window update per round in a Python loop, with one host read per
round (the round's assignment count) and the JAX package's `max_rounds`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.distances import pairwise_distances

UNASSIGNED = -1


def lloyd_assign(
    x: torch.Tensor, centroids: torch.Tensor, metric: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, d] x [k, d] -> (labels [n] int32, dist-to-centroid [n])."""
    dists, labels = torch.min(pairwise_distances(x, centroids, metric), dim=1)
    return labels.to(torch.int32), dists


def lloyd_for_remaining(
    x: torch.Tensor,
    centroids: torch.Tensor,
    labels: torch.Tensor,
    dists: torch.Tensor,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign only points with label == -1 (assignment.hpp:83-105)."""
    new_labels, new_dists = lloyd_assign(x, centroids, metric)
    todo = labels == UNASSIGNED
    return torch.where(todo, new_labels, labels), torch.where(todo, new_dists, dists)


def range_assign(
    x: torch.Tensor,
    centroids: torch.Tensor,
    cand_mask: torch.Tensor,   # [k, n] bool — centroid c's combined bucket
    metric: str,
    max_rounds: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Doubling-radius reverse assignment (assignment.hpp:155-217).

    Per round, a point inside some centroid's [min_radius, radius) window
    (and in its candidate bucket) is assigned to the nearest such centroid
    if unassigned, or stolen if strictly closer than its current distance.
    Rounds go on while one assigns something, at most max_rounds.  Returns
    (labels int32, dists) with -1 labels for never-reached points."""
    n, k = x.shape[0], centroids.shape[0]
    inf = float("inf")
    d_masked = torch.where(cand_mask, pairwise_distances(centroids, x, metric), inf)
    # initial radius: min pairwise centroid distance / 2
    # (find_min_vector_distance, utils.hpp:161-178)
    dcc = pairwise_distances(centroids, centroids, metric)
    dcc = torch.where(torch.eye(k, dtype=torch.bool, device=x.device), inf, dcc)
    r = torch.min(dcc) / 2.0
    min_r = torch.zeros((), device=x.device)
    labels = torch.full((n,), UNASSIGNED, dtype=torch.int32, device=x.device)
    dists = torch.full((n,), inf, device=x.device)
    for _ in range(max_rounds):
        in_window = (d_masked >= min_r) & (d_masked < r)            # [k, n]
        best_d, best_c = torch.min(torch.where(in_window, d_masked, inf), dim=0)
        take = torch.isfinite(best_d) & ((labels == UNASSIGNED) | (best_d < dists))
        labels = torch.where(take, best_c.to(torch.int32), labels)
        dists = torch.where(take, best_d, dists)
        min_r, r = r, r * 2.0
        if not bool(take.any()):
            break
    return labels, dists


def index_range_assign(
    x: torch.Tensor,
    centroids: torch.Tensor,
    cand_mask: torch.Tensor,
    metric: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """lsh_range_assignment / cube_range_assignment (assignment.hpp:108-152):
    range-assign from the index's candidate masks, Lloyd for leftovers.
    `cand_mask` comes from models.lsh.index.candidate_mask (centroids as
    queries, unfiltered: the reference uses get_LSH_combined_buckets)."""
    labels, dists = range_assign(x, centroids, cand_mask, metric)
    return lloyd_for_remaining(x, centroids, labels, dists, metric)
