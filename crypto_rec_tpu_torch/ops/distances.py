"""Batched distance / similarity matrices.

The reference computes metrics one pair at a time
(CustVector::cosineSimilarity / euclideanDistance / cosineDistance,
reference lib/data_structures/cust_vector.hpp:105-174).  Here the same
math is one f32 matrix product per block:

    cos_sim(A, B) = (A @ B^T) / (|A| |B|)
    ||a - b||^2   = |a|^2 + |b|^2 - 2 a.b

All functions accept [q, d] x [n, d] and return [q, n] float32.  Zero
norms are clamped to a tiny epsilon (similarity 0) instead of the
reference's NaN.
"""

from __future__ import annotations

import torch

_NORM_EPS = 1e-30


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float().T)


def cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[q, d] x [n, d] -> [q, n] cosine similarity."""
    dots = _dot(a, b)
    na = torch.sqrt(torch.sum(torch.square(a.float()), dim=1))
    nb = torch.sqrt(torch.sum(torch.square(b.float()), dim=1))
    denom = torch.clamp(na[:, None] * nb[None, :], min=_NORM_EPS)
    return dots / denom


def cosine_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - cos_sim (cust_vector.hpp:139-155)."""
    return 1.0 - cosine_similarity_matrix(a, b)


def sq_euclidean_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 via the |a|^2 + |b|^2 - 2ab identity (never negative)."""
    dots = _dot(a, b)
    na = torch.sum(torch.square(a.float()), dim=1)
    nb = torch.sum(torch.square(b.float()), dim=1)
    return torch.clamp(na[:, None] + nb[None, :] - 2.0 * dots, min=0.0)


def euclidean_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(sq_euclidean_distance_matrix(a, b))


def pairwise_distances(a: torch.Tensor, b: torch.Tensor, metric: str) -> torch.Tensor:
    """Metric dispatch matching the reference's string dispatch
    (e.g. assignment.hpp:60-65)."""
    if metric == "euclidean":
        return euclidean_distance_matrix(a, b)
    if metric == "cosine":
        return cosine_distance_matrix(a, b)
    raise ValueError(f"unknown metric {metric!r}")


def blocked_pairwise_distances(
    a: torch.Tensor, b: torch.Tensor, metric: str, block_rows: int = 4096
) -> torch.Tensor:
    """pairwise_distances computed one [block_rows, n] product at a time,
    so the product's temporaries never exceed one block's; the [q, n]
    result is written block by block."""
    out = torch.empty(a.shape[0], b.shape[0], dtype=torch.float32, device=a.device)
    for s in range(0, a.shape[0], block_rows):
        out[s:s + block_rows] = pairwise_distances(a[s:s + block_rows], b, metric)
    return out
