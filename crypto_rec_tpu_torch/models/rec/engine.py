"""Neighbour-weighted, mean-centred collaborative filtering.

Reference math (reference lib/crypto_rec.hpp:213-345):
* get_P_closest: cosine similarity of the query user to every candidate,
  sorted descending, truncated to P (crypto_rec.hpp:213-231);
* predicted score for unknown coin j:
      pred_j = user_mean + sum_i sim_i * (R[i, j] - mean_i) / sum_i |sim_i|
  (get_predicted_user_sim, crypto_rec.hpp:280-306);
* top-N = the N highest-predicted unknown coins (crypto_rec.hpp:309-345).

For a [q] batch of users: one similarity product, one masked top-k, one
gather and one weighted contraction.  A zero |sim| sum predicts the user
mean instead of the reference's NaN.  `recommend` runs in query blocks
that bound the [b, P, c] neighbour gather (the clustering phases ask for
P = every member).
"""

from __future__ import annotations

import dataclasses

import torch

from crypto_rec_tpu_torch.ops.distances import cosine_similarity_matrix
from crypto_rec_tpu_torch.ops.topk import masked_topk_desc, topn_indices

_EPS = 1e-30
# recommend's query block: the [b, P, c] f32 neighbour gather stays near
# 2^28 elements (1 GiB)
_GATHER_ELEMS = 1 << 28


@dataclasses.dataclass
class RatingSet:
    """A user x coin rating matrix on one device (ratings are imputed)."""

    ratings: torch.Tensor  # [n, c] float32
    known: torch.Tensor    # [n, c] bool
    mean: torch.Tensor     # [n] float32

    @classmethod
    def from_user_matrix(cls, um, device) -> "RatingSet":
        """A host UserMatrix (io/users.py) on `device`."""
        return cls(
            ratings=torch.as_tensor(um.ratings, dtype=torch.float32).to(device),
            known=torch.as_tensor(um.known).to(device),
            mean=torch.as_tensor(um.mean, dtype=torch.float32).to(device),
        )


@dataclasses.dataclass
class Recommendation:
    predicted: torch.Tensor       # [q, c] — known coins keep their rating
    top_n: torch.Tensor           # [q, N] coin indexes, -1 padded
    has_neighbors: torch.Tensor   # [q] bool — the reference skips users with
                                  # empty candidate sets (main.cpp:161,207)
    sims: torch.Tensor            # [q, P] descending neighbour similarities
    neighbor_idx: torch.Tensor    # [q, P] candidate row indexes
    neighbor_valid: torch.Tensor  # [q, P]


def predict_scores(
    queries: RatingSet,
    neighbors: RatingSet,
    sims: torch.Tensor,
    neighbor_idx: torch.Tensor,
    neighbor_valid: torch.Tensor,
) -> torch.Tensor:
    """get_predicted_user_sim over a batch: [q, P] selected neighbours ->
    [q, c] predictions (known cells keep their current rating)."""
    w = torch.where(neighbor_valid, sims, 0.0)                      # [q, P]
    abs_sum = torch.sum(torch.abs(w), dim=1)                        # [q]
    idx = neighbor_idx.long()
    neigh_r = neighbors.ratings[idx]                                # [q, P, c]
    neigh_mu = neighbors.mean[idx]                                  # [q, P]
    centered = (neigh_r - neigh_mu[:, :, None]) * neighbor_valid[:, :, None]
    main_sum = torch.einsum("qp,qpc->qc", w, centered)
    delta = main_sum / torch.clamp(abs_sum, min=_EPS)[:, None]
    pred_unknown = queries.mean[:, None] + torch.where(
        (abs_sum > 0.0)[:, None], delta, 0.0
    )
    return torch.where(queries.known, queries.ratings, pred_unknown)


def recommend(
    queries: RatingSet,
    neighbors: RatingSet,
    candidates: torch.Tensor,   # [q, n] bool mask of allowed neighbours
    top_p: int,
    top_n: int,
) -> Recommendation:
    """Similarity product -> masked top-P -> weighted mean-centred
    prediction -> top-N unknown coins, in query blocks of at most
    _GATHER_ELEMS / (P c) rows (each block's result is the same as the
    whole batch's)."""
    q = queries.ratings.shape[0]
    step = max(1, _GATHER_ELEMS // max(1, top_p * queries.ratings.shape[1]))
    if q <= step:
        return _recommend_block(queries, neighbors, candidates, top_p, top_n)
    parts = [
        _recommend_block(
            RatingSet(queries.ratings[s:s + step], queries.known[s:s + step],
                      queries.mean[s:s + step]),
            neighbors, candidates[s:s + step], top_p, top_n)
        for s in range(0, q, step)
    ]
    return Recommendation(*(torch.cat([getattr(p, f.name) for p in parts])
                            for f in dataclasses.fields(Recommendation)))


def _recommend_block(queries, neighbors, candidates, top_p, top_n) -> Recommendation:
    sims = cosine_similarity_matrix(queries.ratings, neighbors.ratings)
    vals, idx, valid = masked_topk_desc(sims, candidates, top_p)
    safe_idx = torch.clamp(idx, min=0) * valid   # idx rows of invalid slots -> 0
    predicted = predict_scores(queries, neighbors, vals, safe_idx, valid)
    return Recommendation(
        predicted=predicted,
        top_n=topn_indices(predicted, ~queries.known, top_n),
        has_neighbors=torch.any(valid, dim=1),
        sims=vals,
        neighbor_idx=torch.where(valid, idx, -1),
        neighbor_valid=valid,
    )


def recommend_topk_retrieved(
    queries: RatingSet,
    neighbors: RatingSet,
    sims: torch.Tensor,           # [q, P] descending neighbour similarities
    neighbor_idx: torch.Tensor,   # [q, P] row ids (-1 pad), e.g. from
                                  # models.lsh.index.retrieve_topk
    top_n: int,
) -> Recommendation:
    """CF scoring over pre-retrieved unique neighbours (the fused-retrieval
    form of get_P_closest + get_top_N_recom)."""
    valid = neighbor_idx >= 0
    idx = torch.clamp(neighbor_idx, min=0) * valid
    predicted = predict_scores(queries, neighbors, sims, idx, valid)
    return Recommendation(
        predicted=predicted,
        top_n=topn_indices(predicted, ~queries.known, top_n),
        has_neighbors=torch.any(valid, dim=1),
        sims=torch.where(valid, sims, float("-inf")),
        neighbor_idx=neighbor_idx,
        neighbor_valid=valid,
    )


def recommend_from_ids(
    queries: RatingSet,
    neighbors: RatingSet,
    candidate_ids: torch.Tensor,  # [q, B] row ids, -1 padded (CSR budget path)
    top_p: int,
    top_n: int,
) -> Recommendation:
    """The same engine over fixed-budget candidate id lists: similarities
    only against the B gathered rows per query (O(q B c) instead of
    O(q n c))."""
    valid_c = candidate_ids >= 0
    safe = torch.clamp(candidate_ids, min=0).long()
    cand_r = neighbors.ratings[safe]                                # [q, B, c]
    dots = torch.einsum("qc,qbc->qb", queries.ratings, cand_r)
    qn = torch.linalg.vector_norm(queries.ratings, dim=1, keepdim=True)
    cn = torch.linalg.vector_norm(cand_r, dim=2)
    sims = dots / torch.clamp(qn * cn, min=_EPS)
    vals, slot, valid = masked_topk_desc(sims, valid_c, top_p)
    idx = torch.gather(safe, 1, slot)
    predicted = predict_scores(queries, neighbors, vals, idx * valid, valid)
    return Recommendation(
        predicted=predicted,
        top_n=topn_indices(predicted, ~queries.known, top_n),
        has_neighbors=torch.any(valid, dim=1),
        sims=vals,
        neighbor_idx=torch.where(valid, idx, -1),
        neighbor_valid=valid,
    )
