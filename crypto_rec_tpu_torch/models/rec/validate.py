"""10-fold cross-validation MAE for the LSH recommender.

Reference flow (lsh_rec_10_fold_validation_A, reference main.cpp:393-437 +
crypto_rec.hpp:348-449):
* split users into 10 random folds of n // 10 (remainder users are dropped
  by split_to_10, crypto_rec.hpp:351-366 — kept for parity);
* per fold: build LSH tables on the other 9, and for each held-out user
  "hide one score": zero the imputed unknowns, hide one random known
  rating, re-impute it with the mean of the remaining coins, skip users
  with fewer than 2 known coins or an otherwise all-zero vector
  (hide_one_score, crypto_rec.hpp:393-449);
* MAE = mean over folds of mean |hidden - predicted| over scored users.

Each fold is one batched build + one batched query.  The random draws —
the fold permutation, each fold's hidden coins and hash parameters — come
from one CPU `torch.Generator` through `draw_folds`; `ten_fold_mae` takes
them as tensors (`FoldDraws`), so the JAX package's draws can be handed
over and the MAE compared exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.lsh.index import (
    build_index, candidate_mask, gather_candidate_ids, pack_index, query_hashes,
    retrieve_topk,
)
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh
from crypto_rec_tpu_torch.models.rec.engine import (
    RatingSet, recommend, recommend_from_ids, recommend_topk_retrieved,
)

_HIDE_MODES = ("fixed", "reference")
_ENGINES = ("mask", "csr", "fused")


def draw_hidden(generator: torch.Generator, known: torch.Tensor,
                hide_mode: str = "fixed") -> torch.Tensor:
    """The coin hidden for each user of known [q, c]: one uniform u per
    user from `generator` (on the CPU), r = floor(u * known count).
    "fixed": the r-th known coin (a uniform known coin); "reference": column
    min(r, c - 1), the reference's index conflation (crypto_rec.hpp:410-412).
    -> [q] int64 on known's device."""
    if hide_mode not in _HIDE_MODES:
        raise ValueError(f"unknown hide_mode {hide_mode!r}")
    u = torch.rand(known.shape[0], generator=generator).to(known.device)
    counts = known.sum(dim=1)
    r = torch.floor(u * counts).long()
    if hide_mode == "reference":
        return torch.clamp(r, max=known.shape[1] - 1)
    r = torch.clamp(r, max=torch.clamp(counts - 1, min=0))
    hide = (torch.cumsum(known.long(), dim=1) <= r[:, None]).sum(dim=1)
    return torch.where(counts > 0, hide, 0)


def hide_one_score(
    generator: Optional[torch.Generator],
    ratings: torch.Tensor,
    known: torch.Tensor,
    c: int,
    hide_mode: str = "fixed",
    hide_idx: Optional[torch.Tensor] = None,
) -> Tuple[RatingSet, torch.Tensor, torch.Tensor]:
    """Batched hide_one_score (crypto_rec.hpp:393-449).

    -> (hidden RatingSet, hidden coin index [q], scoreable mask [q]).
    Scoreable: >= 2 known coins AND the remaining vector is not all zero.
    The hidden coins are `hide_idx` when given, else drawn by `draw_hidden`:

      "fixed"     — a uniformly random KNOWN coin (the intended semantics);
      "reference" — the reference's bug: the draw ranges over
                    [0, known_count) but is used as a COLUMN index, so an
                    imputed column can be "hidden" (biasing MAE low); for
                    parity measurements only.
    """
    if hide_mode not in _HIDE_MODES:
        raise ValueError(f"unknown hide_mode {hide_mode!r}")
    if hide_idx is None:
        hide_idx = draw_hidden(generator, known, hide_mode)
    hide_idx = hide_idx.to(ratings.device).long()
    hide_oh = torch.nn.functional.one_hot(hide_idx, c).bool()
    # unknown cells -> 0; then the hidden cell gets the mean of the rest
    zeroed = torch.where(known, ratings, 0.0)
    rest_sum = zeroed.sum(dim=1) - torch.where(hide_oh, zeroed, 0.0).sum(dim=1)
    new_mean = rest_sum / max(c - 1, 1)
    new_ratings = torch.where(hide_oh, new_mean[:, None], zeroed)
    scoreable = (known.sum(dim=1) >= 2) & (rest_sum != 0.0)     # crypto_rec.hpp:421-433
    return RatingSet(ratings=new_ratings, known=~hide_oh, mean=new_mean), hide_idx, scoreable


@dataclasses.dataclass
class FoldDraws:
    """The random draws of one 10-fold CV run."""

    folds: torch.Tensor         # [10, n // 10] user rows of each fold (CPU)
    hide_idx: List[torch.Tensor]  # per fold: [n // 10] hidden coin per test user
    families: list              # per fold: the hash family (CosineLsh / PStableLsh)


def draw_folds(
    generator: torch.Generator,
    users: RatingSet,
    metric: str,
    k: int,
    L: int,
    euclidean_h_w: float,
    hide_mode: str = "fixed",
) -> FoldDraws:
    """The permutation, then per fold its hash family and hidden coins,
    all from `generator` (a CPU generator)."""
    n, c = users.ratings.shape
    fold_size = n // 10
    if fold_size == 0:
        raise ValueError("need at least 10 users for 10-fold CV")
    folds = torch.randperm(n, generator=generator)[:10 * fold_size].reshape(10, fold_size)
    dev = users.ratings.device
    families, hide = [], []
    for i in range(10):
        if metric == "cosine":
            families.append(CosineLsh.create(generator, c, k, L, dev))
        elif metric == "euclidean":
            families.append(PStableLsh.create(generator, c, k, L, euclidean_h_w, dev))
        else:
            raise ValueError(f"unknown metric {metric!r}")
        hide.append(draw_hidden(generator, users.known[folds[i].to(dev)], hide_mode))
    return FoldDraws(folds=folds, hide_idx=hide, families=families)


def _subset(users: RatingSet, rows: torch.Tensor) -> RatingSet:
    return RatingSet(users.ratings[rows], users.known[rows], users.mean[rows])


def _fold_mae(train, test, hide_idx, family, metric, k, L, lsh_bucket_div,
              euclidean_h_w, top_p, hide_mode, engine, candidate_budget):
    c = test.ratings.shape[1]
    hidden, hide_idx, scoreable = hide_one_score(
        None, test.ratings, test.known, c, hide_mode, hide_idx=hide_idx)
    index = build_index(None, train.ratings, metric, k, L, lsh_bucket_div,
                        euclidean_h_w, family=family)
    if engine == "csr":
        qb, qd = query_hashes(index, hidden.ratings)
        ids = gather_candidate_ids(index.sorted_rows, index.bucket_starts, index.detailed,
                                   index.n_rows, qb, qd, budget=candidate_budget)
        rec = recommend_from_ids(hidden, train, ids, top_p=top_p, top_n=1)
    elif engine == "fused":
        pidx = pack_index(index, train.ratings, dtype=torch.float32)
        sims, nidx = retrieve_topk(pidx, hidden.ratings, train.ratings, top_k=top_p,
                                   per_table=candidate_budget)
        rec = recommend_topk_retrieved(hidden, train, sims, nidx, 1)
    else:
        mask = candidate_mask(index, hidden.ratings, filtered=True)
        rec = recommend(hidden, train, mask, top_p=top_p, top_n=1)
    pred = torch.gather(rec.predicted, 1, hide_idx[:, None])[:, 0]
    old = torch.gather(test.ratings, 1, hide_idx[:, None])[:, 0]
    ok = scoreable & rec.has_neighbors
    return torch.sum(torch.abs(old - pred) * ok) / torch.clamp(ok.sum(), min=1)


def ten_fold_mae(
    generator: Optional[torch.Generator],
    users: RatingSet,
    metric: str,
    k: int,
    L: int,
    lsh_bucket_div: int,
    euclidean_h_w: float,
    top_p: int,
    hide_mode: str = "fixed",
    engine: str = "mask",
    candidate_budget: int = 256,
    draws: Optional[FoldDraws] = None,
) -> float:
    """Overall 10-fold CV MAE (main.cpp:393-437).

    engine picks the per-fold candidate path:
      "mask"  — dense candidate mask, exact whole-bucket-union semantics;
      "csr"   — fixed-budget count-ranked CSR candidate ids + gathered
                scoring, O(test * budget) memory;
      "fused" — f32 slabs + K1 retrieval straight to the top-P neighbours.
    The draws are `draws` when given, else `draw_folds(generator, ...)`.
    One host read per fold (its MAE)."""
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r} (mask | csr | fused)")
    if draws is None:
        draws = draw_folds(generator, users, metric, k, L, euclidean_h_w, hide_mode)
    dev = users.ratings.device
    folds = draws.folds.to(dev)
    fold_maes = []
    for i in range(10):
        train_rows = torch.cat([folds[j] for j in range(10) if j != i])
        fold_maes.append(float(_fold_mae(
            _subset(users, train_rows), _subset(users, folds[i]), draws.hide_idx[i],
            draws.families[i], metric, k, L, lsh_bucket_div, euclidean_h_w, top_p,
            hide_mode, engine, candidate_budget)))
    return float(np.mean(fold_maes))
