"""User x coin rating-matrix construction (host numpy).

Reference semantics (reference lib/crypto_rec.hpp:78-210):
* accumulate each tweet's sentiment into (user, coin) cells for every coin
  the tweet mentions — but only when the score is positive; the cell is
  marked "known" either way (crypto_rec.hpp:97-102);
* a user whose accumulated vector is all zeros is "useless" and dropped
  (crypto_rec.hpp:113-127) — this includes users with no coin mentions;
* unknown (never-mentioned) coins are imputed with the user's mean over
  known cells, and that mean is stored per user (crypto_rec.hpp:128-135);
* `clusters_to_user_vectors` repeats the aggregation grouped by the cluster
  each tweet's embedding fell into (one "virtual user" per cluster,
  crypto_rec.hpp:143-210).

One dense ``ratings [n, c]`` matrix plus a ``known [n, c]`` mask and a
``mean [n]`` vector replace the pointer-per-user objects.  The scatter-add
accumulates in float64, as the JAX package does, and the result is f32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from crypto_rec_tpu_torch.io.ingest import TweetBatch


@dataclasses.dataclass
class UserMatrix:
    """Dense imputed rating matrix + masks.

    ratings: [n, c] float32 — known cells hold accumulated positive
             sentiment, unknown cells the user's known-mean (imputed).
    known:   [n, c] bool    — True where the user mentioned the coin.
    mean:    [n]    float32 — mean over known cells.
    ids:     [n]    user id strings.
    """

    ratings: np.ndarray
    known: np.ndarray
    mean: np.ndarray
    ids: List[str]

    @property
    def n_users(self) -> int:
        return self.ratings.shape[0]

    @property
    def n_coins(self) -> int:
        return self.ratings.shape[1]

    def select(self, idx) -> "UserMatrix":
        """The users at `idx` (an index array), in that order."""
        idx = np.asarray(idx)
        return UserMatrix(ratings=self.ratings[idx], known=self.known[idx],
                          mean=self.mean[idx], ids=[self.ids[int(i)] for i in idx])


def _finalize(acc: np.ndarray, known: np.ndarray, ids: Sequence[str]) -> UserMatrix:
    """Shared tail of both matrix builds: drop useless rows, impute means."""
    keep = np.any(acc != 0.0, axis=1)            # crypto_rec.hpp:121-127
    acc = acc[keep]
    known_kept = known[keep]
    counts = np.maximum(known_kept.sum(axis=1), 1)
    means = (acc * known_kept).sum(axis=1) / counts
    return UserMatrix(
        ratings=np.where(known_kept, acc, means[:, None]).astype(np.float32),
        known=known_kept,
        mean=means.astype(np.float32),
        ids=[i for i, k in zip(ids, keep) if k],
    )


def build_user_matrix(batch: TweetBatch) -> UserMatrix:
    """tweets_to_user_vectors (crypto_rec.hpp:78-140), batched."""
    acc = np.zeros((batch.n_users, batch.n_coins), dtype=np.float64)
    known = np.zeros((batch.n_users, batch.n_coins), dtype=bool)
    if batch.pair_tweet.size:
        pair_user = batch.tweet_user[batch.pair_tweet]
        pair_score = batch.scores[batch.pair_tweet].astype(np.float64)
        positive = pair_score > 0.0
        np.add.at(acc, (pair_user[positive], batch.pair_coin[positive]),
                  pair_score[positive])
        known[pair_user, batch.pair_coin] = True
    return _finalize(acc, known, batch.user_ids)


def build_cluster_user_matrix(
    batch: TweetBatch,
    tweet_cluster: np.ndarray,
    n_clusters: int,
    tweet_mask: Optional[np.ndarray] = None,
) -> UserMatrix:
    """clusters_to_user_vectors (crypto_rec.hpp:143-210), batched.

    tweet_cluster: [T] int32 cluster id per tweet (from the phase-0
    embedding clustering); ``tweet_mask`` leaves out tweets whose embedding
    was absent from the phase-0 input (only tweets with an embedding are
    aggregated, crypto_rec.hpp:158-159).  Virtual user ids are the cluster
    numbers (crypto_rec.hpp:204).
    """
    acc = np.zeros((n_clusters, batch.n_coins), dtype=np.float64)
    known = np.zeros((n_clusters, batch.n_coins), dtype=bool)
    if batch.pair_tweet.size:
        pair_cluster = np.asarray(tweet_cluster)[batch.pair_tweet]
        pair_score = batch.scores[batch.pair_tweet].astype(np.float64)
        valid = (np.ones(pair_cluster.shape[0], dtype=bool) if tweet_mask is None
                 else np.asarray(tweet_mask)[batch.pair_tweet])
        positive = valid & (pair_score > 0.0)
        np.add.at(acc, (pair_cluster[positive], batch.pair_coin[positive]),
                  pair_score[positive])
        known[pair_cluster[valid], batch.pair_coin[valid]] = True
    return _finalize(acc, known, [str(i) for i in range(n_clusters)])
