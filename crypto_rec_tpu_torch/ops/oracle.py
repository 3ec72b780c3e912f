"""Brute-force exact nearest-neighbour oracle + recall.

The batched exact-NN sweep is the ground truth for recall@k measurements
(the reference ships the same oracles unused: min_vector_euclidean_dist /
min_vector_cosine_dist, reference lib/utils.hpp:107-140).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from crypto_rec_tpu_torch.ops.distances import pairwise_distances
from crypto_rec_tpu_torch.ops.topk import topk_asc


def exact_nearest(
    queries: torch.Tensor,
    index: torch.Tensor,
    metric: str,
    k: int,
    block_rows: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: [q, d] vs [n, d] -> (dists [q, k], idx [q, k]) ascending,
    equal distances (duplicate rows) lowest index first, as JAX's
    `lax.top_k` of the negated distances gives them on every device.

    Streams query blocks so the [q, n] distance matrix never materializes;
    the selection sorts each block's [block_rows, n] rows (`topk_asc`)."""
    dists, idx = [], []
    for s in range(0, queries.shape[0], block_rows):
        d = pairwise_distances(queries[s:s + block_rows], index, metric)
        dv, i = topk_asc(d, k)
        dists.append(dv)
        idx.append(i)
        del d
    return torch.cat(dists), torch.cat(idx)


def exact_nearest_streamed(
    queries: torch.Tensor,
    index_host: np.ndarray,
    metric: str,
    k: int,
    corpus_block: int = 1 << 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over a corpus kept in HOST memory: [q, d] queries (on
    the device that computes) against numpy [n, d] rows, one [corpus_block,
    d] f32 slice copied to the queries' device at a time.

    A running (distance, global id) top-k is merged with each slice's
    exact top-k; the best-so-far comes first in the merge, so equal
    distances keep the lower global id, as JAX's merge does.  -> (dists
    [q, k] ascending, idx [q, k] int64), equal to `exact_nearest` on the
    resident corpus."""
    q = queries.shape[0]
    dev = queries.device
    best_d = torch.full((q, k), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((q, k), -1, dtype=torch.int64, device=dev)
    for s in range(0, index_host.shape[0], corpus_block):
        blk = torch.from_numpy(np.ascontiguousarray(
            index_host[s:s + corpus_block], dtype=np.float32)).to(dev)
        # query blocks of 64 rows keep each sort at [64, corpus_block]
        blk_d, blk_i = exact_nearest(queries, blk, metric, min(k, blk.shape[0]),
                                     block_rows=64)
        best_d, pos = topk_asc(torch.cat([best_d, blk_d], dim=1), k)
        best_i = torch.gather(torch.cat([best_i, blk_i + s], dim=1), 1, pos)
        del blk, blk_d, blk_i
    return best_d, best_i


def recall_at_k(retrieved_idx: torch.Tensor, true_idx: torch.Tensor) -> float:
    """Mean fraction of true_idx [q, k] found in retrieved_idx [q, m].

    Negative entries in retrieved_idx are padding and never match.
    """
    r = retrieved_idx.long()
    matches = r[:, None, :] == true_idx.long()[:, :, None]
    hit = torch.any(matches & (r[:, None, :] >= 0), dim=-1)
    return float(hit.float().mean())
