"""Centroid initialization: uniform random selection and k-means++.

Reference (reference lib/clustering_phases/initialization.hpp):
* rand_selection — k distinct uniform picks with resample-on-collision
  (:40-68); here one draw of k distinct rows;
* k_means_pp — D^2 sampling: per new centroid, every point's min distance
  to the chosen set, normalized by the max, squared, prefix-summed, then a
  uniform draw located by binary search (:72-156).  Normalizing before
  squaring keeps plain D^2's distribution (the max cancels).

The reference recomputes every point-to-centroid distance each round; a
running elementwise min makes each round one [n, d] x [d, 1] distance.

Each function that draws is a thin layer over a core that takes the draws
as tensors (`kmeans_pp_from_draws`), so the JAX package's draws can be
handed over and the picks compared exactly.  Draws come from a CPU
`torch.Generator`, so one seed picks the same rows on every device.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.distances import pairwise_distances


def random_init(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct row indexes (initialization.hpp:40-68), int64 on the CPU."""
    return torch.randperm(n, generator=generator)[:k]


def kmeans_pp_from_draws(
    x: torch.Tensor, k: int, metric: str, first: int, u: torch.Tensor
) -> torch.Tensor:
    """k-means++ picks from given draws: `first` the first row, u [k - 1]
    uniforms in [0, 1): pick i is the left searchsorted of u[i - 1] x the
    weight total in the prefix sums.  -> [k] int64 row indexes on x's
    device.  No host reads: every pick stays a device tensor."""
    n = x.shape[0]
    chosen = torch.zeros(k, dtype=torch.int64, device=x.device)
    chosen[0] = first
    min_d = torch.full((n,), float("inf"), device=x.device)
    u = u.to(device=x.device, dtype=torch.float32)
    for i in range(1, k):
        last = x.index_select(0, chosen[i - 1:i])
        min_d = torch.minimum(min_d, pairwise_distances(x, last, metric)[:, 0])
        # normalize by max, square, prefix-sum, draw, binary search
        # (initialization.hpp:118-152)
        w = torch.square(min_d / torch.clamp(torch.max(min_d), min=1e-30))
        cum = torch.cumsum(w, 0)
        r = u[i - 1:i] * cum[-1]
        pick = torch.searchsorted(cum, r, right=False)
        chosen[i:i + 1] = torch.clamp(pick, max=n - 1)
    return chosen


def kmeans_pp_init(
    generator: torch.Generator, x: torch.Tensor, k: int, metric: str
) -> torch.Tensor:
    """k-means++ D^2-sampled row indexes (initialization.hpp:72-156): the
    first row and k - 1 uniforms drawn from `generator`."""
    first = int(torch.randint(0, x.shape[0], (1,), generator=generator))
    u = torch.rand(max(k - 1, 0), generator=generator)
    return kmeans_pp_from_draws(x, k, metric, first, u)
