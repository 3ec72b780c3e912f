"""Full k-means: init -> (assign -> update) loop -> labels.

Mirrors the reference's clustering loop (reference main.cpp:96-103, 246-256):
initialize (random or k-means++), then alternate Lloyd assignment and the
k-means update until the update reports convergence (no centroid moved
more than min_dist) or max_iterations is hit.  The loop is a Python loop
with one host read per iteration (whether to go on).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from crypto_rec_tpu_torch.models.cluster.assign import lloyd_assign
from crypto_rec_tpu_torch.models.cluster.init import kmeans_pp_init, random_init
from crypto_rec_tpu_torch.models.cluster.update import kmeans_update


@dataclasses.dataclass
class KMeansResult:
    centroids: torch.Tensor   # [k, d]
    labels: torch.Tensor      # [n] int32
    dists: torch.Tensor       # [n] distance to own centroid
    iterations: int


def kmeans(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    k: int,
    metric: str,
    max_iterations: int = 30,
    min_dist: float = 0.05,
    init: str = "kmeans++",
    init_idx: Optional[torch.Tensor] = None,
) -> KMeansResult:
    """Cluster x [n, d] into k clusters.  The initial centroids are the
    rows `init_idx` when given (the tests hand over the JAX package's), else
    drawn from `generator` by `init` ("kmeans++" or "random")."""
    if init_idx is None:
        if init == "kmeans++":
            init_idx = kmeans_pp_init(generator, x, k, metric)
        elif init == "random":
            init_idx = random_init(generator, x.shape[0], k)
        else:
            raise ValueError(f"unknown init {init!r}")
    c = x[init_idx.to(x.device).long()]
    it, cont = 0, True
    while cont and it < max_iterations:
        labels, _ = lloyd_assign(x, c, metric)
        c, cont_t = kmeans_update(x, labels, c, k, metric, min_dist)
        cont = bool(cont_t)
        it += 1
    # the final assignment against the final centroids (the loop's last
    # labels were computed against the pre-update centroids)
    labels, dists = lloyd_assign(x, c, metric)
    return KMeansResult(centroids=c, labels=labels, dists=dists, iterations=it)
