"""The general clustering driver: every init x assignment x update
combination the reference ships (its initialization, assignment and update
phases are independently pluggable).

Reference combinations (reference main.cpp:93-103 runs k-means++ + Lloyd +
k-means; the shipped but unused paths are lsh_range_assignment /
cube_range_assignment, assignment.hpp:108-152, and pam_lloyds,
update.hpp:90-142).  The LSH or cube index is built ONCE over the input
points; each round queries the current centroids against it (reverse
assignment), as the reference structures it.
"""

from __future__ import annotations

from typing import Optional

import torch

from crypto_rec_tpu_torch.models.cluster.assign import index_range_assign, lloyd_assign
from crypto_rec_tpu_torch.models.cluster.init import kmeans_pp_init, random_init
from crypto_rec_tpu_torch.models.cluster.kmeans import KMeansResult
from crypto_rec_tpu_torch.models.cluster.update import kmeans_update, pam_update
from crypto_rec_tpu_torch.models.lsh.hypercube import (
    Hypercube, build_hypercube, cube_candidate_mask,
)
from crypto_rec_tpu_torch.models.lsh.index import LshIndex, build_index, candidate_mask


def cluster(
    generator: Optional[torch.Generator],
    x: torch.Tensor,
    k: int,
    metric: str,
    init: str = "kmeans++",          # "kmeans++" | "random"
    assignment: str = "lloyd",       # "lloyd" | "lsh" | "cube"
    update: str = "kmeans",          # "kmeans" | "pam"
    max_iterations: int = 30,
    min_dist: float = 0.05,
    lsh_k: int = 4,
    lsh_l: int = 5,
    lsh_bucket_div: int = 4,
    euclidean_h_w: float = 0.5,
    probes: int = 5,
    init_idx: Optional[torch.Tensor] = None,
    index: Optional[LshIndex] = None,
    hypercube: Optional[Hypercube] = None,
) -> KMeansResult:
    """Cluster x [n, d] into k clusters with any phase combination.

    The draws come from `generator` (a CPU generator: one seed, one result
    on every device): the initial rows first, then the hash parameters of
    the assignment's index.  `init_idx`, `index` (lsh) and `hypercube`
    (cube) hand them over instead (the tests pass the JAX package's).  A
    host loop: index-assisted assignment and PAM read one flag a round."""
    n = x.shape[0]
    if init_idx is None:
        if init == "kmeans++":
            init_idx = kmeans_pp_init(generator, x, k, metric)
        elif init == "random":
            init_idx = random_init(generator, n, k)
        else:
            raise ValueError(f"unknown init {init!r}")
    if assignment == "lsh" and index is None:
        index = build_index(generator, x, metric, lsh_k, lsh_l, lsh_bucket_div,
                            euclidean_h_w)
    elif assignment == "cube" and hypercube is None:
        hypercube = build_hypercube(generator, x, metric, lsh_k, euclidean_h_w)
    elif assignment not in ("lloyd", "lsh", "cube"):
        raise ValueError(f"unknown assignment {assignment!r}")
    if update not in ("kmeans", "pam"):
        raise ValueError(f"unknown update {update!r}")

    medoids = init_idx.to(x.device, torch.int32)
    centroids = x[medoids.long()]

    def assign(c):
        if assignment == "lloyd":
            return lloyd_assign(x, c, metric)
        if assignment == "lsh":
            # reverse assignment: the centroids query unfiltered buckets
            # (get_LSH_combined_buckets, assignment.hpp:117-120)
            return index_range_assign(x, c, candidate_mask(index, c, filtered=False),
                                      metric)
        return index_range_assign(x, c, cube_candidate_mask(hypercube, c, probes), metric)

    iterations = 0
    for _ in range(max_iterations):
        labels, _ = assign(centroids)
        iterations += 1
        if update == "kmeans":
            centroids, cont = kmeans_update(x, labels, centroids, k, metric, min_dist)
            if not bool(cont):
                break
        else:
            medoids, swapped = pam_update(x, labels, medoids, k, metric)
            centroids = x[medoids.long()]
            if not bool(swapped):
                break
    labels, dists = lloyd_assign(x, centroids, metric)
    return KMeansResult(centroids=centroids, labels=labels, dists=dists,
                        iterations=iterations)
