"""Hypercube Hamming-distance probe schedules (host numpy).

The reference enumerates vertices at increasing Hamming distance from the
query vertex with a recursive bit-flip search at query time
(get_num_hamming_dist_from, reference lib/utils.cpp:22-50, driven by
get_hypercube_combined_buckets, lib/lsh_cube.hpp:139-177).  The schedule
depends only on (k, probes), not on the query, so the probe vertices are
`query_vertex XOR flip_masks` for one mask table computed here once.

A copy of the JAX package's `ops/hamming.py`: that module is plain numpy,
but importing it loads the JAX package's `__init__`, which imports jax.
"""

from __future__ import annotations

import functools
from itertools import combinations

import numpy as np


@functools.lru_cache(maxsize=None)
def hamming_probe_order(k: int, probes: int) -> np.ndarray:
    """[probes] int32 XOR masks, ordered like the reference probe walk.

    Mask 0 (the home vertex) first, then every mask of popcount 1, then 2,
    ...; within a distance class the flipped bit positions ascend from
    bit 0, which is combinations() order.  Truncated to `probes` vertices;
    past the cube's size the schedule is the whole cube
    (lsh_cube.hpp:168-172).  The array is read-only: the cache hands the
    same one to every caller."""
    masks = [0]
    for dist in range(1, k + 1):
        for bits in combinations(range(k), dist):
            masks.append(sum(1 << b for b in bits))
    out = np.asarray(masks[: max(1, min(probes, 1 << k))], dtype=np.int32)
    out.flags.writeable = False
    return out
