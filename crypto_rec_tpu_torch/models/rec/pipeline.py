"""The cosine-LSH recommendation phase of the pipeline (reference
main.cpp:149-230: phases A and B).

Only `lsh_phase` is ported so far; the rest of the JAX pipeline
(`run_pipeline`, clustering phases, 10-fold CV) waits for later slices of
the port (ROADMAP Queue 1 items 6, 8 and 9).
"""

from __future__ import annotations

from typing import Hashable, Optional

import torch

from crypto_rec_tpu_torch.config import RecConfig
from crypto_rec_tpu_torch.models.lsh.index import (
    build_index,
    candidate_mask,
    pack_dtype,
    pack_index,
    retrieve_topk,
)
from crypto_rec_tpu_torch.models.rec.engine import (
    RatingSet,
    Recommendation,
    recommend,
    recommend_topk_retrieved,
)

# engine="auto" switches from the dense [q, n] candidate mask to the CSR
# engine when the mask would exceed this many elements (~1 GB of f32)
AUTO_MASK_MAX_ELEMS = 256e6


def lsh_phase(
    seed: int,
    queries: RatingSet,
    index_set: RatingSet,
    cfg: RecConfig,
    top_n: int,
    top_p: int,
    index_cache: Optional[dict] = None,
    index_token: Optional[Hashable] = None,
) -> Recommendation:
    """One cosine-LSH recommendation phase (build + batched query).

    cfg.engine: "mask" materializes the dense [q, n] candidate mask (exact
    get_LSH_combined_buckets semantics, lsh_cube.hpp:77-106); "fused"
    packs the rating rows into cfg.pack_dtype slabs and retrieves the top-P
    neighbours with `retrieve_topk` (K1) — window truncation
    (cfg.candidate_budget rows per table) is its recall tradeoff.  "csr" is
    not ported yet; "auto" picks mask below AUTO_MASK_MAX_ELEMS, else csr.

    The hyperplanes come from a CPU `torch.Generator` seeded with `seed`,
    so one seed gives one index on every device.  index_cache (a dict)
    memoizes the built index — with its slabs, for the fused engine —
    under (seed, index_token); the caller names the index set with the
    token, so a cache is never keyed on an object's identity.
    """
    if index_cache is not None and index_token is None:
        raise ValueError("index_cache needs an index_token naming index_set")
    cache_key = (seed, index_token)
    index = index_cache.get(cache_key) if index_cache is not None else None
    if index is None:
        index = build_index(
            torch.Generator().manual_seed(seed), index_set.ratings, "cosine",
            cfg.k, cfg.L,
        )
        if index_cache is not None:
            index_cache[cache_key] = index
    engine = cfg.engine
    if engine == "auto":
        q_n = queries.ratings.shape[0] * index_set.ratings.shape[0]
        engine = "csr" if q_n > AUTO_MASK_MAX_ELEMS else "mask"
    if engine == "csr":
        raise NotImplementedError("ROADMAP Queue 1 item 7")
    if engine == "fused":
        dtype = pack_dtype(cfg.pack_dtype)
        if index.packed is None or index.packed.dtype != dtype:
            index = pack_index(index, index_set.ratings, dtype=dtype)
            if index_cache is not None:
                index_cache[cache_key] = index       # cache WITH the slabs
        sims, nidx = retrieve_topk(
            index, queries.ratings, index_set.ratings, top_k=top_p,
            per_table=cfg.candidate_budget,
        )
        return recommend_topk_retrieved(queries, index_set, sims, nidx, top_n)
    if engine != "mask":
        raise ValueError(f"unknown engine {engine!r} (mask | csr | fused | auto)")
    mask = candidate_mask(index, queries.ratings, filtered=True)
    return recommend(queries, index_set, mask, top_p=top_p, top_n=top_n)
