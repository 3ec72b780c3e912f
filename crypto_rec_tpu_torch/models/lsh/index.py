"""LSH index: CSR bucket tables, packed slabs, fused retrieval.

The reference stores each table as pointer buckets and unions a query's
buckets across L tables through a std::set (reference
lib/data_structures/cust_hashtable.hpp, lsh_cube.hpp:77-106).  Here, as in
the JAX package, each table is a CSR layout: rows sorted by bucket id plus
an offset table.  Three query paths:

1. **Dense mask** (`candidate_mask`): exact reference semantics, [q, n].
2. **CSR fixed budget** (`candidate_ids`, `gather_candidate_ids`): a
   window of each query bucket per table, deduplicated and ranked by
   collision count, truncated to a budget — O(q * budget) memory; and its
   score-ranked form off K1 (`candidate_ids_scored`).
3. **Fused packed retrieval** (`retrieve_topk`, `retrieve_topk_pallas`):
   per-table CSR-ordered corpus copies (`pack_index`), one window per
   table scored by kernel K1, dedup top-k epilogue.  Cosine slabs hold
   normalized rows; euclidean slabs the AUGMENTED rows [x, -|x|^2/2, 0-pad],
   whose plain dot with [q, s, 0-pad] is the monotone rank x.q - |x|^2/2.

Kernels run where the tensors live: CUDA tensors launch the Hopper kernels
(K2 for the cosine hash, K1 for the window dots), CPU tensors their plain
PyTorch versions.  The unpacked and the XLA-blocked packed retrieval paths
(`_retrieve_topk_block`, `packed_retrieve_core`) and per-row int8 slabs are
not ported yet and raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _window_offsets, augment_queries, euclid_window_offsets, lane_rows,
    packed_retrieve_pallas, packed_retrieve_pallas_euclid, slab_window_dots,
)

_ROW_INT8 = "per-row int8 slabs are not ported yet (ROADMAP Queue 1 item 4)"
_CORE = ("euclidean slabs without the augmented layout take the JAX "
         "package's packed_retrieve_core, which is not ported yet (ROADMAP "
         "Queue 1 item 4); pack with augment=True")
_PACK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}
_PACK_CHUNK = 1 << 20        # rows per pack step: bounds the f32 gather


@dataclasses.dataclass
class LshIndex:
    """L hash tables over one set of indexed rows.

    bucket_ids:    [n, L] int32 — bucket of row i in table l.
    detailed:      [L, n] int32 k-tuple fingerprints (euclidean, else None).
    sorted_rows:   [L, n] int32 — row ids sorted by bucket id per table (CSR);
                   euclidean rows of one bucket are sorted by fingerprint.
    bucket_starts: [L, n_buckets + 1] int32 — CSR offsets per table.

    Optional packed-slab layout (pack_index): per-table copies of the
    corpus in CSR order, so a query's bucket window is ONE contiguous slab.
    packed:           [L, n + pad, d or d_aug] (f32, bf16, int8).
    packed_rows:      [L, n + pad] int32 — sorted_rows padded with sentinel n.
    packed_detailed:  [L, n + pad] int32 CSR-ordered fingerprints (euclidean).
    packed_gscale:    f32 scalar, the one dequant scale of global-scale int8
                      slabs: raw kernel dots x this scale ~ sims / ranks.
    packed_aug_scale: f32 scalar of the augmented layout: the query's norm
                      column (int8 stores -|x|^2 / (2 g s) there).
    """

    metric: str
    n_buckets: int
    n_rows: int
    family: Union[CosineLsh, PStableLsh]
    bucket_ids: torch.Tensor
    sorted_rows: torch.Tensor
    bucket_starts: torch.Tensor
    detailed: Optional[torch.Tensor] = None
    packed: Optional[torch.Tensor] = None
    packed_rows: Optional[torch.Tensor] = None
    packed_detailed: Optional[torch.Tensor] = None
    packed_gscale: Optional[torch.Tensor] = None
    packed_aug_scale: Optional[torch.Tensor] = None


def array_getter(meta: Mapping, arrays: Mapping[str, np.ndarray], device):
    """-> get(name): the named array as a tensor on `device`, None when
    absent.  bf16 arrives as its uint16 bit view (named "bfloat16" in
    meta["packed_dtypes"]) and is reinterpreted bit for bit."""
    dtypes = meta.get("packed_dtypes", {})

    def get(name):
        if name not in arrays:
            return None
        a = np.array(arrays[name])
        if dtypes.get(name) == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return get


def family_from_numpy(meta: Mapping, arrays: Mapping[str, np.ndarray], device):
    """The hash family of an archive / handover: cosine hyperplanes, or the
    p-stable (proj, offsets, weights, w)."""
    k, L = int(meta["k"]), int(meta["L"])
    get = array_getter(meta, arrays, device)
    if meta["metric"] == "cosine":
        return CosineLsh(proj=get("proj").float(), k=k, L=L)
    if meta["metric"] != "euclidean":
        raise ValueError(f"unknown metric {meta['metric']!r}")
    return PStableLsh(proj=get("proj").float(), offsets=get("offsets").float(),
                      weights=get("weights").to(torch.int32),
                      w=float(meta["w"]), k=k, L=L)


def index_from_numpy(
    meta: Mapping, arrays: Mapping[str, np.ndarray], device
) -> LshIndex:
    """Build an LshIndex from the JAX index's arrays (the checkpoint
    layout): meta {metric, n_buckets, n_rows, k, L, w (euclidean),
    packed_dtypes?}; arrays proj, offsets + weights (euclidean),
    bucket_ids, sorted_rows, bucket_starts, detailed (euclidean) and the
    optional packed, packed_rows, packed_detailed, packed_gscale,
    packed_aug_scale."""
    if "packed_scale" in arrays:
        raise NotImplementedError(_ROW_INT8)
    if "packed_sqnorm" in arrays:
        raise NotImplementedError(_CORE)
    get = array_getter(meta, arrays, device)
    return LshIndex(
        metric=meta["metric"],
        n_buckets=int(meta["n_buckets"]),
        n_rows=int(meta["n_rows"]),
        family=family_from_numpy(meta, arrays, device),
        bucket_ids=get("bucket_ids"),
        sorted_rows=get("sorted_rows"),
        bucket_starts=get("bucket_starts"),
        detailed=get("detailed") if meta["metric"] == "euclidean" else None,
        packed=get("packed"),
        packed_rows=get("packed_rows"),
        packed_detailed=get("packed_detailed"),
        packed_gscale=get("packed_gscale"),
        packed_aug_scale=get("packed_aug_scale"),
    )


def _csr_from_buckets(
    bucket_ids: torch.Tensor,
    n_buckets: int,
    secondary: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, L] -> (sorted_rows [L, n], starts [L, n_buckets + 1]), int32.

    Per table: a STABLE sort on the bucket id (rows of one bucket keep
    ascending row order, as JAX's stable `lax.sort`) and a left
    searchsorted for the offsets (pointer-bucket insertion,
    cust_hashtable.hpp:65-70).  `secondary` ([n, L] int32 euclidean
    fingerprints) is a second sort key in signed int32 order, so each
    exact-tuple cell is a contiguous run of its bucket: one int64 key
    bucket * 2^32 + (fp + 2^31) sorts both at once."""
    n, L = bucket_ids.shape
    edges = torch.arange(n_buckets + 1, dtype=torch.int64, device=bucket_ids.device)
    rows, starts = [], []
    for l in range(L):
        key = bucket_ids[:, l].long()
        if secondary is not None:
            key = (key << 32) + (secondary[:, l].long() + (1 << 31))
        sorted_key, order = torch.sort(key, stable=True)
        if secondary is not None:
            sorted_key = sorted_key >> 32
        rows.append(order.to(torch.int32))
        starts.append(torch.searchsorted(sorted_key, edges, right=False,
                                         out_int32=True))
    return torch.stack(rows), torch.stack(starts)


def _fp_run_starts(
    fp_at: Callable[[torch.Tensor], torch.Tensor],
    start: torch.Tensor,    # lower CSR bounds (bucket starts)
    end: torch.Tensor,      # upper CSR bounds (bucket ends)
    target: torch.Tensor,   # query fingerprints, same shape
    n: int,
) -> torch.Tensor:
    """First CSR position of `target` in the fingerprint-sorted bucket
    slice [start, end): a fixed-depth branchless binary search in signed
    int32 order (the secondary sort of `_csr_from_buckets`).  When the run
    is absent it returns the lower bound, where the run would begin (`end`
    if every fingerprint of the bucket is smaller), as the JAX function
    does; the window there holds no tuple match."""
    lo, hi = start.long(), end.long()
    target = target.long()
    for _ in range(max(1, math.ceil(math.log2(max(2, n))))):
        active = lo < hi
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = fp_at(torch.clamp(mid, 0, n - 1)).long() < target
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


def _dedup_fixed(ids: torch.Tensor, sentinel: int, budget: int) -> torch.Tensor:
    """Per row of [q, m] ids: sort-unique, truncate to `budget`, pad -1 —
    the std::set union across tables (lsh_cube.hpp:80-89) as two sorts."""
    s, _ = torch.sort(ids, dim=1)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s, _ = torch.sort(torch.where(dup, sentinel, s), dim=1)
    s = s[:, :budget]
    return torch.where(s == sentinel, -1, s)


def build_index(
    generator: Optional[torch.Generator],
    vectors: torch.Tensor,
    metric: str,
    k: int,
    L: int,
    lsh_bucket_div: int = 4,
    euclidean_h_w: float = 1.0,
    family: Union[CosineLsh, PStableLsh, None] = None,
) -> LshIndex:
    """create_LSH_hashtables (lsh_cube.hpp:44-74).  Cosine tables have 2^k
    buckets and hash through K2; euclidean tables n // lsh_bucket_div
    buckets (lsh_cube.hpp:61-66), a p-stable hash of window
    `euclidean_h_w`, and rows ordered by (bucket, fingerprint).  The hash
    parameters come from `generator` unless `family` hands them over (the
    tests pass the JAX package's).  Euclidean rows hash in chunks, so the
    [chunk, L, k] h-values never exist for all n rows."""
    n, d = vectors.shape
    if metric == "cosine":
        if family is None:
            family = CosineLsh.create(generator, d, k, L, vectors.device)
        n_buckets = family.n_buckets
        bucket_ids = family.bucket_ids(vectors)
        detailed = None
    elif metric == "euclidean":
        if family is None:
            family = PStableLsh.create(generator, d, k, L, euclidean_h_w,
                                       vectors.device)
        n_buckets = max(1, n // max(1, lsh_bucket_div))
        bucket_ids = torch.empty(n, L, dtype=torch.int32, device=vectors.device)
        detailed = torch.empty(L, n, dtype=torch.int32, device=vectors.device)
        chunk = 1 << 18
        for s in range(0, n, chunk):
            h = family.hash_values(vectors[s:s + chunk])
            bucket_ids[s:s + chunk] = family.bucket_ids_from_hashes(h, n_buckets)
            detailed[:, s:s + chunk] = family.fingerprints_from_hashes(h).T
    else:
        raise ValueError(f"unknown metric {metric!r}")
    sorted_rows, starts = _csr_from_buckets(
        bucket_ids, n_buckets, secondary=None if detailed is None else detailed.T
    )
    return LshIndex(
        metric=metric,
        n_buckets=n_buckets,
        n_rows=n,
        family=family,
        bucket_ids=bucket_ids,
        sorted_rows=sorted_rows,
        bucket_starts=starts,
        detailed=detailed,
    )


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


def _padded_len(n: int, pad: int) -> int:
    """n + pad rounded up to a 512 multiple (the JAX layout's block grid)."""
    return n + (-(n + pad) % 512 + pad)


def slab_scales(corpus: torch.Tensor, quantized: bool, augment: bool):
    """-> (g_scale, aug_scale), f32 scalars or None, over the whole corpus.

    Cosine int8: amax of the normalized rows / 127.  Augmented euclidean:
    int8 columns share g = amax|x| / 127 and the norm column has its own
    s = max(|x|^2 / 2) / (127 g), so dot x g stays the rank; float slabs
    store the column as is (s = 1)."""
    if augment:
        norm_half_max = torch.max(torch.sum(corpus * corpus, dim=1)) / 2.0
        if not quantized:
            return None, torch.tensor(1.0, device=corpus.device)
        g = torch.clamp(torch.max(torch.abs(corpus)).float(), min=1e-30) / 127.0
        return g, torch.clamp(norm_half_max, min=1e-30) / (127.0 * g)
    if not quantized:
        return None, None
    amax = torch.max(
        torch.amax(torch.abs(corpus), dim=1)
        / torch.clamp(_row_norms(corpus.float())[:, 0], min=1e-30)
    ).float()
    return torch.clamp(amax, min=1e-30) / 127.0, None


def _slab_rows(
    g: torch.Tensor,            # [m, d] f32 rows in CSR order
    metric: str,
    dtype: torch.dtype,
    g_scale: Optional[torch.Tensor],
    aug_scale: Optional[torch.Tensor],
    d_out: int,
) -> torch.Tensor:
    """[m, d] f32 rows -> [m, d_out] slab rows in `dtype`: cosine rows
    normalized; augmented rows [x, -|x|^2/2, 0-pad]; int8 symmetric with
    the global scale (round half to even, as jnp.round)."""
    quantized = not dtype.is_floating_point
    if metric == "cosine":
        g = g / torch.clamp(_row_norms(g), min=1e-30)
    if aug_scale is None:
        if quantized:
            g = torch.clamp(torch.round(g / g_scale), -127, 127)
        return g.to(dtype)
    norm_col = (-torch.sum(g * g, dim=1) / 2.0)[:, None]
    if quantized:
        g = torch.clamp(torch.round(g / g_scale), -127, 127)
        norm_col = torch.clamp(torch.round(norm_col / (g_scale * aug_scale)), -127, 0)
    zeros = torch.zeros(g.shape[0], d_out - g.shape[1] - 1, device=g.device)
    return torch.cat([g, norm_col, zeros], dim=1).to(dtype)


def slab_width(metric: str, dtype: torch.dtype, scale_mode: str, augment: bool,
               d: int) -> int:
    """Check that the port has the packed layout asked for; -> its row
    width: d, or for augmented rows d + 1 rounded up to 128."""
    if augment and metric != "euclidean":
        raise ValueError("augment=True is the euclidean rank layout")
    if metric == "euclidean" and not augment:
        raise NotImplementedError(_CORE)
    if scale_mode not in ("auto", "global"):
        raise NotImplementedError(_ROW_INT8)
    if not dtype.is_floating_point and dtype != torch.int8:
        raise ValueError(f"quantized slabs are int8, got {dtype}")
    return -(-(d + 1) // 128) * 128 if augment else d


def fill_slab(out: torch.Tensor, corpus: torch.Tensor, rows: torch.Tensor,
              metric: str, g_scale, aug_scale) -> None:
    """out[:len(rows)] = slab_rows of corpus[rows], in row chunks, which
    bounds the f32 gather temporary to one [chunk, d] block."""
    for s in range(0, rows.shape[0], _PACK_CHUNK):
        e = min(rows.shape[0], s + _PACK_CHUNK)
        out[s:e] = _slab_rows(corpus[rows[s:e].long()].float(), metric, out.dtype,
                             g_scale, aug_scale, out.shape[-1])


def pack_index(
    index: LshIndex,
    corpus: torch.Tensor,
    dtype: torch.dtype = torch.bfloat16,
    pad: int = 4096,
    scale_mode: str = "auto",
    augment: bool = False,
) -> LshIndex:
    """Attach the packed-slab layout: per-table CSR-ordered copies of the
    corpus, [L, n + pad, d or d_aug] in `dtype`, trailing rows zero with
    sentinel id n; the padded length is a 512 multiple.

    Cosine rows are L2-normalized.  augment=True (euclidean only) stores
    [x, -|x|^2/2, 0-pad] in d_aug = ceil((d+1)/128)*128 columns, so K1's
    plain dot with [q, s, 0-pad] is the rank x.q - |x|^2/2.
    dtype=torch.int8 stores symmetric quantized slabs with ONE global scale
    (`slab_scales`; scale_mode "auto" == "global"), so raw int8 dots are
    order-preserving; augmented int8 adds the norm column's own scale.
    Per-row scales (scale_mode "row", the euclidean default without
    augment) are not ported yet.

    Tables are packed one at a time (`fill_slab`)."""
    d_out = slab_width(index.metric, dtype, scale_mode, augment, corpus.shape[1])
    L, n = index.sorted_rows.shape
    g_scale, aug_scale = slab_scales(corpus, not dtype.is_floating_point, augment)
    n_pad = _padded_len(n, pad)
    packed = torch.zeros(L, n_pad, d_out, dtype=dtype, device=corpus.device)
    for l in range(L):
        fill_slab(packed[l], corpus, index.sorted_rows[l], index.metric, g_scale,
                  aug_scale)
    packed_rows = torch.nn.functional.pad(index.sorted_rows, (0, n_pad - n), value=n)
    packed_detailed = None
    if index.detailed is not None:
        packed_detailed = torch.nn.functional.pad(
            torch.gather(index.detailed, 1, index.sorted_rows.long()), (0, n_pad - n))
    return dataclasses.replace(
        index, packed=packed, packed_rows=packed_rows,
        packed_detailed=packed_detailed, packed_gscale=g_scale,
        packed_aug_scale=aug_scale,
    )


def query_hashes(
    index: LshIndex, queries: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Hash queries with the index's family -> (bucket_ids [q, L],
    fingerprints [q, L] for euclidean tables, else None)."""
    if index.metric == "cosine":
        return index.family.bucket_ids(queries), None
    h = index.family.hash_values(queries)
    return (index.family.bucket_ids_from_hashes(h, index.n_buckets),
            index.family.fingerprints_from_hashes(h))


def candidate_mask(
    index: LshIndex, queries: torch.Tensor, filtered: bool = True
) -> torch.Tensor:
    """Dense [q, n] candidate mask == get_LSH_[filtered_]combined_buckets
    (lsh_cube.hpp:77-106).  filtered euclidean tables also require the
    k-tuple fingerprint to match; for cosine tables the bucket id IS the
    k-bit tuple, so filtered and unfiltered coincide."""
    q_buckets, q_detailed = query_hashes(index, queries)
    same = q_buckets[:, None, :] == index.bucket_ids[None, :, :]   # [q, n, L]
    if filtered and index.detailed is not None:
        same = same & (q_detailed[:, None, :] == index.detailed.T[None, :, :])
    return torch.any(same, dim=-1)


def mask_from_candidate_ids(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """[q, budget] id lists -> dense [q, n] bool mask (-1 entries ignored)."""
    mask = torch.zeros(ids.shape[0], n_rows, dtype=torch.bool, device=ids.device)
    rows = torch.arange(ids.shape[0], device=ids.device)[:, None].expand(ids.shape)
    real = ids >= 0
    mask[rows[real], ids[real].long()] = True
    return mask


def _dedup_rank_fixed(
    ids: torch.Tensor, sentinel: int, budget: int, n_tables: int,
    with_count: bool = False,
):
    """Per row of [q, m] ids: dedup, rank by multi-table collision count,
    truncate to budget, pad -1.

    When the union across tables exceeds the budget, the rows that collided
    with the query in the MOST tables come first (collision multiplicity is
    a monotone proxy for similarity), ties by ascending row id.  Each id's
    count is its run length in the sorted row, from a running max of run
    starts and a reversed running min of run ends.  For m < 2^16 one int32
    key ((n_tables - count) << 16 | position) carries the whole order, its
    low bits the position to gather; wider rows sort an f32 key
    (n_tables - count) + id / (sentinel + 1), as the JAX function does,
    with a stable sort.  -> [q, min(m, budget)] int32 (and the per-row
    count of distinct ids with with_count)."""
    q, m = ids.shape
    dev = ids.device
    s, _ = torch.sort(ids.long(), dim=1)
    iota = torch.arange(m, device=dev).expand(q, m)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:, :-1] = s[:, :-1] != s[:, 1:]
    run_start = torch.cummax(torch.where(first, iota, 0), dim=1).values
    run_end = torch.flip(torch.cummin(torch.flip(torch.where(last, iota, m - 1), [1]),
                                      dim=1).values, [1])
    cnt = run_end - run_start + 1
    valid_first = first & (s != sentinel)
    if m < (1 << 16):
        big = 1 << 30
        key = torch.where(valid_first, ((n_tables - cnt) << 16) | iota, big)
        ksel = torch.sort(key, dim=1).values[:, :budget]
        out = torch.where(ksel < big, torch.gather(s, 1, ksel & 0xFFFF), -1)
    else:
        keyf = torch.where(
            valid_first,
            (n_tables - cnt).float()
            + s.float() / torch.tensor(sentinel + 1, dtype=torch.float32, device=dev),
            float("inf"),
        )
        kval, order = torch.sort(keyf, dim=1, stable=True)
        out = torch.where(torch.isfinite(kval[:, :budget]),
                          torch.gather(s, 1, order[:, :budget]), -1)
    out = out.to(torch.int32)
    if with_count:
        return out, valid_first.sum(dim=1, dtype=torch.int32)
    return out


def gather_candidate_ids(
    sorted_rows: torch.Tensor,        # [L, n] CSR member arrays
    bucket_starts: torch.Tensor,      # [L, nb + 1]
    detailed: Optional[torch.Tensor],   # [L, n] fingerprints or None (no filter)
    n_rows: int,
    q_buckets: torch.Tensor,          # [q, L]
    q_detailed: Optional[torch.Tensor],  # [q, L] fingerprints or None
    budget: int,
    per_table: int = 0,
    with_stats: bool = False,
):
    """Raw-array core of candidate_ids, as batched tensor ops over [q, L,
    per_table] windows: per query and table a window of up to `per_table`
    CSR positions — at the query's exact-tuple run when `detailed` is
    given, else at the pseudo-random offset of `_window_offsets` (buckets
    larger than the window are sampled at an offset drawn from (bucket,
    table), which keeps the L tables' coverage independent) — then the
    count-ranked dedup of the [q, L * per_table] union, truncated to budget.

    with_stats=True also returns a truncation-accounting dict of per-query
    int32 vectors:
      unique_candidates  — distinct rows gathered before the budget cut;
      budget_dropped     — distinct rows the budget discarded;
      window_dropped     — bucket members beyond the per-table window (an
                           upper bound for the filtered path, whose windows
                           start at the exact-tuple run)."""
    L = sorted_rows.shape[0]
    per_table = per_table or budget
    dev = q_buckets.device
    l_idx = torch.arange(L, device=dev)[None, :]
    qb = q_buckets.long()
    start = bucket_starts[l_idx, qb].long()                          # [q, L]
    end = bucket_starts[l_idx, qb + 1].long()
    if detailed is not None:
        base = _fp_run_starts(lambda p: detailed[l_idx, sorted_rows[l_idx, p].long()],
                              start, end, q_detailed, n_rows).long()
    else:
        base = _window_offsets(bucket_starts, q_buckets, per_table)[0].long()
    offs = base[:, :, None] + torch.arange(per_table, device=dev)     # [q, L, P]
    valid = offs < end[:, :, None]
    rows = sorted_rows[l_idx[:, :, None], torch.clamp(offs, max=n_rows - 1)]
    if detailed is not None:
        valid &= detailed[l_idx[:, :, None], rows.long()] == q_detailed[:, :, None]
    gathered = torch.where(valid, rows, n_rows).reshape(q_buckets.shape[0], -1)
    if not with_stats:
        return _dedup_rank_fixed(gathered, n_rows, budget, L)
    ids, n_unique = _dedup_rank_fixed(gathered, n_rows, budget, L, with_count=True)
    stats = {
        "unique_candidates": n_unique,
        "budget_dropped": torch.clamp(n_unique - budget, min=0),
        "window_dropped": torch.clamp(end - start - per_table, min=0).sum(
            dim=1, dtype=torch.int32),
    }
    return ids, stats


def candidate_ids(
    index: LshIndex,
    queries: torch.Tensor,
    budget: int,
    filtered: bool = True,
    per_table: int = 0,
    with_stats: bool = False,
):
    """CSR fixed-budget retrieval: [q, d] -> [q, budget] row ids (-1 pad),
    count-ranked (`gather_candidate_ids`).  per_table defaults to `budget`:
    any single table's bucket may supply the whole candidate set, as the
    reference unions whole buckets (lsh_cube.hpp:77-106); a smaller
    per_table trades recall for gather width."""
    q_buckets, q_detailed = query_hashes(index, queries)
    return gather_candidate_ids(
        index.sorted_rows, index.bucket_starts,
        index.detailed if filtered else None,
        index.n_rows, q_buckets, q_detailed, budget, per_table,
        with_stats=with_stats,
    )


def candidate_ids_scored(
    index: LshIndex,
    queries: torch.Tensor,
    budget: int,
    per_table: int = 256,
) -> torch.Tensor:
    """Score-ranked candidate sets off K1: [q, d] -> [q, budget] unique row
    ids (-1 pad), ranked by cosine similarity (or the augmented euclidean
    rank x.q - |x|^2/2).

    K1 dots every lane of one maskless window per table; stage 1 keeps the
    ceil(budget / L) best lanes of each window with an exact `torch.topk`
    (the TPU ran `approx_max_k`, so the port's survivors are a superset);
    the survivors are sorted by id (a stable sort, scores gathered by its
    permutation), duplicates and pad rows dropped, and the best `budget`
    kept.  >= kk distinct better rows in one window imply >= kk globally
    better rows, so the set holds the global score-top-ceil(budget / L).

    Needs a packed index with scale-free slabs: cosine (f32, bf16 or
    global-scale int8), or euclidean with the augmented layout (windows at
    the query's fingerprint run)."""
    if index.packed is None:
        raise ValueError("candidate_ids_scored requires a packed index")
    euclid_aug = index.metric == "euclidean" and index.packed_aug_scale is not None
    if not (index.metric == "cosine" or euclid_aug):
        raise ValueError(
            "candidate_ids_scored rides the slab kernel: cosine scale-free slabs "
            "or augmented euclidean slabs only (use candidate_ids for the general path)"
        )
    L = index.sorted_rows.shape[0]
    n = index.n_rows
    q = queries.shape[0]
    q_buckets, q_detailed = query_hashes(index, queries)
    if euclid_aug:
        s0, sizes = euclid_window_offsets(index.bucket_starts, index.packed_detailed,
                                          q_buckets, q_detailed, per_table)
        qv = augment_queries(queries, index.packed_aug_scale, index.packed.shape[-1])
    else:
        s0, sizes = _window_offsets(index.bucket_starts, q_buckets, per_table)
        qv = queries.float()
        qv = qv / torch.clamp(_row_norms(qv), min=1e-30)
    dots, a0 = slab_window_dots(index.packed, s0, sizes, qv, per_table, mask=False)
    win = dots.shape[2]
    kk = min(-(-budget // L), win)
    s1, lane = torch.topk(dots.reshape(q * L, win), kk, dim=1)
    s1 = s1.reshape(q, L * kk)
    l_base = torch.arange(L, device=dots.device)[None, :, None] * win
    ids1 = lane_rows((l_base + lane.reshape(q, L, kk)).reshape(q, L * kk), a0,
                     index.packed_rows, win)
    ids1 = torch.where(s1 > float("-inf"), ids1, n)
    ids_s, perm = torch.sort(ids1, dim=1, stable=True)
    sc_s = torch.gather(s1, 1, perm)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    sc_s = torch.where(dup | (ids_s >= n), float("-inf"), sc_s)
    s2, pos2 = torch.topk(sc_s, min(budget, L * kk), dim=1)
    out = torch.where(s2 > float("-inf"), torch.gather(ids_s, 1, pos2), -1).to(torch.int32)
    return torch.nn.functional.pad(out, (0, budget - out.shape[1]), value=-1)


def rerank_exact(
    corpus: torch.Tensor,    # [n, d] full-precision rows
    metric: str,
    queries: torch.Tensor,   # [q, d]
    ids: torch.Tensor,       # [q, m] candidate row ids, -1 pad
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 rescoring of a small candidate list (the quantized slab
    paths' second stage): one [q, m, d] row gather, then cosine
    similarity or negated euclidean distance."""
    valid = ids >= 0
    cand = corpus[torch.clamp(ids, min=0).long()].float()         # [q, m, d]
    qv = queries.float()
    if metric == "cosine":
        qn = qv / torch.clamp(_row_norms(qv), min=1e-30)
        dots = torch.einsum("qd,qmd->qm", qn, cand)
        cn = torch.sqrt(torch.sum(cand * cand, dim=2))
        score = dots / torch.clamp(cn, min=1e-30)
    else:
        diff = cand - qv[:, None, :]
        score = -torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=2), min=0.0))
    score = torch.where(valid, score, float("-inf"))
    s, pos = torch.topk(score, top_k, dim=1)
    out = torch.gather(ids, 1, pos)
    return s, torch.where(s > float("-inf"), out, -1)


def retrieve_topk_pallas(
    index: LshIndex,
    queries: torch.Tensor,   # [q, d]
    corpus: torch.Tensor,    # [n, d] full-precision rows (int8 exact rerank)
    top_k: int,
    per_table: int = 256,
    strict: bool = False,
    int8_rerank: bool = True,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cosine retrieval over the packed layout through K1: hash, one
    window per table, dots, dedup top-k.  The name is the JAX function's.

    strict=False (production): maskless multiprobe windows + per-table
    stage 1; True: exact reference windows, for parity.  Quantized slabs
    over-fetch 4x and rerank exactly unless int8_rerank=False on a
    global-scale index, which dequantizes the raw-dot scores instead.

    -> (scores [q, top_k] descending, row ids [q, top_k] int32, -1 pad)."""
    if index.packed is None:
        raise ValueError("retrieve_topk_pallas requires a packed index")
    if index.metric != "cosine":
        raise ValueError("retrieve_topk_pallas is cosine-only; use retrieve_topk")
    q_buckets, _ = query_hashes(index, queries)
    quantized = not index.packed.dtype.is_floating_point
    scale_free = quantized and not int8_rerank and index.packed_gscale is not None
    core_k = (
        min(4 * top_k, index.sorted_rows.shape[0] * top_k)
        if quantized and not scale_free else top_k
    )
    s, ids = packed_retrieve_pallas(
        index.packed, index.packed_rows, index.bucket_starts, index.n_rows,
        queries, q_buckets, core_k, per_table, strict=strict,
        stage1_width=stage1_width, stage1_per_table=stage1_per_table,
    )
    if scale_free:
        return s * index.packed_gscale, ids
    if quantized:
        return rerank_exact(corpus, index.metric, queries, ids, top_k)
    return s, ids


def retrieve_topk(
    index: LshIndex,
    queries: torch.Tensor,   # [q, d]
    corpus: torch.Tensor,    # [n, d] — the indexed rows themselves
    top_k: int,
    per_table: int = 256,
    filtered: bool = True,
    int8_rerank: bool = True,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-to-end retrieval: bucket windows -> scores -> dedup top-k.

    Takes the JAX package's kernel branches under its own conditions
    (index.py:1066-1134, the kernel always enabled):
    - augmented euclidean slabs: `packed_retrieve_pallas_euclid` (window at
      the query's fingerprint run when `filtered`), 2x over-fetch and an
      exact rerank, or the dequantized ranks with int8_rerank=False;
    - packed cosine slabs with d % 128 == 0 and n_pad >= per_table + 160:
      `retrieve_topk_pallas` in production mode.
    JAX's q_block streaming is not needed (queries are independent).
    Every other branch of the JAX function is not ported yet and raises.
    stage1_width / stage1_per_table apply to the cosine branch only.

    -> (scores [q, top_k] descending, row ids [q, top_k], -1 pad): cosine
    similarity or negated euclidean distance, nearest first."""
    if index.packed is None:
        raise NotImplementedError(
            "unpacked retrieval (_retrieve_topk_block) is not ported yet "
            "(ROADMAP Queue 1 item 4); pack the index first"
        )
    if index.packed_aug_scale is not None:
        q_buckets, q_detailed = query_hashes(index, queries)
        core_k = 2 * top_k if int8_rerank else top_k
        s, ids = packed_retrieve_pallas_euclid(
            index.packed, index.packed_rows,
            index.packed_detailed if filtered else None,
            index.bucket_starts, index.n_rows, queries.shape[1], queries,
            q_buckets, q_detailed if filtered else None,
            index.packed_gscale, index.packed_aug_scale, core_k, per_table,
        )
        if not int8_rerank:
            return s, ids
        return rerank_exact(corpus, index.metric, queries, ids, top_k)
    if index.metric != "cosine":
        raise NotImplementedError(_CORE)
    if index.packed.shape[-1] % 128 or index.packed.shape[1] < per_table + 160:
        raise NotImplementedError(
            "this shape takes the JAX package's packed_retrieve_core, which "
            "is not ported yet (ROADMAP Queue 1 item 4)"
        )
    return retrieve_topk_pallas(
        index, queries, corpus, top_k, per_table, int8_rerank=int8_rerank,
        stage1_width=stage1_width, stage1_per_table=stage1_per_table,
    )


def pack_dtype(name: str) -> torch.dtype:
    """RecConfig.pack_dtype string -> torch dtype."""
    try:
        return _PACK_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown pack dtype {name!r}") from None
