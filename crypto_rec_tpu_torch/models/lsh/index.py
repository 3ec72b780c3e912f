"""Cosine LSH index: CSR bucket tables, packed slabs, fused retrieval.

The reference stores each table as pointer buckets and unions a query's
buckets across L tables through a std::set (reference
lib/data_structures/cust_hashtable.hpp, lsh_cube.hpp:77-106).  Here, as in
the JAX package, each table is a CSR layout: rows sorted by bucket id plus
an offset table.  Two query paths:

1. **Dense mask** (`candidate_mask`): exact reference semantics, [q, n].
2. **Fused packed retrieval** (`retrieve_topk`, `retrieve_topk_pallas`):
   per-table CSR-ordered corpus copies (`pack_index`), one window per
   table scored by kernel K1, dedup top-k epilogue.

Kernels run where the tensors live: CUDA tensors launch the Hopper kernels
(K2 for the hash, K1 for the window dots), CPU tensors their plain PyTorch
versions.  Euclidean tables, the unpacked and the XLA-blocked packed
retrieval paths and per-row int8 slabs are not ported yet and raise
`NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.ops.kernels.slabscore import packed_retrieve_pallas

_EUCLIDEAN = "euclidean LSH is not ported yet (ROADMAP Queue 1 item 10)"
_ROW_INT8 = "per-row int8 slabs are not ported yet (ROADMAP Queue 1 item 4)"
_PACK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}


@dataclasses.dataclass
class LshIndex:
    """L cosine hash tables over one set of indexed rows.

    bucket_ids:    [n, L] int32 — bucket of row i in table l.
    sorted_rows:   [L, n] int32 — row ids sorted by bucket id per table (CSR).
    bucket_starts: [L, n_buckets + 1] int32 — CSR offsets per table.

    Optional packed-slab layout (pack_index): per-table copies of the
    corpus in CSR order, so a query's bucket window is ONE contiguous slab.
    packed:        [L, n + pad, d] — L2-normalized rows (f32, bf16, int8).
    packed_rows:   [L, n + pad] int32 — sorted_rows padded with sentinel n.
    packed_gscale: f32 scalar, the one dequant scale of global-scale int8
                   slabs: raw kernel dots x this scale ~ cosine sims.
    """

    metric: str
    n_buckets: int
    n_rows: int
    family: CosineLsh
    bucket_ids: torch.Tensor
    sorted_rows: torch.Tensor
    bucket_starts: torch.Tensor
    packed: Optional[torch.Tensor] = None
    packed_rows: Optional[torch.Tensor] = None
    packed_gscale: Optional[torch.Tensor] = None


def _tensor(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    """numpy -> torch; bf16 arrives as its uint16 bit view (dtype_name
    "bfloat16") and is reinterpreted bit for bit."""
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def index_from_numpy(
    meta: Mapping, arrays: Mapping[str, np.ndarray], device
) -> LshIndex:
    """Build an LshIndex from the JAX index's arrays (the checkpoint
    layout): meta {metric, n_buckets, n_rows, k, L, packed_dtypes?};
    arrays proj, bucket_ids, sorted_rows, bucket_starts and the optional
    packed, packed_rows, packed_gscale."""
    if meta["metric"] != "cosine":
        raise NotImplementedError(_EUCLIDEAN)
    if "packed_scale" in arrays:
        raise NotImplementedError(_ROW_INT8)
    dtypes = meta.get("packed_dtypes", {})

    def get(name):
        if name not in arrays:
            return None
        return _tensor(arrays[name], dtypes.get(name, ""), device)

    fam = CosineLsh(proj=get("proj").float(), k=int(meta["k"]), L=int(meta["L"]))
    return LshIndex(
        metric="cosine",
        n_buckets=int(meta["n_buckets"]),
        n_rows=int(meta["n_rows"]),
        family=fam,
        bucket_ids=get("bucket_ids"),
        sorted_rows=get("sorted_rows"),
        bucket_starts=get("bucket_starts"),
        packed=get("packed"),
        packed_rows=get("packed_rows"),
        packed_gscale=get("packed_gscale"),
    )


def _csr_from_buckets(
    bucket_ids: torch.Tensor, n_buckets: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n, L] -> (sorted_rows [L, n], starts [L, n_buckets + 1]), int32.

    Per table: a STABLE sort on the bucket id (rows of one bucket keep
    ascending row order, as JAX's `lax.sort((bucket, iota), num_keys=1)`)
    and a left searchsorted for the offsets (pointer-bucket insertion,
    cust_hashtable.hpp:65-70)."""
    n, L = bucket_ids.shape
    edges = torch.arange(n_buckets + 1, dtype=bucket_ids.dtype,
                         device=bucket_ids.device)
    rows, starts = [], []
    for l in range(L):
        sorted_b, order = torch.sort(bucket_ids[:, l], stable=True)
        rows.append(order.to(torch.int32))
        starts.append(torch.searchsorted(sorted_b, edges, right=False,
                                         out_int32=True))
    return torch.stack(rows), torch.stack(starts)


def build_index(
    generator: Optional[torch.Generator],
    vectors: torch.Tensor,
    metric: str,
    k: int,
    L: int,
    family: Optional[CosineLsh] = None,
) -> LshIndex:
    """create_LSH_hashtables for cosine tables (lsh_cube.hpp:44-74): 2^k
    buckets per table, hyperplanes drawn from `generator` unless `family`
    hands them over (tests pass the JAX package's), hash through K2."""
    if metric != "cosine":
        raise NotImplementedError(_EUCLIDEAN)
    if family is None:
        family = CosineLsh.create(generator, vectors.shape[1], k, L, vectors.device)
    bucket_ids = family.bucket_ids(vectors)
    sorted_rows, starts = _csr_from_buckets(bucket_ids, family.n_buckets)
    return LshIndex(
        metric=metric,
        n_buckets=family.n_buckets,
        n_rows=vectors.shape[0],
        family=family,
        bucket_ids=bucket_ids,
        sorted_rows=sorted_rows,
        bucket_starts=starts,
    )


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))


def pack_index(
    index: LshIndex,
    corpus: torch.Tensor,
    dtype: torch.dtype = torch.bfloat16,
    pad: int = 4096,
    scale_mode: str = "auto",
) -> LshIndex:
    """Attach the packed-slab layout: per-table CSR-ordered copies of the
    L2-normalized corpus, [L, n + pad, d] in `dtype`, trailing rows zero
    with sentinel id n; the padded length is a 512 multiple.

    dtype=torch.int8 stores symmetric quantized slabs with ONE global scale
    (scale_mode "auto" == "global" for cosine): amax over the normalized
    rows / 127, so raw int8 dots are order-preserving and only the top-k
    SCORES need the stored scalar.  Rounding is half to even, as jnp.round.
    Per-row scales ("row") are not ported yet.

    Tables and row chunks are packed one at a time, which bounds the f32
    gather temporary to one [chunk, d] block."""
    if index.metric != "cosine":
        raise NotImplementedError(_EUCLIDEAN)
    quantized = not dtype.is_floating_point
    if scale_mode not in ("auto", "global"):
        raise NotImplementedError(_ROW_INT8)
    if quantized and dtype != torch.int8:
        raise ValueError(f"quantized slabs are int8, got {dtype}")
    L, n = index.sorted_rows.shape
    d = corpus.shape[1]
    dev = corpus.device
    g_scale = None
    if quantized:
        amax = torch.max(
            torch.amax(torch.abs(corpus), dim=1)
            / torch.clamp(_row_norms(corpus.float())[:, 0], min=1e-30)
        ).float()
        g_scale = torch.clamp(amax, min=1e-30) / 127.0
    pad = -(n + pad) % 512 + pad
    chunk = 1 << 20
    packed = torch.zeros(L, n + pad, d, dtype=dtype, device=dev)
    for l in range(L):
        rows_l = index.sorted_rows[l].long()
        for s in range(0, n, chunk):
            e = min(n, s + chunk)
            g = corpus[rows_l[s:e]].float()
            g = g / torch.clamp(_row_norms(g), min=1e-30)
            if quantized:
                g = torch.clamp(torch.round(g / g_scale), -127, 127)
            packed[l, s:e] = g.to(dtype)
    packed_rows = torch.nn.functional.pad(index.sorted_rows, (0, pad), value=n)
    return dataclasses.replace(
        index, packed=packed, packed_rows=packed_rows, packed_gscale=g_scale
    )


def query_hashes(index: LshIndex, queries: torch.Tensor) -> Tuple[torch.Tensor, None]:
    """Hash queries with the index's family -> (bucket_ids [q, L], None);
    the second slot holds euclidean fingerprints in the JAX package."""
    if index.metric != "cosine":
        raise NotImplementedError(_EUCLIDEAN)
    return index.family.bucket_ids(queries), None


def candidate_mask(
    index: LshIndex, queries: torch.Tensor, filtered: bool = True
) -> torch.Tensor:
    """Dense [q, n] candidate mask == get_LSH_[filtered_]combined_buckets
    (lsh_cube.hpp:77-106).  For cosine tables the bucket id IS the k-bit
    tuple, so filtered and unfiltered coincide."""
    q_buckets, _ = query_hashes(index, queries)
    same = q_buckets[:, None, :] == index.bucket_ids[None, :, :]   # [q, n, L]
    return torch.any(same, dim=-1)


def rerank_exact(
    corpus: torch.Tensor,    # [n, d] full-precision rows
    metric: str,
    queries: torch.Tensor,   # [q, d]
    ids: torch.Tensor,       # [q, m] candidate row ids, -1 pad
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 cosine rescoring of a small candidate list (the int8 slab
    path's second stage): one [q, m, d] row gather + one einsum."""
    if metric != "cosine":
        raise NotImplementedError(_EUCLIDEAN)
    valid = ids >= 0
    cand = corpus[torch.clamp(ids, min=0).long()].float()         # [q, m, d]
    qv = queries.float()
    qn = qv / torch.clamp(_row_norms(qv), min=1e-30)
    dots = torch.einsum("qd,qmd->qm", qn, cand)
    cn = torch.sqrt(torch.sum(cand * cand, dim=2))
    score = torch.where(valid, dots / torch.clamp(cn, min=1e-30), float("-inf"))
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
    """Fused retrieval over the packed layout through K1: hash, one window
    per table, dots, dedup top-k.  The name is the JAX function's.

    strict=False (production): maskless multiprobe windows + per-table
    stage 1; True: exact reference windows, for parity.  Quantized slabs
    over-fetch 4x and rerank exactly unless int8_rerank=False on a
    global-scale index, which dequantizes the raw-dot scores instead.

    -> (scores [q, top_k] descending, row ids [q, top_k] int32, -1 pad)."""
    if index.packed is None:
        raise ValueError("retrieve_topk_pallas requires a packed index")
    if index.metric != "cosine":
        raise ValueError("the slab kernel is cosine-only")
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
    int8_rerank: bool = True,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """End-to-end retrieval: bucket windows -> scores -> dedup top-k.

    Takes the JAX package's kernel branch under its own condition
    (index.py:1111-1117, with the kernel always enabled): a packed cosine
    index (its slabs are scale-free: index_from_numpy refuses per-row int8),
    d % 128 == 0 and n_pad >= per_table + 160;
    then it is `retrieve_topk_pallas` in production mode.  JAX's q_block
    streaming is not needed there (queries are independent).  Every other
    branch of the JAX function is not ported yet and raises.

    -> (scores [q, top_k] descending, row ids [q, top_k], -1 pad)."""
    if index.metric != "cosine":
        raise NotImplementedError(_EUCLIDEAN)
    if index.packed is None:
        raise NotImplementedError(
            "unpacked retrieval (_retrieve_topk_block) is not ported yet "
            "(ROADMAP Queue 1 item 4); pack the index first"
        )
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
