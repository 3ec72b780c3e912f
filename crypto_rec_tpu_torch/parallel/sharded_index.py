"""Row-sharded LSH index: per-shard CSR build, packed slabs and retrieval.

The JAX package's scale architecture (`parallel/sharded_index.py`):

* the corpus is row-sharded over "mp"; every shard hashes ITS rows with the
  replicated hash family (K2 for cosine tables) and builds a shard-local
  CSR table; the build needs no collective;
* a query is hashed once (the family is replicated), each shard gathers
  candidates from its local buckets and scores them against its local rows
  (K1 on packed cosine or augmented euclidean slabs), down to a local
  top-k;
* the local top-ks (scores, global row ids local + shard * n_local, and for
  the CF engines the selected rating rows) merge over one all_gather in
  shard order, by `ops/topk`'s stable selection: equal scores go to the
  lower shard, as `lax.top_k` over the JAX all_gather gives them.

A rank holds only its own shards (`Mesh.local_shards`): every array of a
`ShardedLshIndex` leads with that local shard axis, and the shards are
processed one after another.  Each shard's legs are the single-chip
functions of `models/lsh/index.py` on that shard's arrays (`shard_view`),
so a shard too small for K1's window takes the blocked core, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.lsh.index import (
    PACKED_FIELDS, LshIndex, _in_blocks, build_index, gather_candidate_ids, pack_index,
    packed_retrieve_core, query_hashes, rerank_exact,
)
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _window_offsets, augment_queries, euclid_window_offsets, packed_retrieve_pallas,
    packed_retrieve_pallas_euclid, slab_topk, slab_window_dots,
)
from crypto_rec_tpu_torch.ops.topk import NEG_INF, topk_desc
from crypto_rec_tpu_torch.parallel.mesh import Mesh, all_gather_mp, psum_mp, shard_rows
from crypto_rec_tpu_torch.parallel.sharded import merge_predict

_EPS = 1e-30
_Q_BLOCK = 256


@dataclasses.dataclass
class ShardedLshIndex:
    """Per-shard CSR tables of this rank's shards (`shards`, global ids
    ascending); row ids inside are shard-LOCAL.

    sorted_rows [S_loc, L, n_local], bucket_starts [S_loc, L, n_buckets + 1],
    detailed [S_loc, L, n_local] (euclidean fingerprints) or None.  The
    optional packed fields are `pack_index`'s layout per shard
    (`pack_sharded_index`), [S_loc, ...]; packed_gscale and
    packed_aug_scale are [S_loc]: each shard quantizes with ITS own scale
    and dequantizes its scores before the merge."""

    metric: str
    n_buckets: int
    n_local: int
    n_shards: int
    family: Union[CosineLsh, PStableLsh]
    sorted_rows: torch.Tensor
    bucket_starts: torch.Tensor
    detailed: Optional[torch.Tensor]
    packed: Optional[torch.Tensor] = None
    packed_rows: Optional[torch.Tensor] = None
    packed_sqnorm: Optional[torch.Tensor] = None
    packed_detailed: Optional[torch.Tensor] = None
    packed_scale: Optional[torch.Tensor] = None
    packed_gscale: Optional[torch.Tensor] = None
    packed_aug_scale: Optional[torch.Tensor] = None
    shards: Tuple[int, ...] = ()


def shard_view(index: ShardedLshIndex, p: int) -> LshIndex:
    """Local shard p as a single-chip LshIndex over its n_local rows (no
    bucket_ids: the sharded index keeps only the CSR form)."""
    def at(t):
        return None if t is None else t[p]

    return LshIndex(
        metric=index.metric, n_buckets=index.n_buckets, n_rows=index.n_local,
        family=index.family, bucket_ids=None, sorted_rows=index.sorted_rows[p],
        bucket_starts=index.bucket_starts[p], detailed=at(index.detailed),
        **{f: at(getattr(index, f)) for f in PACKED_FIELDS},
    )


def shard_corpus(mesh: Mesh, corpus) -> torch.Tensor:
    """Global [n, d] rows -> this rank's shards [S_loc, n / mp, d]."""
    return shard_rows(mesh, corpus)


def _stack(views, fields) -> dict:
    """{field: [S_loc, ...] stack of the per-shard values, or None}."""
    out = {}
    for f in fields:
        vals = [getattr(v, f) for v in views]
        out[f] = None if vals[0] is None else torch.stack(vals)
    return out


def build_sharded_index(
    mesh: Mesh,
    generator: Optional[torch.Generator],
    corpus: torch.Tensor,      # [S_loc, n_local, d] this rank's shards
    metric: str,
    k: int,
    L: int,
    lsh_bucket_div: int = 4,
    euclidean_h_w: float = 1.0,
    family: Union[CosineLsh, PStableLsh, None] = None,
) -> ShardedLshIndex:
    """Each shard's CSR tables over its own rows (`build_index` per shard:
    cosine 2^k buckets through K2; euclidean n_local // lsh_bucket_div
    buckets, rows in (bucket, fingerprint) order).  The family comes from
    `generator` (every rank draws the same with the same seed) unless
    `family` hands it over."""
    shards = mesh.local_shards
    if corpus.dim() != 3 or corpus.shape[0] != len(shards):
        raise ValueError(f"corpus must be this rank's {len(shards)} shards "
                         f"[S_loc, n_local, d] (shard_corpus)")
    S_loc, n_local, d = corpus.shape
    if family is None:
        if metric == "cosine":
            family = CosineLsh.create(generator, d, k, L, mesh.device)
        elif metric == "euclidean":
            family = PStableLsh.create(generator, d, k, L, euclidean_h_w, mesh.device)
        else:
            raise ValueError(f"unknown metric {metric!r}")
    views = []
    for p in range(S_loc):
        v = build_index(None, corpus[p], metric, k, L, lsh_bucket_div, euclidean_h_w,
                        family=family)
        views.append(dataclasses.replace(v, bucket_ids=None))
    return ShardedLshIndex(
        metric=metric, n_buckets=views[0].n_buckets, n_local=n_local, n_shards=mesh.mp,
        family=family, shards=tuple(shards),
        **_stack(views, ("sorted_rows", "bucket_starts", "detailed")),
    )


def pack_sharded_index(
    mesh: Mesh,
    index: ShardedLshIndex,
    corpus: torch.Tensor,      # [S_loc, n_local, d] the indexed shards
    dtype: torch.dtype = torch.bfloat16,
    pad: int = 4096,
    scale_mode: str = "auto",
    augment: bool = False,
) -> ShardedLshIndex:
    """`pack_index` applied shard by shard: each shard rewrites ITS rows in
    CSR order, with the scales of ITS rows only ("global" int8: one scalar
    a shard, in packed_gscale [S_loc]), the pad aligned to a 512 multiple.
    No collectives."""
    views = [pack_index(shard_view(index, p), corpus[p], dtype, pad, scale_mode, augment)
             for p in range(len(mesh.local_shards))]
    return dataclasses.replace(index, **_stack(views, PACKED_FIELDS))


def _gids(mesh: Mesh, ids: torch.Tensor, n_local: int) -> torch.Tensor:
    """[S_loc, q, k] shard-local ids (-1 pad) -> global ids, int32."""
    base = torch.tensor(mesh.local_shards, device=ids.device, dtype=torch.int32) * n_local
    return torch.where(ids >= 0, ids.to(torch.int32) + base[:, None, None], -1)


def _merge_topk(mesh: Mesh, vals: torch.Tensor, gids: torch.Tensor, top_k: int):
    """[S_loc, q, k'] per-shard scores and global ids -> all_gather over
    "mp" -> stable top_k of the [q, S k'] row in shard order."""
    g_vals = all_gather_mp(mesh, vals)
    g_ids = all_gather_mp(mesh, gids)
    q = vals.shape[1]
    v, pos = topk_desc(g_vals.permute(1, 0, 2).reshape(q, -1), top_k)
    ids = torch.gather(g_ids.permute(1, 0, 2).reshape(q, -1), 1, pos)
    return v, torch.where(v > NEG_INF, ids, -1)


def _unpacked_leg(view: LshIndex, corpus: torch.Tensor, queries, qb, qd, budget,
                  per_table, top_k):
    """One shard without slabs: count-ranked candidate ids, a gather of
    their rows, exact cosine or -distance, the stable local top-k."""
    ids = gather_candidate_ids(view.sorted_rows, view.bucket_starts, view.detailed,
                               view.n_rows, qb, qd if view.detailed is not None else None,
                               budget, per_table)
    valid = ids >= 0
    safe = torch.clamp(ids, min=0)
    cand = corpus[safe.long()].float()                       # [q, budget, d]
    qv = queries.float()
    if view.metric == "cosine":
        dots = torch.einsum("qd,qbd->qb", qv, cand)
        qn = torch.linalg.vector_norm(qv, dim=1, keepdim=True)
        cn = torch.linalg.vector_norm(cand, dim=2)
        score = dots / torch.clamp(qn * cn, min=_EPS)
    else:
        diff = cand - qv[:, None, :]
        score = -torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=-1), min=0.0))
    score = torch.where(valid, score, NEG_INF)
    vals, slot = topk_desc(score, top_k)
    return vals, torch.where(vals > NEG_INF, torch.gather(safe, 1, slot), -1)


def _packed_leg(view: LshIndex, corpus: torch.Tensor, queries, qb, qd, per_table, top_k,
                filtered, block_rows, int8_rerank):
    """One packed shard, on the JAX package's branches
    (sharded_index.py:330-481): augmented euclidean slabs through K1, 2x
    over-fetch and an exact rerank; scale-free cosine slabs with d % 128 ==
    0 and a pad of per_table + 160 through K1; every other layout through
    the blocked core.  Quantized slabs over-fetch min(4 top_k, n_local) and
    rerank exactly, or with int8_rerank=False on a global-scale shard
    dequantize by the shard's own scalar."""
    n_local = view.n_rows
    quantized = not view.packed.dtype.is_floating_point
    if view.packed_aug_scale is not None:
        _s, ids = packed_retrieve_pallas_euclid(
            view.packed, view.packed_rows, view.packed_detailed if filtered else None,
            view.bucket_starts, n_local, queries.shape[1], queries, qb,
            qd if filtered else None, view.packed_gscale if quantized else None,
            view.packed_aug_scale, 2 * top_k, per_table)
        return rerank_exact(corpus, view.metric, queries, ids, top_k)
    scale_free = quantized and not int8_rerank and view.packed_gscale is not None
    core_k = min(4 * top_k, n_local) if quantized and not scale_free else top_k
    if (view.metric == "cosine" and view.packed_scale is None
            and view.packed.shape[-1] % 128 == 0
            and view.packed.shape[1] >= per_table + 160):
        vals, ids = packed_retrieve_pallas(view.packed, view.packed_rows,
                                           view.bucket_starts, n_local, queries, qb,
                                           core_k, per_table)
    else:
        euclid = view.metric == "euclidean"
        vals, ids = packed_retrieve_core(
            view.packed, view.packed_rows, view.packed_sqnorm if euclid else None,
            view.packed_detailed if euclid and filtered else None, view.bucket_starts,
            n_local, view.metric, queries, qb, qd, core_k, per_table, block_rows,
            packed_scale=view.packed_scale)
    if scale_free:
        return vals * view.packed_gscale, ids
    if quantized:
        return rerank_exact(corpus, view.metric, queries, ids, min(top_k, core_k))
    return vals, ids


def sharded_retrieve_topk(
    mesh: Mesh,
    index: ShardedLshIndex,
    queries: torch.Tensor,   # [q, d], every rank the whole batch
    corpus: torch.Tensor,    # [S_loc, n_local, d] this rank's shards
    budget: int,
    top_k: int,
    per_table: int = 0,
    filtered: bool = True,
    block_rows: int = 128,
    int8_rerank: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [q, top_k] descending, global row ids [q, top_k] int32,
    -1 pad), on every rank.  Scores are cosine similarity or negated
    euclidean distance.  Each shard runs its packed leg (`_packed_leg`) or,
    without slabs, the candidate-gather leg (in query blocks of _Q_BLOCK,
    which bounds its [q, budget, d] row gather); the all_gather merge is
    the same."""
    queries = queries.to(mesh.device)
    qb, qd = query_hashes(index, queries)
    pt = per_table or budget
    vals, ids = [], []
    for p in range(len(mesh.local_shards)):
        view = shard_view(index, p)
        if index.packed is not None:
            v, i = _packed_leg(view, corpus[p], queries, qb, qd, pt, top_k, filtered,
                               block_rows, int8_rerank)
        else:
            if not filtered:
                view = dataclasses.replace(view, detailed=None)
            v, i = _in_blocks(
                lambda qs, b, dd: _unpacked_leg(view, corpus[p], qs, b, dd, budget,
                                                per_table, top_k),
                _Q_BLOCK, queries, qb, qd)
        vals.append(v)
        ids.append(i)
    return _merge_topk(mesh, torch.stack(vals), _gids(mesh, torch.stack(ids), index.n_local),
                       top_k)


def _cf_merge_predict(mesh: Mesh, loc_vals, loc_idx, n_ratings, n_mean, q_ratings,
                      q_known, q_mean, top_p, top_n, n_local):
    """Shared tail of the sharded CF engines: per shard its top-P (sims
    [S_loc, q, P], local ids) with the P selected rating rows and means ->
    all_gather over "mp" -> the stable merge, mean-centred prediction and
    top-N unknown coins (`merge_predict`).
    -> (predicted, top_n, has_neighbors, sims, global ids)."""
    loc_valid = loc_vals > NEG_INF
    safe = (loc_idx * loc_valid).long()
    sel_r = torch.stack([n_ratings[p].float()[safe[p]] for p in range(safe.shape[0])])
    sel_mu = torch.stack([n_mean[p].float()[safe[p]] for p in range(safe.shape[0])])
    gids = _gids(mesh, torch.where(loc_valid, loc_idx, -1), n_local)
    q = q_ratings.shape[0]
    S = mesh.mp

    def merged(t):          # [S, q, P, ...] -> [q, S * P, ...]
        t = all_gather_mp(mesh, t).transpose(0, 1)
        return t.reshape(q, S * top_p, *t.shape[3:])

    predicted, top, has, sims, top_gid, _ = merge_predict(
        merged(loc_vals), merged(sel_r), merged(sel_mu), merged(gids),
        q_ratings, q_known, q_mean, top_p, top_n)
    return predicted, top, has, sims, top_gid


def _ici_bytes(mesh: Mesh, top_p: int, c: int) -> float:
    """All_gather merge traffic a query: S shards x P entries of c rating
    floats, a sim and a mean (f32) and an int32 global id."""
    return float(mesh.mp * top_p * 4 * (c + 3))


def _cf_queries(mesh, q_ratings, q_known, q_mean):
    dev = mesh.device
    return q_ratings.to(dev).float(), q_known.to(dev), q_mean.to(dev).float()


def sharded_recommend_csr(
    mesh: Mesh,
    index: ShardedLshIndex,
    q_ratings: torch.Tensor,   # [q, c], every rank the whole batch
    q_known: torch.Tensor,     # [q, c]
    q_mean: torch.Tensor,      # [q]
    n_ratings: torch.Tensor,   # [S_loc, n_local, c] the indexed rows' shards
    n_mean: torch.Tensor,      # [S_loc, n_local]
    budget: int,
    top_p: int,
    top_n: int,
    per_table: int = 0,
    filtered: bool = True,
):
    """Collaborative filtering over the sharded CSR index: per shard the
    count-ranked candidate gather, cosine against the shard's rating rows,
    the stable local top-P; then the shared merge and prediction.

    Returns (predicted [q, c], top_n [q, top_n], has_neighbors [q], sims
    [q, top_p], global neighbour ids [q, top_p], stats).  stats sums the
    truncation accounting over queries AND shards (unique_candidates,
    budget_dropped, window_dropped: 0-d int64 tensors) and adds
    ici_bytes_per_query, the merge's S * top_p * 4 * (c + 3) bytes."""
    q_ratings, q_known, q_mean = _cf_queries(mesh, q_ratings, q_known, q_mean)
    qb, qd = query_hashes(index, q_ratings)
    vals, idx, trunc = [], [], []
    for p in range(len(mesh.local_shards)):
        view = shard_view(index, p)
        det = view.detailed if filtered else None
        ids, st = gather_candidate_ids(view.sorted_rows, view.bucket_starts, det,
                                       index.n_local, qb, qd if det is not None else None,
                                       budget, per_table, with_stats=True)
        trunc.append(st)
        valid = ids >= 0
        safe = torch.clamp(ids, min=0).long()
        cand = n_ratings[p].float()[safe]                    # [q, B, c]
        dots = torch.einsum("qc,qbc->qb", q_ratings, cand)
        qn = torch.linalg.vector_norm(q_ratings, dim=1, keepdim=True)
        cn = torch.linalg.vector_norm(cand, dim=2)
        del cand
        sims = torch.where(valid, dots / torch.clamp(qn * cn, min=_EPS), NEG_INF)
        v, slot = topk_desc(sims, top_p)
        vals.append(v)
        idx.append(torch.gather(safe, 1, slot))
    stats = {k: psum_mp(mesh, torch.stack([st[k].sum() for st in trunc]))
             for k in ("unique_candidates", "budget_dropped", "window_dropped")}
    outs = _cf_merge_predict(mesh, torch.stack(vals), torch.stack(idx), n_ratings, n_mean,
                               q_ratings, q_known, q_mean, top_p, top_n, index.n_local)
    stats["ici_bytes_per_query"] = _ici_bytes(mesh, top_p, q_ratings.shape[1])
    return (*outs, stats)


def sharded_recommend_scored(
    mesh: Mesh,
    index: ShardedLshIndex,
    q_ratings: torch.Tensor,   # [q, c], every rank the whole batch
    q_known: torch.Tensor,
    q_mean: torch.Tensor,
    n_ratings: torch.Tensor,   # [S_loc, n_local, c]
    n_mean: torch.Tensor,      # [S_loc, n_local]
    top_p: int,
    top_n: int,
    per_table: int = 256,
):
    """CF over the scored candidate engine: each shard runs K1 (mask off)
    on its packed slabs, one window a table, and selects its local top-P
    straight from the dots (`slab_topk`'s per-table stage 1); int8
    global-scale dots are dequantized by the shard's own scalar before the
    merge.  Augmented euclidean shards rank their windows by the euclidean
    rank dot, keep 4 top_p survivors and rescore them with exact cosine
    (the CF weighting of the csr engine) before their local top-P.

    Returns the csr engine's arrays and a stats dict of scalar totals over
    queries, tables and shards: scanned_total (slab rows of the query's
    bucket inside the window), window_dropped_total (bucket rows beyond
    it), and ici_bytes_per_query."""
    if index.packed is None:
        raise ValueError("sharded_recommend_scored requires packed shards")
    euclid_aug = index.metric == "euclidean" and index.packed_aug_scale is not None
    if not (index.metric == "cosine" or euclid_aug) or index.packed_scale is not None:
        raise ValueError("scored CF rides the slab kernel: cosine scale-free slabs or "
                         "augmented euclidean shards only")
    d_slab = index.packed.shape[-1]
    if index.packed.is_cuda and d_slab % 128:
        raise ValueError(f"the slab kernel's shards need a 128-multiple feature dim (got "
                         f"{d_slab}); pad the rating columns or use sharded_recommend_csr")
    q_ratings, q_known, q_mean = _cf_queries(mesh, q_ratings, q_known, q_mean)
    quantized = not index.packed.dtype.is_floating_point
    L = index.sorted_rows.shape[1]
    qb, qd = query_hashes(index, q_ratings)
    l_idx = torch.arange(L, device=qb.device)[None, :]
    vals, idx, scanned, dropped = [], [], [], []
    for p in range(len(mesh.local_shards)):
        view = shard_view(index, p)
        if euclid_aug:
            s0, sizes = euclid_window_offsets(view.bucket_starts, view.packed_detailed, qb,
                                              qd, per_table)
            qv = augment_queries(q_ratings, view.packed_aug_scale, d_slab)
        else:
            s0, sizes = _window_offsets(view.bucket_starts, qb, per_table)
            qv = q_ratings / torch.clamp(
                torch.linalg.vector_norm(q_ratings, dim=1, keepdim=True), min=_EPS)
        size = (view.bucket_starts[l_idx, qb.long() + 1]
                - view.bucket_starts[l_idx, qb.long()]).long()
        scanned.append(torch.clamp(size, max=per_table).sum())
        dropped.append(torch.clamp(size - per_table, min=0).sum())
        dots, a0 = slab_window_dots(view.packed, s0, sizes, qv, per_table, mask=False)
        if euclid_aug:
            m = min(4 * top_p, L * per_table)
            _r, cand_idx = slab_topk(dots, a0, view.packed_rows, index.n_local, m,
                                     exact=False)
            del dots
            cvalid = cand_idx >= 0
            safe = torch.clamp(cand_idx, min=0).long()
            cand = n_ratings[p].float()[safe]                # [q, m, c]
            cdots = torch.einsum("qc,qmc->qm", q_ratings, cand)
            qn = torch.linalg.vector_norm(q_ratings, dim=1, keepdim=True)
            cn = torch.linalg.vector_norm(cand, dim=2)
            sims = torch.where(cvalid, cdots / torch.clamp(qn * cn, min=_EPS), NEG_INF)
            v, slot = topk_desc(sims, top_p)
            i = torch.gather(safe, 1, slot)
        else:
            v, i = slab_topk(dots, a0, view.packed_rows, index.n_local, top_p, exact=False)
            del dots
            if quantized:
                v = v * view.packed_gscale
            i = torch.clamp(i, min=0)
        vals.append(v)
        idx.append(i.long())
    stats = {"scanned_total": psum_mp(mesh, torch.stack(scanned)),
             "window_dropped_total": psum_mp(mesh, torch.stack(dropped))}
    outs = _cf_merge_predict(mesh, torch.stack(vals), torch.stack(idx), n_ratings, n_mean,
                               q_ratings, q_known, q_mean, top_p, top_n, index.n_local)
    stats["ici_bytes_per_query"] = _ici_bytes(mesh, top_p, q_ratings.shape[1])
    return (*outs, stats)
