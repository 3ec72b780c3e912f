"""All-to-all bucket routing: queries travel to the shards that own their
LSH buckets; scores travel back.

The "all-to-all lookup exchange" of the JAX package's `parallel/routing.py`:
the corpus is partitioned by bucket ownership, owner_l(row) = bucket_ids[row,
l] mod S, shard s holding the deduplicated union over tables of the rows it
owns, and a query visits only the shards that own one of its L buckets.
The exchange is two `all_to_all_mp` calls (queries out, top-k back) with a
fixed capacity a (source, destination) pair, so shapes stay static;
requests beyond it are dropped and counted (`routing_overflow`).

Per source cell j (queries [j q_loc, (j + 1) q_loc)), cell by cell:
  1. compact its queries per destination into [S, cap] slot tables;
  2. all_to_all the [S, cap, d] query buffers;
  3. score the received queries against the resident rows, local top-k;
  4. all_to_all the [S, cap, k] (score, global id) results back;
  5. scatter them to the originating slots, drop rows met on two shards,
     and merge the <= S partial top-k lists of each query.

Two interiors for step 3: "csr" (each shard has a CSR table over its
resident rows, `build_routed_index`, so a received query gathers only its
bucket windows) and "dense" (brute force over every resident row, the
recall-maximal oracle of the tests).  Arguments are global arrays that
every rank holds (or the rank's own shards of a `RoutedIndex`); results are
global on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from crypto_rec_tpu_torch.models.lsh.index import (
    _csr_from_buckets, gather_candidate_ids, query_hashes,
)
from crypto_rec_tpu_torch.ops.distances import pairwise_distances
from crypto_rec_tpu_torch.ops.topk import NEG_INF, topk_desc
from crypto_rec_tpu_torch.parallel.mesh import Mesh, all_gather_cells, all_to_all_mp


def _compact_slots(dest_mask: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[q_loc, S] bool -> (slots [S, cap] local query ids, valid [S, cap]):
    per destination the ids of the queries that want it, ascending,
    front-packed and cut to cap."""
    q_loc, S = dest_mask.shape
    ids = torch.arange(q_loc, dtype=torch.int64, device=dest_mask.device)[:, None]
    key = torch.where(dest_mask, ids, q_loc)
    sorted_key = torch.sort(key, dim=0).values.T                # [S, q_loc]
    if cap > q_loc:
        sorted_key = torch.nn.functional.pad(sorted_key, (0, cap - q_loc), value=q_loc)
    slots = sorted_key[:, :cap]
    valid = slots < q_loc
    return torch.where(valid, slots, 0), valid


def _send(mesh: Mesh, queries, dest_mask, cap, extra=()):
    """Steps 1-2 for this rank's cells: per cell its slots and valid, and
    the received [C, S(source), cap, ...] buffers of the queries and of each
    per-query array in `extra`, with the received valid flags."""
    q_loc = queries.shape[0] // mesh.mp
    dev = mesh.device
    slots, valid, bufs = [], [], [[] for _ in range(1 + len(extra))]
    for _, j in mesh.cells:
        rows = slice(j * q_loc, (j + 1) * q_loc)
        sl, va = _compact_slots(dest_mask[rows].to(dev), cap)
        slots.append(sl)
        valid.append(va)
        for b, arr in zip(bufs, (queries,) + tuple(extra)):
            blk = arr[rows].to(dev)[sl]                          # [S, cap, ...]
            b.append(torch.where(va.reshape(*va.shape, *[1] * (blk.dim() - 2)), blk,
                                 torch.zeros((), dtype=blk.dtype, device=dev)))
    recv = [all_to_all_mp(mesh, torch.stack(b)) for b in bufs]
    recv_valid = all_to_all_mp(mesh, torch.stack(valid))
    return slots, valid, recv, recv_valid


def _return_and_merge(mesh: Mesh, neg_vals, gids, slots, valid, k, q_loc):
    """Steps 4-5 for this rank's cells: neg_vals / gids [C, S(source), cap,
    k] go back to their source cells; each source scatters them to the
    originating query slots (invalid capacity slots into a dump row q_loc),
    drops a row id met twice (a row may be resident on several shards),
    and merges the <= S partial lists with the stable top-k.
    -> global (scores [q, k], ids [q, k] int32, -1 pad) on every rank."""
    back_vals = all_to_all_mp(mesh, neg_vals)                    # [C, S(dest), cap, k]
    back_gids = all_to_all_mp(mesh, gids)
    S = mesh.mp
    cap = back_vals.shape[2]
    dev = back_vals.device
    out_v, out_g = [], []
    for c in range(len(mesh.cells)):
        all_vals = torch.full((q_loc + 1, S, k), NEG_INF, dtype=torch.float32, device=dev)
        all_gids = torch.full((q_loc + 1, S, k), -1, dtype=torch.int32, device=dev)
        flat_slots = torch.where(valid[c], slots[c], q_loc).reshape(-1)
        flat_s = torch.arange(S, device=dev)[:, None].expand(S, cap).reshape(-1)
        all_vals[flat_slots, flat_s] = back_vals[c].reshape(-1, k)
        all_gids[flat_slots, flat_s] = back_gids[c].reshape(-1, k).to(torch.int32)
        all_vals = all_vals[:q_loc].reshape(q_loc, S * k)
        all_gids = all_gids[:q_loc].reshape(q_loc, S * k)
        g_sorted, perm = torch.sort(all_gids, dim=1, stable=True)
        v_sorted = torch.gather(all_vals, 1, perm)
        dup = torch.zeros_like(g_sorted, dtype=torch.bool)
        dup[:, 1:] = (g_sorted[:, 1:] == g_sorted[:, :-1]) & (g_sorted[:, 1:] >= 0)
        v_sorted = torch.where(dup, NEG_INF, v_sorted)
        mv, pos = topk_desc(v_sorted, k)
        mg = torch.gather(g_sorted, 1, pos)
        out_v.append(mv)
        out_g.append(torch.where(mv > NEG_INF, mg, -1))
    vals = all_gather_cells(mesh, torch.stack(out_v))[0]        # [S, q_loc, k]
    ids = all_gather_cells(mesh, torch.stack(out_g))[0]
    return vals.reshape(S * q_loc, k), ids.reshape(S * q_loc, k)


def _shard_pos(mesh: Mesh):
    pos = {j: p for p, j in enumerate(mesh.local_shards)}
    return [pos[j] for _, j in mesh.cells]


def route_queries_by_bucket(
    mesh: Mesh,
    queries: torch.Tensor,     # [q, d] global, row-sharded over "mp"
    dest_mask: torch.Tensor,   # [q, S] bool: query q must visit shard s
    corpus: torch.Tensor,      # [n, d] bucket-partitioned, row-sharded over "mp"
    row_ids: torch.Tensor,     # [n] int32 global row ids, -1 on pad slots
    metric: str,
    k: int,
    cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense interior: -> (neg_dist_topk [q, k] descending, global row
    ids [q, k], -1 pad).  Scores are negated distances, nearest first."""
    S = mesh.mp
    q_loc = queries.shape[0] // S
    n_loc = corpus.shape[0] // S
    slots, valid, (recv_q,), recv_valid = _send(mesh, queries, dest_mask, cap)
    neg, gid = [], []
    for c, (_, j) in enumerate(mesh.cells):
        corpus_blk = corpus[j * n_loc:(j + 1) * n_loc].to(mesh.device)
        rid = row_ids[j * n_loc:(j + 1) * n_loc].to(mesh.device)
        rq = recv_q[c].reshape(S * cap, -1)
        d = pairwise_distances(rq, corpus_blk, metric)           # [S cap, n_loc]
        d = torch.where(rid[None, :] >= 0, d, float("inf"))
        nv, idx = topk_desc(-d, k)
        ok = recv_valid[c].reshape(-1)[:, None]
        neg.append(torch.where(ok, nv, NEG_INF).reshape(S, cap, k))
        gid.append(torch.where(ok, rid[idx].to(torch.int32), -1).reshape(S, cap, k))
    return _return_and_merge(mesh, torch.stack(neg), torch.stack(gid), slots, valid, k,
                             q_loc)


def _members(bucket_ids: torch.Tensor, n_shards: int) -> List[torch.Tensor]:
    """Per shard s the ascending ids of the rows it owns in any table
    (bucket mod S == s): the deduplicated union over tables."""
    owners = bucket_ids.long() % n_shards
    return [torch.nonzero((owners == s).any(dim=1)).flatten() for s in range(n_shards)]


def partition_corpus_by_bucket(bucket_ids, n_shards: int):
    """Host-side bucket-ownership partition.  -> (slot_rows [S cap] int64
    gather indices into the corpus, row_ids [S cap] int32 global ids with -1
    on pad slots, cap = the largest shard).  Pad slots repeat row 0."""
    members = _members(torch.as_tensor(np.asarray(bucket_ids)), n_shards)
    cap = max(1, max(len(m) for m in members))
    row_ids = -np.ones((n_shards, cap), np.int32)
    slot_rows = np.zeros((n_shards, cap), np.int64)
    for s, rows in enumerate(members):
        row_ids[s, :len(rows)] = rows.numpy()
        slot_rows[s, :len(rows)] = rows.numpy()
    return slot_rows.reshape(-1), row_ids.reshape(-1), cap


def partition_corpus_by_bucket_device(bucket_ids: torch.Tensor, n_shards: int, cap_r: int):
    """The same partition on the tensor's device, cut to cap_r a shard.
    -> (resident [S, cap_r] int32 row ids (-1 pad), counts [S], overflow
    [S] rows dropped beyond cap_r)."""
    members = _members(bucket_ids, n_shards)
    dev = bucket_ids.device
    counts = torch.tensor([len(m) for m in members], dtype=torch.int32, device=dev)
    resident = torch.full((n_shards, cap_r), -1, dtype=torch.int32, device=dev)
    for s, rows in enumerate(members):
        resident[s, :min(len(rows), cap_r)] = rows[:cap_r].to(torch.int32)
    return resident, counts, torch.clamp(counts - cap_r, min=0)


def _partition_counts(bucket_ids: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Per-shard resident-row counts of the partition, to size cap_r."""
    owners = bucket_ids.long() % n_shards
    return torch.stack([(owners == s).any(dim=1).sum() for s in range(n_shards)]).to(
        torch.int32)


@dataclasses.dataclass
class RoutedIndex:
    """The bucket-owner-partitioned corpus with a CSR table over each
    shard's resident rows, for this rank's shards ([S_loc, ...]).  CSR row
    ids index resident positions 0..cap_r-1; resident_gids maps them to
    global rows (-1 on pad slots).  bucket_starts spans n_buckets + 1
    buckets: bucket n_buckets holds the pad slots, so no query gathers
    them."""

    metric: str
    n_buckets: int
    cap_r: int
    resident_gids: torch.Tensor   # [S_loc, cap_r] int32, -1 pad
    part_corpus: torch.Tensor     # [S_loc, cap_r, d]
    sorted_rows: torch.Tensor     # [S_loc, L, cap_r]
    bucket_starts: torch.Tensor   # [S_loc, L, n_buckets + 2]
    detailed: Optional[torch.Tensor]  # [S_loc, L, cap_r] fingerprints or None
    stats: dict


def build_routed_index(mesh: Mesh, index, corpus: torch.Tensor, cap_r: int = 0) -> RoutedIndex:
    """Partition the corpus by bucket ownership and give each of this
    rank's shards a CSR table over its resident rows.  index: the
    single-chip LshIndex over `corpus` [n, d] (both global, on every rank).
    cap_r: resident capacity a shard; 0 sizes it to the largest shard,
    rounded up to a 128 multiple."""
    S = mesh.mp
    n = corpus.shape[0]
    counts = _partition_counts(index.bucket_ids, S)
    max_count = int(counts.max())
    if cap_r <= 0:
        cap_r = -(-max_count // 128) * 128
    resident, counts, overflow = partition_corpus_by_bucket_device(index.bucket_ids, S, cap_r)
    nb = index.n_buckets
    gids, parts, rows, starts, dets = [], [], [], [], []
    for j in mesh.local_shards:
        res = resident[j]
        safe = torch.clamp(res, min=0).long()
        b_res = torch.where(res[:, None] >= 0, index.bucket_ids[safe], nb)   # [cap_r, L]
        det = None if index.detailed is None else index.detailed[:, safe]   # [L, cap_r]
        r, st = _csr_from_buckets(b_res, nb + 1, secondary=None if det is None else det.T)
        gids.append(res.to(mesh.device))
        parts.append(corpus[safe.to(corpus.device)].to(mesh.device))
        rows.append(r.to(mesh.device))
        starts.append(st.to(mesh.device))
        if det is not None:
            dets.append(det.to(mesh.device))
    stats = {
        "resident_rows_per_shard": cap_r,
        "max_resident_rows": max_count,
        "partition_overflow_rows": int(overflow.sum()),
        "replication_factor": round(float(counts.sum()) / max(1, n), 3),
    }
    return RoutedIndex(
        metric=index.metric, n_buckets=nb, cap_r=cap_r, resident_gids=torch.stack(gids),
        part_corpus=torch.stack(parts), sorted_rows=torch.stack(rows),
        bucket_starts=torch.stack(starts), detailed=torch.stack(dets) if dets else None,
        stats=stats)


def route_queries_by_bucket_csr(
    mesh: Mesh,
    queries: torch.Tensor,       # [q, d] global, row-sharded over "mp"
    q_buckets: torch.Tensor,     # [q, L] int32
    q_detailed,                  # [q, L] fingerprints or None
    dest_mask: torch.Tensor,     # [q, S] bool
    sorted_rows: torch.Tensor,   # [S_loc, L, cap_r] resident CSR (RoutedIndex)
    bucket_starts: torch.Tensor,  # [S_loc, L, nb + 2]
    detailed,                    # [S_loc, L, cap_r] or None
    part_corpus: torch.Tensor,   # [S_loc, cap_r, d]
    resident_gids: torch.Tensor,  # [S_loc, cap_r]
    metric: str,
    k: int,
    cap: int,
    budget: int,
    per_table: int,
    n_buckets: int,
    cap_r: int,
    has_detailed: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The csr interior: queries travel with their bucket ids (and
    euclidean fingerprints), and each destination shard gathers only the
    query's bucket windows from its resident CSR: O(budget) rows scored a
    received query instead of O(cap_r)."""
    S = mesh.mp
    q_loc = queries.shape[0] // S
    L = q_buckets.shape[1]
    if q_detailed is None:
        q_detailed = torch.zeros_like(q_buckets)
    slots, valid, (recv_q, recv_qb, recv_qd), recv_valid = _send(
        mesh, queries, dest_mask, cap, extra=(q_buckets, q_detailed))
    pos = _shard_pos(mesh)
    neg, gid = [], []
    for c in range(len(mesh.cells)):
        p = pos[c]
        rq = recv_q[c].reshape(S * cap, -1).float()
        ids = gather_candidate_ids(
            sorted_rows[p], bucket_starts[p], detailed[p] if has_detailed else None, cap_r,
            recv_qb[c].reshape(S * cap, L), recv_qd[c].reshape(S * cap, L)
            if has_detailed else None, budget, per_table)
        valid_c = ids >= 0
        safe = torch.clamp(ids, min=0).long()
        cand = part_corpus[p][safe].float()                      # [S cap, budget, d]
        if metric == "cosine":
            dots = torch.einsum("qd,qbd->qb", rq, cand)
            qn = torch.linalg.vector_norm(rq, dim=1, keepdim=True)
            cn = torch.linalg.vector_norm(cand, dim=2)
            dist = 1.0 - dots / torch.clamp(qn * cn, min=1e-30)
        else:
            diff = cand - rq[:, None, :]
            dist = torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=2), min=0.0))
        del cand
        dist = torch.where(valid_c, dist, float("inf"))
        nv, slot = topk_desc(-dist, k)
        g = resident_gids[p][torch.gather(safe, 1, slot)]
        ok = recv_valid[c].reshape(-1)[:, None] & (nv > NEG_INF)
        neg.append(torch.where(ok, nv, NEG_INF).reshape(S, cap, k))
        gid.append(torch.where(ok, g, -1).reshape(S, cap, k))
    return _return_and_merge(mesh, torch.stack(neg), torch.stack(gid), slots, valid, k,
                             q_loc)


def bucket_dest_mask(q_buckets: torch.Tensor, n_shards: int) -> torch.Tensor:
    """[q, L] query bucket ids -> [q, S] bool: query q visits shard s iff s
    owns one of its L buckets (mod-S ownership)."""
    owners = q_buckets.long() % n_shards
    shards = torch.arange(n_shards, device=q_buckets.device)
    return torch.any(owners[:, :, None] == shards[None, None, :], dim=1)


def routing_overflow(dest_mask, n_shards: int, cap: int):
    """Requests beyond `cap` a (source, destination) pair, which
    `_compact_slots` drops.  -> (dropped_requests, total_requests)."""
    dm = np.asarray(torch.as_tensor(dest_mask).cpu())
    q_loc = dm.shape[0] // n_shards
    dropped = 0
    for src in range(n_shards):
        counts = dm[src * q_loc:(src + 1) * q_loc].sum(axis=0)
        dropped += int(np.maximum(counts - cap, 0).sum())
    return dropped, int(dm.sum())


def routed_retrieve_topk(
    mesh: Mesh,
    index,                     # single-chip LshIndex over `corpus`
    queries: torch.Tensor,     # [q, d]
    corpus: torch.Tensor,      # [n, d]: the rows the index was built over
    top_k: int,
    cap: int = 0,
    interior: str = "csr",
    budget: int = 0,
    per_table: int = 0,
    routed: Optional[RoutedIndex] = None,
):
    """The all-to-all lookup exchange end to end: partition the corpus by
    bucket ownership, send each query to the <= L shards owning one of its
    buckets, score it there (interior "csr": its bucket windows, budget
    default 16 top_k; "dense": every resident row), merge the top-k that
    come back.  Pass a prebuilt `routed` (build_routed_index) to reuse the
    partition across batches.  cap: per (source, destination) capacity, 0
    => q / S (no overflow possible).

    -> (scores [q, top_k] descending, global ids [q, top_k] -1 pad, stats:
    overflow, replication and the exchange's bytes a query)."""
    S = mesh.mp
    q = queries.shape[0]
    pad_q = (-q) % S
    dev = mesh.device
    queries = queries.to(dev)
    q_buckets, q_detailed = query_hashes(index, queries)
    queries_p = torch.nn.functional.pad(queries, (0, 0, 0, pad_q))
    dest = torch.nn.functional.pad(bucket_dest_mask(q_buckets, S), (0, 0, 0, pad_q))
    cap = cap or (q + pad_q) // S
    if interior == "csr":
        if routed is None:
            routed = build_routed_index(mesh, index, corpus)
        budget = budget or 16 * top_k
        qb_p = torch.nn.functional.pad(q_buckets, (0, 0, 0, pad_q))
        qd_p = (None if q_detailed is None
                else torch.nn.functional.pad(q_detailed, (0, 0, 0, pad_q)))
        vals, gids = route_queries_by_bucket_csr(
            mesh, queries_p, qb_p, qd_p, dest, routed.sorted_rows, routed.bucket_starts,
            routed.detailed, routed.part_corpus, routed.resident_gids, index.metric, top_k,
            cap, budget, per_table or budget, routed.n_buckets, routed.cap_r,
            has_detailed=routed.detailed is not None)
        part_stats = dict(routed.stats)
    elif interior == "dense":
        slot_rows, row_ids, corpus_cap = partition_corpus_by_bucket(
            index.bucket_ids.cpu(), S)
        part_corpus = corpus[torch.from_numpy(slot_rows).to(corpus.device)]
        vals, gids = route_queries_by_bucket(
            mesh, queries_p, dest, part_corpus, torch.from_numpy(row_ids), index.metric,
            top_k, cap)
        part_stats = {"resident_rows_per_shard": int(corpus_cap),
                      "replication_factor": round(S * corpus_cap / max(1, corpus.shape[0]), 3)}
    else:
        raise ValueError(f"unknown interior {interior!r} (csr | dense)")
    dropped, total = routing_overflow(dest, S, cap)
    mean_dest = float(dest.sum()) / max(1, q)
    # bytes a query's exchange moves: the request (f32 query; csr adds its
    # int32 bucket ids and fingerprints) and a validity byte, the return
    # top_k (f32 score, int32 id) pairs, times the real destinations;
    # "wire" counts the fixed-capacity buffers shipped, padding included
    req_bytes = 4 * queries.shape[1] + (8 * q_buckets.shape[1] + 1 if interior == "csr" else 1)
    ret_bytes = 8 * top_k
    stats = {
        "n_shards": S,
        "cap": cap,
        "interior": interior,
        "dropped_requests": dropped,
        "total_requests": total,
        "corpus_rows": int(corpus.shape[0]),
        "mean_destinations_per_query": round(mean_dest, 3),
        "ici_request_bytes_per_query": round(mean_dest * req_bytes, 1),
        "ici_return_bytes_per_query": round(mean_dest * ret_bytes, 1),
        "ici_bytes_per_query": round(mean_dest * (req_bytes + ret_bytes), 1),
        "ici_bytes_per_query_wire": round(
            S * S * cap * (req_bytes + ret_bytes) / max(1, q + pad_q), 1),
        **part_stats,
    }
    return vals[:q], gids[:q], stats
