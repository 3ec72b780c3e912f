"""IVF (inverted-file) retrieval: k-means partition + cluster-pruned scoring.

Where LSH gathers scattered bucket members, IVF reorders the corpus so each
cluster is one CONTIGUOUS block of rows, and a probe reads whole blocks.
The partition is the package's own k-means (models/cluster/kmeans.py),
the reference's clustering redeployed as an index structure.

Build: k-means over the corpus (optionally on its leading rows), assign
every row (Lloyd), sort rows by cluster, pad each cluster block to a fixed
capacity (4x the average cluster, rounded up to 8; rows beyond it are not
indexed and are counted in `dropped_rows`; fill slots hold row id -1).

Query: a [q, d] x [d, K] centroid distance -> the nprobe nearest clusters
-> their blocks gathered -> one score + top-k over [q, nprobe * capacity]
candidates, in query blocks of q_block.  The scoring is a plain torch
batched product, as the JAX package computes it outside any kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from crypto_rec_tpu_torch.models.cluster.assign import lloyd_assign
from crypto_rec_tpu_torch.models.cluster.kmeans import kmeans
from crypto_rec_tpu_torch.ops.distances import pairwise_distances
from crypto_rec_tpu_torch.ops.topk import topk_desc

_ASSIGN_ROWS = 1 << 18     # rows per Lloyd step of the build: bounds [rows, K]
_PACK_CLUSTERS = 256       # clusters per gather step of the block packing


@dataclasses.dataclass
class IvfIndex:
    """Cluster-blocked corpus.

    blocks:      [n_clusters, capacity, d] rows grouped by cluster, padded.
    row_ids:     [n_clusters, capacity] int32 original row id, -1 for pad.
    block_rows:  [n_clusters] int32 indexed member count per cluster.
    dropped_rows: members beyond a cluster's capacity, which are not
                 indexed (counted, never silent).
    """

    metric: str
    n_clusters: int
    capacity: int
    n_rows: int
    dropped_rows: int
    centroids: torch.Tensor
    blocks: torch.Tensor
    block_rows: torch.Tensor
    row_ids: torch.Tensor


def _pack_blocks(corpus: torch.Tensor, labels: torch.Tensor, n_clusters: int,
                 capacity: int, dtype: Optional[torch.dtype] = None):
    """Sort rows by cluster (a stable sort: members in ascending row order),
    put member j of cluster c in slot c * capacity + j, overflow to a dump
    slot past the table, then gather the blocks in cluster chunks (the f32
    gather never spans the whole corpus).  -> (row_ids, blocks)."""
    n = corpus.shape[0]
    dev = corpus.device
    sorted_labels, order = torch.sort(labels.long(), stable=True)
    starts = torch.searchsorted(sorted_labels, torch.arange(n_clusters, device=dev))
    pos = torch.arange(n, device=dev) - starts[sorted_labels]
    slot = torch.where(pos < capacity, sorted_labels * capacity + pos,
                       n_clusters * capacity)
    flat = torch.full((n_clusters * capacity + 1,), -1, dtype=torch.int32, device=dev)
    flat[slot] = order.to(torch.int32)
    row_ids = flat[:-1].reshape(n_clusters, capacity)
    blocks = torch.empty(n_clusters, capacity, corpus.shape[1],
                         dtype=dtype or corpus.dtype, device=dev)
    for c in range(0, n_clusters, _PACK_CLUSTERS):
        ids = row_ids[c:c + _PACK_CLUSTERS]
        blk = corpus[torch.clamp(ids, min=0).long()]
        blocks[c:c + _PACK_CLUSTERS] = torch.where(ids[:, :, None] >= 0, blk, 0.0)
    return row_ids, blocks


def build_ivf(
    generator: Optional[torch.Generator],
    corpus: torch.Tensor,
    n_clusters: int,
    metric: str = "cosine",
    max_iterations: int = 10,
    train_rows: int = 0,
    capacity: int = 0,
    block_dtype: Optional[torch.dtype] = None,
    init_idx: Optional[torch.Tensor] = None,
) -> IvfIndex:
    """k-means partition + block packing.  train_rows > 0 trains k-means on
    that many leading rows; assignment always covers the full corpus.  The
    k-means++ draws come from `generator` unless init_idx hands the initial
    rows over.  capacity defaults to min(largest cluster, 4x the average),
    rounded up to 8."""
    n = corpus.shape[0]
    train = corpus[:train_rows] if 0 < train_rows < n else corpus
    km = kmeans(generator, train, n_clusters, metric, max_iterations=max_iterations,
                min_dist=0.0, init="kmeans++", init_idx=init_idx)
    labels = torch.cat([lloyd_assign(corpus[s:s + _ASSIGN_ROWS], km.centroids, metric)[0]
                        for s in range(0, n, _ASSIGN_ROWS)])
    counts = torch.bincount(labels.long(), minlength=n_clusters).cpu()
    if capacity <= 0:
        # one pathological cluster must not inflate every probe's read
        avg = max(1, n // n_clusters)
        capacity = int(min(int(counts.max()), 4 * avg))
        capacity = -(-capacity // 8) * 8
    dropped = int(torch.clamp(counts - capacity, min=0).sum())
    row_ids, blocks = _pack_blocks(corpus, labels, n_clusters, capacity, block_dtype)
    return IvfIndex(
        metric=metric, n_clusters=n_clusters, capacity=capacity, n_rows=n,
        dropped_rows=dropped, centroids=km.centroids, blocks=blocks,
        block_rows=torch.clamp(counts, max=capacity).to(torch.int32).to(corpus.device),
        row_ids=row_ids,
    )


def _ivf_block(index: IvfIndex, queries: torch.Tensor, nprobe: int, top_k: int):
    dc = pairwise_distances(queries, index.centroids, index.metric)   # [qb, K]
    _, probe_c = topk_desc(-dc, nprobe)                               # [qb, nprobe]
    qb = queries.shape[0]
    cand = index.blocks[probe_c].reshape(qb, -1, queries.shape[1]).float()
    cand_ids = index.row_ids[probe_c].reshape(qb, -1)
    qv = queries.float()
    if index.metric == "cosine":
        dots = torch.bmm(cand, qv[:, :, None])[:, :, 0]
        qn = torch.sqrt(torch.sum(qv * qv, dim=1, keepdim=True))
        cn = torch.sqrt(torch.sum(cand * cand, dim=2))
        score = dots / torch.clamp(qn * cn, min=1e-30)
    else:
        diff = cand - qv[:, None, :]
        score = -torch.sqrt(torch.clamp(torch.sum(diff * diff, dim=2), min=0.0))
    score = torch.where(cand_ids >= 0, score, float("-inf"))
    vals, pos = topk_desc(score, top_k)
    ids = torch.gather(cand_ids, 1, pos)
    return vals, torch.where(vals > float("-inf"), ids, -1)


def ivf_retrieve_topk(
    index: IvfIndex,
    queries: torch.Tensor,
    nprobe: int,
    top_k: int,
    q_block: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [q, top_k] descending, row ids [q, top_k] int32, -1 pad):
    cosine similarity or negated euclidean distance.  Queries go in blocks
    of q_block, which bounds the [q_block, nprobe, capacity, d] gather."""
    outs = [_ivf_block(index, queries[s:s + q_block], nprobe, top_k)
            for s in range(0, queries.shape[0], q_block)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
