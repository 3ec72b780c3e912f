"""Sharded recommend over a (dp, mp) mesh: the dense-mask CF engine.

Layout, as the JAX package's `parallel/sharded.py`:
* the neighbour rating set is row-sharded over "mp" (`shard_rating_set`);
* the query batch is row-sharded over "dp";
* each cell (i, j) scores query block i against shard j: the local
  [q_loc, n_loc] cosine, the masked local top-P and the P selected rating
  rows; cells run one after another, so only one cell's [q_loc, n_loc]
  similarities exist at a time;
* the per-cell top-P (weights, rating rows, means, global ids) ride one
  all_gather over the mesh, and each row's S * P candidates are merged in
  shard order by `ops/topk`'s stable selection, so equal weights go to the
  lower shard as `lax.top_k` gives them.  The collective moves O(P (c + 2))
  floats a query, never the corpus.

Every rank returns the whole batch's Recommendation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.models.rec.engine import RatingSet, Recommendation
from crypto_rec_tpu_torch.ops.topk import NEG_INF, masked_topk_desc, topk_desc, topn_indices
from crypto_rec_tpu_torch.parallel.mesh import (
    Mesh, all_gather_cells, all_gather_mp, shard_rows,
)

_EPS = 1e-30


def shard_rating_set(mesh: Mesh, rs: RatingSet, axis: str = "mp") -> RatingSet:
    """A global RatingSet -> this rank's row shards over "mp": ratings and
    known [S_loc, n / mp, c], mean [S_loc, n / mp]."""
    if axis != "mp":
        raise ValueError("rating sets shard over the mp axis")
    return RatingSet(ratings=shard_rows(mesh, rs.ratings), known=shard_rows(mesh, rs.known),
                     mean=shard_rows(mesh, rs.mean))


def distributed_topk(
    mesh: Mesh, vals: torch.Tensor, payload_idx: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k into a global top-k: vals [S_loc, q, k_local]
    descending per shard, payload_idx [S_loc, q, k_local] global ids ->
    all_gather over "mp", then the stable top-k of the [q, S * k_local]
    concatenation in shard order."""
    g_vals = all_gather_mp(mesh, vals)                  # [S, q, k_local]
    g_idx = all_gather_mp(mesh, payload_idx)
    q = vals.shape[1]
    flat_vals = g_vals.permute(1, 0, 2).reshape(q, -1)
    flat_idx = g_idx.permute(1, 0, 2).reshape(q, -1)
    top_vals, pos = topk_desc(flat_vals, k)
    return top_vals, torch.gather(flat_idx, 1, pos)


def merge_predict(g_vals, g_r, g_mu, g_gid, q_ratings, q_known, q_mean, top_p, top_n):
    """The merge and prediction tail shared by the sharded CF engines: the
    [q, S * P] candidates of every shard (weights, rating rows [q, S * P,
    c], means, global ids), in shard order -> stable top-P -> mean-centred
    prediction (engine.predict_scores' math) -> top-N unknown coins.
    -> (predicted, top_n, has_neighbors, sims, global ids, valid)."""
    top_vals, pos = topk_desc(g_vals, top_p)
    top_valid = top_vals > NEG_INF
    w = torch.where(top_valid, top_vals, 0.0)
    top_r = torch.gather(g_r, 1, pos[:, :, None].expand(-1, -1, g_r.shape[2]))
    top_mu = torch.gather(g_mu, 1, pos)
    top_gid = torch.gather(g_gid, 1, pos)
    abs_sum = torch.sum(torch.abs(w), dim=1)
    centered = (top_r - top_mu[:, :, None]) * top_valid[:, :, None]
    main_sum = torch.einsum("qp,qpc->qc", w, centered)
    delta = main_sum / torch.clamp(abs_sum, min=_EPS)[:, None]
    pred_unknown = q_mean[:, None] + torch.where((abs_sum > 0.0)[:, None], delta, 0.0)
    predicted = torch.where(q_known, q_ratings, pred_unknown)
    top = topn_indices(predicted, ~q_known, top_n)
    return predicted, top, torch.any(top_valid, dim=1), top_vals, top_gid, top_valid


def sharded_recommend(
    mesh: Mesh,
    queries: RatingSet,
    neighbors: RatingSet,
    cand_mask: torch.Tensor,
    top_p: int,
    top_n: int,
) -> Recommendation:
    """Multi-cell recommend: queries [q, c] (global) sharded over dp, the
    neighbours (`shard_rating_set`) over mp, `cand_mask` the dense global
    [q, n] candidate mask.  q must divide dp and n mp (pad rows first)."""
    q = queries.ratings.shape[0]
    n_loc = neighbors.ratings.shape[1]
    if q % mesh.dp:
        raise ValueError(f"queries {q} must divide the dp axis {mesh.dp}")
    q_loc = q // mesh.dp
    dev = mesh.device
    pos = {j: p for p, j in enumerate(mesh.local_shards)}
    vals_c, r_c, mu_c, gid_c = [], [], [], []
    for i, j in mesh.cells:
        rows = slice(i * q_loc, (i + 1) * q_loc)
        q_r = queries.ratings[rows].to(dev).float()
        n_r = neighbors.ratings[pos[j]].float()
        n_mu = neighbors.mean[pos[j]]
        mask = cand_mask[rows, j * n_loc:(j + 1) * n_loc].to(dev)
        dots = torch.matmul(q_r, n_r.T)
        qn = torch.sqrt(torch.sum(q_r * q_r, dim=1))
        nn = torch.sqrt(torch.sum(n_r * n_r, dim=1))
        sims = dots / torch.clamp(qn[:, None] * nn[None, :], min=_EPS)
        del dots
        vals, idx, valid = masked_topk_desc(sims, mask, top_p)
        del sims
        safe = torch.clamp(idx, min=0) * valid
        r_c.append(n_r[safe])                                   # [q_loc, P, c]
        mu_c.append(n_mu[safe])
        vals_c.append(torch.where(valid, vals, NEG_INF))
        gid_c.append(torch.where(valid, idx + j * n_loc, -1))
    g_vals = all_gather_cells(mesh, torch.stack(vals_c))        # [dp, S, q_loc, P]
    g_r = all_gather_cells(mesh, torch.stack(r_c))
    g_mu = all_gather_cells(mesh, torch.stack(mu_c))
    g_gid = all_gather_cells(mesh, torch.stack(gid_c))
    S = mesh.mp

    def rows_of(t):         # [dp, S, q_loc, P, ...] -> [q, S * P, ...]
        t = t.transpose(1, 2)
        return t.reshape(q, S * top_p, *t.shape[4:])

    predicted, top, has, sims, gids, valid = merge_predict(
        rows_of(g_vals), rows_of(g_r), rows_of(g_mu), rows_of(g_gid),
        queries.ratings.to(dev).float(), queries.known.to(dev), queries.mean.to(dev).float(),
        top_p, top_n)
    return Recommendation(predicted=predicted, top_n=top, has_neighbors=has, sims=sims,
                          neighbor_idx=torch.where(valid, gids, -1), neighbor_valid=valid)
