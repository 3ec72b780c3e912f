"""The port's mesh, dense sharded recommend and all-to-all bucket routing
(`crypto_rec_tpu_torch/parallel/`) against the JAX package's, on the inputs
and mesh shapes of tests/test_parallel.py: logical cells in one process
against JAX's 8 virtual CPU devices.

Single-chip LSH indexes cross over from JAX as arrays (`handover`).
Routed ids and the dense engine's neighbour ids agree wherever scores are
not tied, scores within rtol 1e-5, predictions within atol 1e-4, top-N
coins away from prediction ties, and every integer stat of the routing
exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.models.rec.engine import RatingSet as JRatingSet
from crypto_rec_tpu.parallel import routing as jrt
from crypto_rec_tpu.parallel.mesh import make_mesh as jax_mesh
from crypto_rec_tpu.parallel.sharded import shard_rating_set as jax_shard_rs
from crypto_rec_tpu.parallel.sharded import sharded_recommend as jax_sharded_recommend
from crypto_rec_tpu_torch.models.lsh.index import build_index, index_from_numpy
from crypto_rec_tpu_torch.models.rec.engine import RatingSet, recommend
from crypto_rec_tpu_torch.ops.oracle import exact_nearest, recall_at_k
from crypto_rec_tpu_torch.parallel import mesh as pmesh
from crypto_rec_tpu_torch.parallel import routing as prt
from crypto_rec_tpu_torch.parallel.sharded import (
    distributed_topk, shard_rating_set, sharded_recommend,
)
from crypto_rec_tpu_torch.parallel.sharded_index import (
    build_sharded_index, shard_corpus, sharded_retrieve_topk,
)

from _torch_parity import assert_recs_match, assert_topk_match, handover, to_np

CPU = torch.device("cpu")


# ---- the mesh and its collectives (one process) ----

@pytest.mark.parametrize("shape,world,cells", [
    ((2, 4), 1, [(i, j) for i in range(2) for j in range(4)]),
    ((2, 4), 2, [(1, 0), (1, 1), (1, 2), (1, 3)]),      # rank 1: one whole row
    ((1, 8), 2, [(0, 4), (0, 5), (0, 6), (0, 7)]),      # rank 1: half a row
])
def test_mesh_cells_in_row_major_blocks(shape, world, cells):
    m = pmesh.Mesh(shape, ("dp", "mp"), CPU, None, rank=world - 1, world=world)
    assert m.cells == cells
    assert m.local_shards == sorted({j for _, j in cells})
    assert pmesh.make_mesh(shape, device="cpu").cells == [
        (i, j) for i in range(shape[0]) for j in range(shape[1])]


class _FakeGroup:
    """Stands in for a process group of `world` ranks in make_mesh."""

    def __init__(self, world):
        self.world = world


@pytest.mark.parametrize("shape,world", [((2, 3), 4), ((2, 3), 3), ((1, 8), 3)])
def test_mesh_refuses_uneven_blocks(monkeypatch, shape, world):
    """Cells must divide over the ranks in whole rows or whole parts of
    one row ((2, 3) over 3 ranks would give rank 1 the cells (0, 2) and
    (1, 0))."""
    monkeypatch.setattr(pmesh.dist, "get_world_size", lambda g: g.world)
    monkeypatch.setattr(pmesh.dist, "get_rank", lambda g: 0)
    with pytest.raises(ValueError, match="divide"):
        pmesh.make_mesh(shape, device="cpu", group=_FakeGroup(world))
    assert pmesh.make_mesh((2, 4), device="cpu", group=_FakeGroup(2)).cells == [
        (0, j) for j in range(4)]


def test_collectives_in_one_process():
    """all_gather over cells is the identity in cell order; all_to_all_mp
    sends block s of cell (i, j) to cell (i, s); psum over shards."""
    m = pmesh.make_mesh((2, 3), device="cpu")
    x = torch.arange(6 * 3 * 2).reshape(6, 3, 2)
    g = pmesh.all_gather_cells(m, x)
    assert torch.equal(g, x.reshape(2, 3, 3, 2))
    recv = pmesh.all_to_all_mp(m, x)
    for c, (i, s) in enumerate(m.cells):
        for j in range(3):
            assert torch.equal(recv[c, j], x[i * 3 + j, s])
    assert torch.equal(pmesh.psum_mp(m, torch.tensor([1, 2, 3])), torch.tensor(6))


def test_distributed_topk_merges_in_shard_order():
    """Equal values go to the lower shard, as lax.top_k over the JAX
    all_gather orders them."""
    m = pmesh.make_mesh((1, 4), device="cpu")
    vals = torch.tensor([[[0.9, 0.5]], [[0.9, 0.7]], [[0.5, 0.1]], [[0.95, 0.5]]])
    ids = torch.arange(8).reshape(4, 1, 2)
    v, i = distributed_topk(m, vals, ids, 4)
    assert torch.equal(v, torch.tensor([[0.95, 0.9, 0.9, 0.7]]))
    assert i.tolist() == [[6, 0, 2, 3]]


# ---- the dense sharded recommend ----

def _ratings(n, c, seed):
    rng = np.random.default_rng(seed)
    known = rng.random((n, c)) < 0.6
    known[np.arange(n), rng.integers(0, c, n)] = True
    raw = np.abs(rng.normal(size=(n, c))).astype(np.float32) * known
    mean = (raw * known).sum(1) / known.sum(1)
    ratings = np.where(known, raw, mean[:, None]).astype(np.float32)
    return ratings, known, mean.astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 4), (1, 4)])
def test_sharded_recommend_matches_jax_and_single_device(shape):
    """test_parallel.py::test_sharded_recommend_matches_single_device, and
    on a (1, 4) mesh (JAX: four of its devices)."""
    qr, qk, qm = _ratings(16, 12, seed=1)
    nr, nk, nm = _ratings(32, 12, seed=2)
    mask = np.random.default_rng(7).random((16, 32)) < 0.5
    jm = jax_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])
    want = jax_sharded_recommend(
        jm, JRatingSet(*map(jnp.asarray, (qr, qk, qm))),
        jax_shard_rs(jm, JRatingSet(*map(jnp.asarray, (nr, nk, nm)))), jnp.asarray(mask),
        top_p=5, top_n=3)
    pm = pmesh.make_mesh(shape, device="cpu")
    queries = RatingSet(*map(torch.from_numpy, (qr, qk, qm)))
    neigh = RatingSet(*map(torch.from_numpy, (nr, nk, nm)))
    got = sharded_recommend(pm, queries, shard_rating_set(pm, neigh), torch.from_numpy(mask),
                            top_p=5, top_n=3)
    assert_recs_match(want, got, rtol=1e-5, atol=1e-4)
    assert_topk_match(want.sims, want.neighbor_idx, got.sims, got.neighbor_idx)
    np.testing.assert_array_equal(to_np(got.neighbor_valid), np.asarray(want.neighbor_valid))
    single = recommend(queries, neigh, torch.from_numpy(mask), top_p=5, top_n=3)
    np.testing.assert_allclose(to_np(got.predicted), to_np(single.predicted), atol=1e-4)
    np.testing.assert_array_equal(to_np(got.top_n), to_np(single.top_n))


# ---- routing ----

def test_route_queries_full_destinations_matches_exact():
    """Every query visits every shard: the routed top-k is the exact one."""
    S = 8
    rng = np.random.default_rng(7)
    n, q, d, k = 16 * S, 4 * S, 10, 3
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    dest = np.ones((q, S), bool)
    jv, ji = jrt.route_queries_by_bucket(jax_mesh((1, 8)), jnp.asarray(queries),
                                         jnp.asarray(dest), jnp.asarray(corpus),
                                         jnp.arange(n, dtype=jnp.int32), "euclidean", k,
                                         cap=q // S)
    pv, pi = prt.route_queries_by_bucket(
        pmesh.make_mesh((1, 8), device="cpu"), torch.from_numpy(queries),
        torch.from_numpy(dest), torch.from_numpy(corpus), torch.arange(n, dtype=torch.int32),
        "euclidean", k, cap=q // S)
    assert_topk_match(jv, ji, pv, pi)
    ed, eidx = exact_nearest(torch.from_numpy(queries), torch.from_numpy(corpus),
                             "euclidean", k)
    np.testing.assert_array_equal(to_np(pi), to_np(eidx))
    np.testing.assert_allclose(-to_np(pv), to_np(ed), atol=1e-4)


def test_route_queries_selective_destinations():
    """Each query visits only the shard of its planted row, and finds it."""
    S = 8
    rng = np.random.default_rng(8)
    n, q, d = 16 * S, 2 * S, 6
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    target = rng.choice(n, size=q, replace=False)
    queries = (corpus[target] + 1e-4 * rng.normal(size=(q, d))).astype(np.float32)
    dest = np.zeros((q, S), bool)
    dest[np.arange(q), target // (n // S)] = True
    _, gids = prt.route_queries_by_bucket(
        pmesh.make_mesh((1, 8), device="cpu"), torch.from_numpy(queries),
        torch.from_numpy(dest), torch.from_numpy(corpus), torch.arange(n, dtype=torch.int32),
        "euclidean", k=1, cap=q)
    np.testing.assert_array_equal(to_np(gids)[:, 0], target)


def _routed_pair(corpus, queries, metric, k, L, key, w=1.0, **kw):
    """routed_retrieve_topk of both packages on one single-chip index (the
    port's handed over from JAX's) -> (jax (v, i, stats), port (v, i,
    stats), port index)."""
    jidx = jax_index.build_index(jax.random.PRNGKey(key), jnp.asarray(corpus), metric, k=k,
                                 L=L, lsh_bucket_div=4, euclidean_h_w=w)
    pidx = index_from_numpy(*handover(jidx), CPU)
    want = jrt.routed_retrieve_topk(jax_mesh((1, 8)), jidx, jnp.asarray(queries),
                                    jnp.asarray(corpus), **kw)
    got = prt.routed_retrieve_topk(pmesh.make_mesh((1, 8), device="cpu"), pidx,
                                   torch.from_numpy(queries), torch.from_numpy(corpus), **kw)
    assert_topk_match(want[0], want[1], got[0], got[1], rtol=1e-5, atol=1e-5)
    assert got[2] == want[2], (got[2], want[2])
    return want, got, pidx


def test_routed_retrieve_topk_recall_and_accounting():
    """The closed all-to-all loop (csr interior, budget n): the planted row
    first, no overflow, replication <= L, the byte accounting, and recall
    at least the dense-mask path's."""
    from crypto_rec_tpu_torch.models.lsh.index import candidate_mask

    rng = np.random.default_rng(11)
    n, q, d, top_k = 4096, 64, 32, 10
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    target = rng.choice(n, size=q, replace=False)
    queries = (corpus[target] + 1e-3 * rng.normal(size=(q, d))).astype(np.float32)
    _, (vals, gids, stats), pidx = _routed_pair(corpus, queries, "cosine", 6, 6, 3,
                                                top_k=top_k, budget=n)
    vals, gids = to_np(vals), to_np(gids)
    assert (gids[:, 0] == target).all()
    assert stats["dropped_requests"] == 0 and stats["replication_factor"] <= 6.0
    assert 1.0 <= stats["mean_destinations_per_query"] <= 8.0
    md = stats["mean_destinations_per_query"]
    assert abs(stats["ici_request_bytes_per_query"] - md * (4 * d + 8 * 6 + 1)) < 1.0
    assert abs(stats["ici_return_bytes_per_query"] - md * 8 * top_k) < 1.0
    assert stats["ici_bytes_per_query_wire"] >= stats["ici_bytes_per_query"]
    for row in gids:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    mask = to_np(candidate_mask(pidx, torch.from_numpy(queries)))
    sims = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ (
        corpus / np.linalg.norm(corpus, axis=1, keepdims=True)).T
    masked = np.where(mask, sims, -np.inf)
    ref_top = -np.sort(-masked, axis=1)[:, :top_k]
    assert (np.where(gids >= 0, vals + 1.0, -np.inf) + 1e-5 >= ref_top).all()
    _, eidx = exact_nearest(torch.from_numpy(queries), torch.from_numpy(corpus), "cosine",
                            top_k)
    order = np.argsort(-masked, axis=1)[:, :top_k]
    mask_ids = np.where(np.take_along_axis(masked, order, 1) > -np.inf, order, -1)
    assert recall_at_k(torch.from_numpy(gids), eidx) >= recall_at_k(
        torch.from_numpy(mask_ids), eidx) - 1e-6


def test_routed_retrieve_topk_overflow_accounted():
    """cap = 1 with 8 buckets over 8 shards must drop requests, and count
    them as JAX counts them."""
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(1024, 16)).astype(np.float32)
    queries = rng.normal(size=(64, 16)).astype(np.float32)
    _, (_, gids, stats), _ = _routed_pair(corpus, queries, "cosine", 3, 8, 1, top_k=5, cap=1)
    assert stats["dropped_requests"] > 0
    assert stats["total_requests"] >= stats["dropped_requests"]
    assert tuple(gids.shape) == (64, 5)


def test_routed_csr_interior_matches_dense_interior():
    """Budget n: the csr interior finds the planted row, and agrees with
    the dense interior on every id both return."""
    rng = np.random.default_rng(23)
    n, q, d, top_k = 2048, 64, 24, 8
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    target = rng.choice(n, size=q, replace=False)
    queries = (corpus[target] + 1e-3 * rng.normal(size=(q, d))).astype(np.float32)
    _, (vd, gd, _), _ = _routed_pair(corpus, queries, "cosine", 5, 4, 9, top_k=top_k,
                                     interior="dense")
    _, (vc, gc, stats), _ = _routed_pair(corpus, queries, "cosine", 5, 4, 9, top_k=top_k,
                                         interior="csr", budget=n)
    assert stats["interior"] == "csr"
    np.testing.assert_array_equal(to_np(gc)[:, 0], target)
    both = (to_np(gc) == to_np(gd)) & (to_np(gc) >= 0)
    np.testing.assert_allclose(to_np(vc)[both], to_np(vd)[both], atol=1e-5)


def test_routed_csr_euclidean_detailed_filter():
    rng = np.random.default_rng(31)
    n, q, d = 1024, 32, 16
    corpus = rng.normal(size=(n, d)).astype(np.float32)
    target = rng.choice(n, size=q, replace=False)
    queries = (corpus[target] + 1e-4 * rng.normal(size=(q, d))).astype(np.float32)
    _, (vals, gids, _), _ = _routed_pair(corpus, queries, "euclidean", 3, 6, 2, w=8.0,
                                         top_k=5, interior="csr", budget=256)
    assert (to_np(gids)[:, 0] == target).mean() >= 0.9
    assert (-to_np(vals)[:, 0] < 0.01).sum() >= 0.9 * q


def test_routed_csr_scales_to_1m_rows():
    """test_parallel.py::test_routed_csr_scales_to_1m_rows on the port
    alone (its own hash draw): at 1,048,576 rows the routed csr interior
    finds the planted row at least as often as the sharded csr engine,
    less 0.03, with no partition overflow and replication <= L."""
    g = torch.Generator().manual_seed(4)
    n, q, d, top_k = 1_048_576, 128, 32, 10
    corpus = torch.randn(n, d, generator=g)
    target = torch.randperm(n, generator=g)[:q]
    queries = corpus[target] + 0.01 * torch.randn(q, d, generator=g)
    m = pmesh.make_mesh((1, 8), device="cpu")
    index = build_index(torch.Generator().manual_seed(7), corpus, "cosine", 12, 4)
    _, gids, stats = prt.routed_retrieve_topk(m, index, queries, corpus, top_k=top_k,
                                              interior="csr", budget=512)
    routed_hit = float((gids[:, 0] == target).float().mean())
    pc = shard_corpus(m, corpus)
    sharded = build_sharded_index(m, None, pc, "cosine", 12, 4, family=index.family)
    _, sids = sharded_retrieve_topk(m, sharded, queries, pc, budget=512, top_k=top_k)
    sharded_hit = float((sids[:, 0] == target).float().mean())
    assert routed_hit >= 0.95 and routed_hit >= sharded_hit - 0.03
    assert stats["partition_overflow_rows"] == 0
    assert stats["replication_factor"] <= 4.0


def test_partitions_agree():
    """The host partition, the device partition and the counts: the same
    resident rows per shard."""
    b = torch.from_numpy(np.random.default_rng(3).integers(0, 64, size=(500, 4)).astype(
        np.int32))
    slot_rows, row_ids, cap = prt.partition_corpus_by_bucket(b.numpy(), 8)
    counts = prt._partition_counts(b, 8)
    resident, counts2, overflow = prt.partition_corpus_by_bucket_device(b, 8, cap)
    assert cap == int(counts.max()) and torch.equal(counts, counts2)
    assert int(overflow.sum()) == 0
    np.testing.assert_array_equal(resident.numpy().reshape(-1), row_ids)
    jres, jcounts, _ = jrt.partition_corpus_by_bucket_device(jnp.asarray(b.numpy()), 8, cap)
    np.testing.assert_array_equal(resident.numpy(), np.asarray(jres))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
