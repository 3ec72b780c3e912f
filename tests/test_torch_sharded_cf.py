"""The sharded CF engines of the port (`sharded_recommend_csr`,
`sharded_recommend_scored`) against the JAX package's, on the inputs of
tests/test_sharded_csr_recommend.py and on its (1, 8) mesh (8 logical cells
in one process against JAX's 8 CPU devices).

The port's sharded index is built from JAX's hash family (handed over as
arrays).  JAX's scored engine runs its slab kernel in interpret mode; the
port's runs K1's plain version on CPU tensors.  Predictions agree within
atol 1e-4, sims within rtol 1e-5, neighbour ids and top-N coins wherever
they are not tied, has_neighbors and every integer stat exactly.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from crypto_rec_tpu.parallel import sharded_index as jsi
from crypto_rec_tpu.parallel.mesh import make_mesh as jax_mesh
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.lsh.index import build_index, candidate_mask
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh
from crypto_rec_tpu_torch.models.rec.engine import RatingSet, recommend
from crypto_rec_tpu_torch.parallel import sharded_index as psi
from crypto_rec_tpu_torch.parallel.mesh import make_mesh

from _torch_parity import assert_recs_match, assert_topk_match, to_np, to_torch

JMESH = jax_mesh((1, 8))
PMESH = make_mesh((1, 8), device="cpu")
KEY = jax.random.PRNGKey(21)


def port_family(jfam, metric):
    """A JAX CosineLsh / PStableLsh -> the port's family, same parameters."""
    if metric == "cosine":
        return CosineLsh(proj=to_torch(jfam.proj), k=jfam.k, L=jfam.L)
    return PStableLsh(proj=to_torch(jfam.proj), offsets=to_torch(jfam.offsets),
                      weights=to_torch(jfam.weights), w=float(jfam.w), k=jfam.k, L=jfam.L)


def _ratings(n, c, seed):
    rng = np.random.default_rng(seed)
    known = rng.random((n, c)) < 0.6
    known[np.arange(n), rng.integers(0, c, n)] = True
    raw = np.abs(rng.normal(size=(n, c))).astype(np.float32) * known
    mean = (raw * known).sum(1) / known.sum(1)
    ratings = np.where(known, raw, mean[:, None]).astype(np.float32)
    return ratings, known, mean.astype(np.float32)


def _twins(n, c, q, seed, kseed, nseed):
    """Queries planted next to neighbour rows (the scored tests' inputs)."""
    rng = np.random.default_rng(seed)
    nr, _, nm = _ratings(n, c, seed=nseed)
    target = rng.choice(n, size=q, replace=False)
    qr = (nr[target] + 1e-3 * rng.normal(size=(q, c))).astype(np.float32)
    qk = np.random.default_rng(kseed).random((q, c)) < 0.6
    qm = ((qr * qk).sum(1) / np.maximum(qk.sum(1), 1)).astype(np.float32)
    return nr, nm, qr, qk, qm, target


def run_both(engine, nr, nm, qr, qk, qm, metric, k, L, pack=None, build_kw=None, **kw):
    """Build both packages' sharded indexes on nr (the port from JAX's
    family), pack them if asked, run `engine` on both -> (jax, port)."""
    build_kw = build_kw or {}
    jc = jsi.shard_corpus(JMESH, jnp.asarray(nr))
    pc = psi.shard_corpus(PMESH, torch.from_numpy(nr))
    jidx = jsi.build_sharded_index(JMESH, KEY, jc, metric, k, L, **build_kw)
    pidx = psi.build_sharded_index(PMESH, None, pc, metric, k, L, **build_kw,
                                   family=port_family(jidx.family, metric))
    if pack is not None:
        jidx = jsi.pack_sharded_index(JMESH, jidx, jc, dtype=jnp.dtype(pack["dtype"]),
                                      pad=512, augment=pack.get("augment", False))
        pidx = psi.pack_sharded_index(PMESH, pidx, pc, dtype=getattr(torch, pack["dtype"]),
                                      pad=512, augment=pack.get("augment", False))
    jnm = jax.device_put(jnp.asarray(nm), NamedSharding(JMESH, P("mp")))
    jkw = dict(kw)
    if engine == "sharded_recommend_scored":
        jkw["pallas_interpret"] = True
    want = getattr(jsi, engine)(JMESH, jidx, jnp.asarray(qr), jnp.asarray(qk), jnp.asarray(qm),
                                jc, jnm, **jkw)
    got = getattr(psi, engine)(PMESH, pidx, torch.from_numpy(qr), torch.from_numpy(qk),
                               torch.from_numpy(qm), pc, psi.shard_corpus(PMESH, nm), **kw)
    return want, got


def assert_cf_match(want, got):
    """(predicted, top_n, has, sims, gids, stats) of the two packages."""
    ns = lambda o: types.SimpleNamespace(predicted=o[0], top_n=o[1], has_neighbors=o[2])
    assert_recs_match(ns(want), ns(got), rtol=1e-5, atol=1e-4)
    assert_topk_match(want[3], want[4], got[3], got[4], rtol=1e-5, atol=1e-5)
    assert set(want[5]) == set(got[5])
    for key, v in want[5].items():
        if key == "ici_bytes_per_query":
            assert got[5][key] == float(v)
        else:
            assert int(got[5][key]) == int(v), key


def test_csr_engine_matches_jax_and_the_dense_engine():
    """Budget n covers every bucket: the csr engine equals JAX's and the
    port's single-chip dense-mask engine, nothing dropped, and the merge
    traffic S * P * 4 * (c + 3) bytes a query."""
    n, c, q = 8 * 16, 12, 24
    nr, nk, nm = _ratings(n, c, seed=1)
    qr, qk, qm = _ratings(q, c, seed=2)
    want, got = run_both("sharded_recommend_csr", nr, nm, qr, qk, qm, "cosine", 4, 4,
                         budget=n, top_p=6, top_n=3)
    assert_cf_match(want, got)
    stats = got[5]
    assert int(stats["budget_dropped"]) == 0 and int(stats["window_dropped"]) == 0
    assert int(stats["unique_candidates"]) > 0
    assert stats["ici_bytes_per_query"] == 8 * 6 * 4 * (c + 3)
    # the port's single-chip engine on the same hyperplanes
    fam = port_family(jsi.build_sharded_index(
        JMESH, KEY, jsi.shard_corpus(JMESH, jnp.asarray(nr)), "cosine", 4, 4).family, "cosine")
    local = build_index(None, torch.from_numpy(nr), "cosine", 4, 4, family=fam)
    queries = RatingSet(*map(torch.from_numpy, (qr, qk, qm)))
    single = recommend(queries, RatingSet(*map(torch.from_numpy, (nr, nk, nm))),
                       candidate_mask(local, queries.ratings), top_p=6, top_n=3)
    np.testing.assert_allclose(to_np(got[0]), to_np(single.predicted), atol=1e-4)
    np.testing.assert_array_equal(to_np(got[1]), to_np(single.top_n))
    np.testing.assert_array_equal(to_np(got[2]), to_np(single.has_neighbors))


def test_csr_engine_reports_truncation():
    """A starving budget is counted (budget_dropped), exactly as JAX counts."""
    n, c, q = 8 * 16, 12, 24
    nr, _, nm = _ratings(n, c, seed=1)
    qr, qk, qm = _ratings(q, c, seed=2)
    want, got = run_both("sharded_recommend_csr", nr, nm, qr, qk, qm, "cosine", 2, 4,
                         budget=4, top_p=4, top_n=3)
    assert_cf_match(want, got)
    assert int(got[5]["budget_dropped"]) > 0
    assert int(got[5]["unique_candidates"]) > int(got[5]["budget_dropped"])


def test_csr_engine_euclidean_detailed():
    """Euclidean tables: the fingerprint filter; known cells keep their
    ratings and the global ids stay in range."""
    n, c, q = 8 * 16, 10, 16
    nr, _, nm = _ratings(n, c, seed=5)
    qr, qk, qm = _ratings(q, c, seed=6)
    want, got = run_both("sharded_recommend_csr", nr, nm, qr, qk, qm, "euclidean", 3, 4,
                         build_kw=dict(lsh_bucket_div=4, euclidean_h_w=4.0),
                         budget=64, top_p=6, top_n=3)
    assert_cf_match(want, got)
    assert bool(got[2].any())
    np.testing.assert_allclose(to_np(got[0])[qk], qr[qk], atol=1e-6)
    g = to_np(got[4])
    assert g.max() < n and (g[g >= 0] >= 0).all()


@pytest.mark.parametrize("metric,dtype,seeds", [
    ("cosine", "float32", (9, 12, 11)),      # test_sharded_recommend_scored_kernel_engine
    ("cosine", "int8", (19, 22, 21)),        # ..._scored_int8_dequant
    ("euclidean", "float32", (29, 32, 31)),  # ..._scored_euclidean_augmented
])
def test_scored_engine_matches_jax(metric, dtype, seeds):
    """Per shard K1 (mask off) and slab_topk's per-table stage 1, the
    shard's own int8 dequant, or the augmented rank and an exact cosine
    rescore; the planted twin leads, known cells keep their ratings."""
    n, c, q = 8 * 64, 128, 16 if seeds[0] == 9 else 12
    nr, nm, qr, qk, qm, target = _twins(n, c, q, *seeds)
    augment = metric == "euclidean"
    want, got = run_both(
        "sharded_recommend_scored", nr, nm, qr, qk, qm, metric, 3, 4,
        pack=dict(dtype=dtype, augment=augment),
        build_kw=dict(lsh_bucket_div=4, euclidean_h_w=8.0) if augment else None,
        top_p=6, top_n=3, per_table=64)
    assert_cf_match(want, got)
    assert bool(got[2].all())
    np.testing.assert_array_equal(to_np(got[4])[:, 0], target)
    s = to_np(got[3])
    assert np.abs(s[:, 0] - 1.0).max() < (0.05 if dtype == "int8" else 1e-3)
    assert (np.diff(np.where(np.isfinite(s), s, -1e9), axis=1) <= 1e-6).all()
    np.testing.assert_allclose(to_np(got[0])[qk], qr[qk], atol=1e-6)
    assert int(got[5]["scanned_total"]) > 0
    if metric == "cosine" and dtype == "float32":
        assert int(got[5]["window_dropped_total"]) == 0


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_scored_engine_ties_match_jax(dtype):
    """Each user a copy of one of 4 distinct rows, queries copies too: each
    shard's windows hold ~16 exactly tied copies of a query's row, and the
    per-window stage 1 (S1, `window_topk`) keeps the lowest 6 lanes as
    JAX's `approx_max_k` does off the TPU: neighbour ids exactly JAX's."""
    rng = np.random.default_rng(41)
    n, c, q = 8 * 64, 128, 12
    br, bk, bm = _ratings(4, c, seed=42)
    pick = rng.integers(0, 4, n)
    nr, nm = br[pick], bm[pick]
    rows = rng.choice(n, size=q, replace=False)
    qr, qk, qm = nr[rows].copy(), bk[pick[rows]].copy(), nm[rows].copy()
    want, got = run_both("sharded_recommend_scored", nr, nm, qr, qk, qm, "cosine", 3, 4,
                         pack=dict(dtype=dtype), top_p=6, top_n=3, per_table=64)
    np.testing.assert_array_equal(to_np(got[4]), np.asarray(want[4]))
    assert_cf_match(want, got)
    assert (to_np(got[4]) >= 0).all()
