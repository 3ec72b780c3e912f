"""The csr engine: the port's count-ranked dedup, CSR candidate gathering,
mask form, id-list CF and score-ranked candidate sets against the JAX
package's, on JAX-built indexes handed over with index_from_numpy.

Candidate ids and truncation stats must match exactly; predictions within
rtol 1e-5 / atol 1e-5 (top-n equal away from prediction ties).  The
score-ranked sets are compared as top-k lists with the slab score of each
id (assert_topk_match, rtol 1e-5, atol 1e-5): ids as sets where scores
tie.  JAX's candidate_ids_scored runs its slab kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu.config import RecConfig as JaxRecConfig
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.models.rec import engine as jax_engine
from crypto_rec_tpu.models.rec import pipeline as jax_pipeline
from crypto_rec_tpu_torch.config import RecConfig
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.models.rec import engine as port_engine
from crypto_rec_tpu_torch.models.rec import pipeline as port_pipeline

from _torch_parity import assert_recs_match, assert_topk_match, handover, to_np

N, D, Q = 2048, 128, 40
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    centers = 2.0 * rng.normal(size=(32, D))
    x = (centers[rng.integers(0, 32, N)] + 0.5 * rng.normal(size=(N, D))).astype(np.float32)
    qs = (x[:Q] + 0.2 * rng.normal(size=(Q, D))).astype(np.float32)
    cos = jax_index.build_index(jax.random.PRNGKey(1), jnp.asarray(x), "cosine", k=4, L=4,
                                lsh_bucket_div=4, euclidean_h_w=1.0)
    euc = jax_index.build_index(jax.random.PRNGKey(2), jnp.asarray(x), "euclidean", k=3,
                                L=4, lsh_bucket_div=16, euclidean_h_w=12.0)
    return dict(x=x, qs=qs, cos=cos, euc=euc)


def _jax_dedup(ids, sentinel, budget, n_tables):
    fn = jax.vmap(lambda r: jax_index._dedup_rank_fixed(r, sentinel, budget, n_tables,
                                                        with_count=True))
    return fn(jnp.asarray(ids))


@pytest.mark.parametrize("m", [600, 1 << 16])
def test_dedup_rank_fixed_matches_jax_in_both_branches(m):
    """m < 2^16 takes the int32 key, m = 2^16 the f32 key (stable sort)."""
    rng = np.random.default_rng(m)
    n, L = 5000, 6
    ids = rng.integers(0, 900, size=(3, m)).astype(np.int32)
    ids[ids > 850] = n                               # sentinels
    ids[1, :] = n                                    # a row of sentinels only
    want, wcount = _jax_dedup(ids, n, 256, L)
    got, count = port_index._dedup_rank_fixed(torch.from_numpy(ids), n, 256, L,
                                              with_count=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(count.numpy(), np.asarray(wcount))
    assert got.dtype == torch.int32 and (got[1] == -1).all()


@pytest.mark.parametrize("metric,filtered", [("cosine", True), ("euclidean", True),
                                             ("euclidean", False)])
@pytest.mark.parametrize("per_table", [0, 48])
def test_candidate_ids_and_stats_match_jax(data, metric, filtered, per_table):
    jidx = data[metric[:3]]
    pidx = port_index.index_from_numpy(*handover(jidx), CPU)
    qs = data["qs"]
    want, wstats = jax_index.candidate_ids(jidx, jnp.asarray(qs), budget=96,
                                           filtered=filtered, per_table=per_table,
                                           with_stats=True)
    got, stats = port_index.candidate_ids(pidx, torch.from_numpy(qs), budget=96,
                                          filtered=filtered, per_table=per_table,
                                          with_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(stats) == set(wstats)
    for k in stats:
        np.testing.assert_array_equal(stats[k].numpy(), np.asarray(wstats[k]))
    assert int(stats["budget_dropped"].max()) > 0 or per_table
    plain = port_index.candidate_ids(pidx, torch.from_numpy(qs), budget=96,
                                     filtered=filtered, per_table=per_table)
    assert torch.equal(plain, got)
    # the raw-array core, as the JAX function is called
    qb, qd = port_index.query_hashes(pidx, torch.from_numpy(qs))
    raw = port_index.gather_candidate_ids(
        pidx.sorted_rows, pidx.bucket_starts, pidx.detailed if filtered else None,
        pidx.n_rows, qb, qd, budget=96, per_table=per_table)
    assert torch.equal(raw, got)


def test_mask_from_candidate_ids_matches_jax():
    rng = np.random.default_rng(4)
    ids = rng.integers(-1, 50, size=(7, 12)).astype(np.int32)
    want = jax_index.mask_from_candidate_ids(jnp.asarray(ids), 50)
    got = port_index.mask_from_candidate_ids(torch.from_numpy(ids), 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _sets(x, qs, seed):
    rng = np.random.default_rng(seed)

    def one(r):
        known = rng.random(r.shape) < 0.6
        mean = ((r * known).sum(1) / np.maximum(known.sum(1), 1)).astype(np.float32)
        return np.where(known, r, mean[:, None]).astype(np.float32), known, mean

    return one(x), one(qs)


def test_recommend_from_ids_matches_jax(data):
    nset, qset = _sets(data["x"][:, :24], data["qs"][:, :24], 5)
    rng = np.random.default_rng(6)
    # distinct ids per query (a deduplicated candidate list), -1 pads
    ids = np.stack([rng.permutation(N)[:64] for _ in range(Q)]).astype(np.int32)
    ids[rng.random(ids.shape) < 0.2] = -1
    ids[3] = -1                                       # no candidates at all
    want = jax_engine.recommend_from_ids(
        jax_engine.RatingSet(*map(jnp.asarray, qset)),
        jax_engine.RatingSet(*map(jnp.asarray, nset)), jnp.asarray(ids), top_p=10, top_n=4)
    got = port_engine.recommend_from_ids(
        port_engine.RatingSet(*map(torch.from_numpy, qset)),
        port_engine.RatingSet(*map(torch.from_numpy, nset)), torch.from_numpy(ids),
        top_p=10, top_n=4)
    assert_recs_match(want, got)
    assert not bool(got.has_neighbors[3])
    assert_topk_match(want.sims, want.neighbor_idx, got.sims, got.neighbor_idx,
                      rtol=1e-5, atol=1e-6)


def test_lsh_phase_csr_matches_jax(data):
    """engine="csr" on the same index: the same candidate ids, so the same
    neighbours and predictions; the truncation is logged."""
    nset, qset = _sets(data["x"][:, :32], data["qs"][:, :32], 7)
    cfg = dict(k=4, L=4, engine="csr", candidate_budget=64)
    jcache = {}
    key = jax.random.PRNGKey(9)
    want = jax_pipeline.lsh_phase(
        key, jax_engine.RatingSet(*map(jnp.asarray, qset)),
        jax_engine.RatingSet(*map(jnp.asarray, nset)), JaxRecConfig(**cfg, use_pallas=False),
        top_n=5, top_p=20, index_cache=jcache)
    (jidx,) = jcache.values()
    cache = {(9, "users"): port_index.index_from_numpy(*handover(jidx), CPU)}
    got = port_pipeline.lsh_phase(
        9, port_engine.RatingSet(*map(torch.from_numpy, qset)),
        port_engine.RatingSet(*map(torch.from_numpy, nset)), RecConfig(**cfg),
        top_n=5, top_p=20, index_cache=cache, index_token="users")
    assert_recs_match(want, got)
    assert_topk_match(want.sims, want.neighbor_idx, got.sims, got.neighbor_idx,
                      rtol=1e-5, atol=1e-6)


def _slab_scores(pidx, qv, ids):
    """The slab dot of each returned id: qv . (row id's slab row)."""
    rows = torch.empty(pidx.n_rows, pidx.packed.shape[-1])
    rows[pidx.sorted_rows[0].long()] = pidx.packed[0, :pidx.n_rows].float()
    s = torch.einsum("qd,qkd->qk", qv, rows[torch.clamp(ids, min=0).long()])
    return torch.where(ids >= 0, s, float("-inf"))


@pytest.mark.parametrize("kind", ["int8", "bfloat16", "float32", "euclidean"])
def test_candidate_ids_scored_matches_jax(data, kind):
    """Cosine slabs in three dtypes (scale-free: global int8) and augmented
    euclidean bf16 slabs with fingerprint-run windows."""
    x, qs = jnp.asarray(data["x"]), data["qs"]
    if kind == "euclidean":
        jp = jax_index.pack_index(data["euc"], x, augment=True)
    else:
        jp = jax_index.pack_index(data["cos"], x, dtype=jnp.dtype(kind),
                                  scale_mode="global")
    want = jax_index.candidate_ids_scored(jp, jnp.asarray(qs), budget=64, per_table=100)
    pidx = port_index.index_from_numpy(*handover(jp), CPU)
    q = torch.from_numpy(qs)
    got = port_index.candidate_ids_scored(pidx, q, budget=64, per_table=100)
    assert got.shape == (Q, 64) and got.dtype == torch.int32
    if kind == "euclidean":
        from crypto_rec_tpu_torch.ops.kernels.slabscore import augment_queries

        qv = augment_queries(q, pidx.packed_aug_scale, pidx.packed.shape[-1])
    else:
        qv = torch.nn.functional.normalize(q, dim=1)
    w = torch.from_numpy(np.asarray(want).copy())
    s_want, s_got = _slab_scores(pidx, qv, w), _slab_scores(pidx, qv, got)
    assert bool((s_got[:, :-1] >= s_got[:, 1:]).all())
    assert_topk_match(to_np(s_want), to_np(w), to_np(s_got), to_np(got),
                      rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        port_index.candidate_ids_scored(port_index.index_from_numpy(
            *handover(data["cos"]), CPU), q, budget=64)
