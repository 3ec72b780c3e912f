"""Clustering parity: the port's init, assignment, update, silhouette and
k-means loop against the JAX package's on the same numpy points.

JAX's random draws (k-means++ first row and uniforms, random_init's rows)
are handed over, so picks and labels must match exactly (labels away from
a tie of two centroid distances within 1e-5); centroids within rtol 1e-5,
silhouettes (values in [-1, 1]) within 1e-5; iteration counts equal.
Distances come from |a|^2 + |b|^2 - 2 a.b in f32 on both sides, whose
rounding differs with the summation order: squared distances are compared
within 8 f32 epsilons of |a|^2 + |b|^2.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu.models.cluster import assign as jax_assign
from crypto_rec_tpu.models.cluster import init as jax_init
from crypto_rec_tpu.models.cluster import update as jax_update
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu_torch.models.cluster import assign, init, kmeans, silhouette, update
from crypto_rec_tpu_torch.models.lsh import index as port_index

from _torch_parity import handover

# the JAX package's cluster/__init__ re-exports functions under the names
# of these two modules
jax_kmeans = importlib.import_module("crypto_rec_tpu.models.cluster.kmeans")
jax_sil = importlib.import_module("crypto_rec_tpu.models.cluster.silhouette")

N, D, K = 300, 6, 5
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(5)
    centers = 3.0 * rng.normal(size=(K, D))
    x = (centers[rng.integers(0, K, N)] + rng.normal(size=(N, D))).astype(np.float32)
    return x


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _assert_labels(got_labels, want_labels, x, centroids, metric):
    """Labels equal wherever the two nearest centroids are not tied within
    1e-5 of the nearest distance."""
    from crypto_rec_tpu_torch.ops.distances import pairwise_distances

    d = pairwise_distances(_t(x), _t(centroids), metric).numpy()
    d.sort(axis=1)
    clear = d[:, 1] - d[:, 0] > 1e-5 * np.maximum(d[:, 0], 1.0)
    got, want = np.asarray(got_labels), np.asarray(want_labels)
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() > 0.95


def _assert_dists(got, want, x, c):
    """Squared distances within 8 eps (max |x|^2 + max |c|^2); inf equal."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    tol = 8 * np.finfo(np.float32).eps * (np.square(x).sum(1).max()
                                           + np.square(c).sum(1).max())
    np.testing.assert_allclose(got[fin] ** 2, want[fin] ** 2, rtol=0, atol=tol)


def _jax_pp_draws(key, n, k):
    """The draws kmeans_pp_init makes from `key`, in its order."""
    key, kfirst = jax.random.split(key)
    first = int(jax.random.randint(kfirst, (), 0, n))
    u = []
    for _ in range(1, k):
        key, kdraw = jax.random.split(key)
        u.append(float(jax.random.uniform(kdraw, ())))
    return first, torch.tensor(u, dtype=torch.float32)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_kmeans_pp_init_matches_jax_with_its_draws(points, metric):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_init.kmeans_pp_init(key, jnp.asarray(points), K, metric))
    first, u = _jax_pp_draws(key, N, K)
    got = init.kmeans_pp_from_draws(_t(points), K, metric, first, u)
    np.testing.assert_array_equal(got.numpy(), want)
    # the drawing form: same seed, same picks; k distinct rows
    a = init.kmeans_pp_init(torch.Generator().manual_seed(3), _t(points), K, metric)
    b = init.kmeans_pp_init(torch.Generator().manual_seed(3), _t(points), K, metric)
    assert torch.equal(a, b) and len(set(a.tolist())) == K


def test_random_init_draws_distinct_rows():
    idx = init.random_init(torch.Generator().manual_seed(1), 50, 7)
    assert idx.shape == (7,) and len(set(idx.tolist())) == 7
    assert int(idx.min()) >= 0 and int(idx.max()) < 50
    want = np.asarray(jax_init.random_init(jax.random.PRNGKey(2), 50, 7))
    assert len(set(want.tolist())) == 7


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_lloyd_assign_and_for_remaining_match_jax(points, metric):
    c = points[[3, 90, 150, 201, 299]]
    jl, jd = jax_assign.lloyd_assign(jnp.asarray(points), jnp.asarray(c), metric)
    pl, pd = assign.lloyd_assign(_t(points), _t(c), metric)
    _assert_labels(pl, jl, points, c, metric)
    assert pl.dtype == torch.int32
    if metric == "euclidean":
        _assert_dists(pd, jd, points, c)
    else:
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
    labels = np.where(np.arange(N) % 3 == 0, -1, np.arange(N) % K).astype(np.int32)
    dists = np.full(N, 7.0, np.float32)
    jl, jd = jax_assign.lloyd_for_remaining(jnp.asarray(points), jnp.asarray(c),
                                            jnp.asarray(labels), jnp.asarray(dists), metric)
    pl, pd = assign.lloyd_for_remaining(_t(points), _t(c), _t(labels), _t(dists), metric)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    if metric == "euclidean":
        _assert_dists(pd, jd, points, c)
    else:
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)


def test_range_assign_matches_jax_with_unreached_points(points):
    c = points[[3, 90, 150, 201, 299]]
    rng = np.random.default_rng(1)
    cand = rng.random((K, N)) < 0.6
    cand[:, :20] = False                         # never reached: label -1
    args = (points, c, cand)
    jl, jd = jax_assign.range_assign(*map(jnp.asarray, args), "euclidean")
    pl, pd = assign.range_assign(*map(_t, args), "euclidean")
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert (pl[:20] == -1).all() and torch.isinf(pd[:20]).all()
    _assert_dists(pd, jd, points, c)
    # max_rounds cuts the doubling: one round reaches only the first window
    jl1, _ = jax_assign.range_assign(*map(jnp.asarray, args), "euclidean", max_rounds=1)
    pl1, _ = assign.range_assign(*map(_t, args), "euclidean", max_rounds=1)
    np.testing.assert_array_equal(pl1.numpy(), np.asarray(jl1))
    assert int((pl1 == -1).sum()) > 20


def test_index_range_assign_matches_jax(points):
    """The reverse assignment from an LSH index's unfiltered candidate mask
    (centroids as queries), the JAX index handed over."""
    c = points[[3, 90, 150, 201, 299]]
    jidx = jax_index.build_index(jax.random.PRNGKey(4), jnp.asarray(points), "euclidean",
                                 k=3, L=4, lsh_bucket_div=4, euclidean_h_w=4.0)
    pidx = port_index.index_from_numpy(*handover(jidx), CPU)
    jmask = jax_index.candidate_mask(jidx, jnp.asarray(c), filtered=False)
    pmask = port_index.candidate_mask(pidx, _t(c), filtered=False)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    jl, jd = jax_assign.index_range_assign(jnp.asarray(points), jnp.asarray(c), jmask,
                                           "euclidean")
    pl, pd = assign.index_range_assign(_t(points), _t(c), pmask, "euclidean")
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    assert (pl >= 0).all()
    _assert_dists(pd, jd, points, c)


@pytest.mark.parametrize("min_dist,cont", [(1e-3, True), (1e3, False)])
def test_kmeans_update_matches_jax(points, min_dist, cont):
    """Cluster 2 is empty (keeps its centroid); cont both ways (all
    centroids move, or none)."""
    labels = (np.arange(N) % K).astype(np.int32)
    labels[labels == 2] = 0
    old = points[[3, 90, 150, 201, 299]] + 0.5
    jc, jcont = jax_update.kmeans_update(jnp.asarray(points), jnp.asarray(labels),
                                         jnp.asarray(old), K, "euclidean", min_dist)
    pc, pcont = update.kmeans_update(_t(points), _t(labels), _t(old), K, "euclidean",
                                     min_dist)
    assert bool(pcont) == bool(jcont) == cont
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pc[2].numpy(), old[2])
    if not cont:
        np.testing.assert_array_equal(pc.numpy(), old)


def test_pam_update_matches_jax_and_breaks_ties_to_the_lowest_row(points):
    x = points.copy()
    x[40] = x[10]          # rows 10 and 40: the same point, the same cost
    labels = (np.arange(N) % K).astype(np.int32)
    medoids = np.array([5, 6, 7, 8, 9], np.int32)
    for metric in ("euclidean", "cosine"):
        jm, js = jax_update.pam_update(jnp.asarray(x), jnp.asarray(labels),
                                       jnp.asarray(medoids), K, metric, block_rows=64)
        pm, ps = update.pam_update(_t(x), _t(labels), _t(medoids), K, metric,
                                   block_rows=64)
        np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
        assert bool(ps) == bool(js)
    # a cluster of two identical points: its medoid is the lower row
    lab2 = np.where(np.isin(np.arange(N), [10, 40]), 4, labels % 4).astype(np.int32)
    pm, _ = update.pam_update(_t(x), _t(lab2), _t(medoids), K, "euclidean")
    jm, _ = jax_update.pam_update(jnp.asarray(x), jnp.asarray(lab2), jnp.asarray(medoids),
                                  K, "euclidean")
    assert int(pm[4]) == int(jm[4]) == 10


def test_silhouette_matches_jax(points):
    c = points[[3, 90, 150, 201, 299]]
    labels, _ = assign.lloyd_assign(_t(points), _t(c), "euclidean")
    for metric in ("euclidean", "cosine"):
        want = jax_sil.silhouette(jnp.asarray(points), jnp.asarray(labels.numpy()),
                                  jnp.asarray(c), K, metric, block_rows=128)
        got = silhouette.silhouette(_t(points), labels, _t(c), K, metric, block_rows=128)
        assert got.shape == (K + 1,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("init_kind,metric", [("random", "euclidean"),
                                              ("kmeans++", "cosine")])
def test_kmeans_matches_jax_from_the_same_init(points, init_kind, metric):
    key = jax.random.PRNGKey(11)
    want = jax_kmeans.kmeans(key, jnp.asarray(points), K, metric, 30, 1e-4, init=init_kind)
    idx = (jax_init.random_init(key, N, K) if init_kind == "random"
           else jax_init.kmeans_pp_init(key, jnp.asarray(points), K, metric))
    got = kmeans.kmeans(None, _t(points), K, metric, 30, 1e-4,
                        init_idx=_t(np.asarray(idx)))
    assert got.iterations == int(want.iterations) > 1
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-6)
    _assert_labels(got.labels, want.labels, points, np.asarray(want.centroids), metric)
    if metric == "euclidean":
        _assert_dists(got.dists, want.dists, points, np.asarray(want.centroids))
    else:
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists), rtol=0,
                                   atol=1e-6)
    again = kmeans.kmeans(torch.Generator().manual_seed(0), _t(points), K, metric, 30,
                          1e-4, init=init_kind)
    assert again.labels.shape == (N,) and again.centroids.shape == (K, D)
    with pytest.raises(ValueError):
        kmeans.kmeans(torch.Generator(), _t(points), K, metric, init="bogus")
