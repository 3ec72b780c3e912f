"""The clustering driver (`models/cluster/driver.cluster`) and the cluster
CLI against the JAX package's.

JAX's draws are handed over: the initial rows (k-means++ or random, from
the first half of JAX's key split) and the assignment's index (LSH tables
or hypercube, from the second half) as arrays.  Labels must be equal
exactly for every combination `tests/test_cluster_driver.py` runs, the
centroids within rtol 1e-5, PAM's iteration counts equal.  k-means stops
earlier in the port: JAX measures a centroid's move as the expanded
|a|^2 + |b|^2 - 2 a.b, which cancellation keeps above min_dist for an
unmoved centroid (a gap in the reference package on record in ROADMAP
Queue 3); the port's |new - old| reads 0, and the centroids it stops at
are the ones JAX keeps.  The CLI's
output file must equal JAX's line for line, the `clustering_time:` line
aside: its points lie on a 1/64 grid, so every member sum is exact in f32
and both packages' centroids are the correctly rounded means.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu import cluster_cli as jax_cli
from crypto_rec_tpu.models.cluster import driver as jax_driver
from crypto_rec_tpu.models.cluster.init import kmeans_pp_init, random_init
from crypto_rec_tpu.models.lsh import hypercube as jax_cube
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu_torch import cluster_cli
from crypto_rec_tpu_torch.models.cluster import driver
from crypto_rec_tpu_torch.models.lsh import hypercube as port_cube
from crypto_rec_tpu_torch.models.lsh import index as port_index

from _torch_parity import cube_handover, handover

CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(17)


def _blobs(seed, n_per=30, k=3, d=6, spread=0.05):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 5
    pts = np.concatenate(
        [c + spread * rng.normal(size=(n_per, d)).astype(np.float32) for c in centers])
    return pts, np.repeat(np.arange(k), n_per)


def jax_draws(key, x, k, metric, init, assignment, lsh_k, lsh_l, lsh_bucket_div,
              euclidean_h_w):
    """The draws JAX's cluster() makes from `key`, as the port's arguments:
    init_idx, and index / hypercube built from JAX's arrays."""
    kinit, kindex = jax.random.split(key)
    xj = jnp.asarray(x)
    idx = (kmeans_pp_init(kinit, xj, k, metric) if init == "kmeans++"
           else random_init(kinit, x.shape[0], k))
    kw = dict(init_idx=torch.from_numpy(np.asarray(idx).astype(np.int64)))
    if assignment == "lsh":
        j = jax_index.build_index(kindex, xj, metric, lsh_k, lsh_l, lsh_bucket_div,
                                  euclidean_h_w)
        kw["index"] = port_index.index_from_numpy(*handover(j), CPU)
    elif assignment == "cube":
        j = jax_cube.build_hypercube(kindex, xj, metric, lsh_k, euclidean_h_w)
        kw["hypercube"] = port_cube.hypercube_from_numpy(*cube_handover(j), CPU)
    return kw


def _compare(want, got, update):
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-6)
    if update == "pam":
        assert got.iterations == int(want.iterations)
    else:
        assert 1 <= got.iterations <= int(want.iterations)


@pytest.mark.parametrize("init", ["kmeans++", "random"])
@pytest.mark.parametrize("assignment", ["lloyd", "lsh", "cube"])
@pytest.mark.parametrize("update", ["kmeans", "pam"])
def test_cluster_matches_jax_on_its_draws(init, assignment, update):
    x, _ = _blobs(13)
    kw = dict(init=init, assignment=assignment, update=update, max_iterations=15,
              min_dist=0.001, lsh_k=4, lsh_l=4, euclidean_h_w=4.0, probes=8)
    want = jax_driver.cluster(KEY, jnp.asarray(x), 3, "euclidean", **kw)
    draws = jax_draws(KEY, x, 3, "euclidean", init, assignment, 4, 4, 4, 4.0)
    got = driver.cluster(None, torch.from_numpy(x), 3, "euclidean", **kw, **draws)
    _compare(want, got, kw["update"])


def test_cosine_lsh_combination_matches_jax():
    x, true = _blobs(14, d=8)
    kw = dict(init="kmeans++", assignment="lsh", update="kmeans", max_iterations=15,
              lsh_k=5, lsh_l=6)
    want = jax_driver.cluster(KEY, jnp.asarray(x), 3, "cosine", **kw)
    draws = jax_draws(KEY, x, 3, "cosine", "kmeans++", "lsh", 5, 6, 4, 0.5)
    got = driver.cluster(None, torch.from_numpy(x), 3, "cosine", **kw, **draws)
    _compare(want, got, kw["update"])
    for c in range(3):
        assert len(set(got.labels.numpy()[true == c].tolist())) == 1


@pytest.mark.parametrize("assignment", ["lloyd", "lsh", "cube"])
def test_own_draws_recover_the_blobs(assignment):
    """No handover: the port's generator draws; k-means++ seeding puts every
    blob in one cluster, and one seed gives one result."""
    x, true = _blobs(15)
    kw = dict(init="kmeans++", assignment=assignment, update="kmeans", max_iterations=15,
              min_dist=0.001, lsh_k=4, lsh_l=4, euclidean_h_w=4.0, probes=8)
    runs = [driver.cluster(torch.Generator().manual_seed(2), torch.from_numpy(x), 3,
                           "euclidean", **kw) for _ in range(2)]
    labels = runs[0].labels.numpy()
    assert torch.equal(runs[0].labels, runs[1].labels)
    for c in range(3):
        assert len(set(labels[true == c].tolist())) == 1
    with pytest.raises(ValueError):
        driver.cluster(torch.Generator(), torch.from_numpy(x), 3, "euclidean",
                       assignment="nope")


def _vectors_file(path, seed, n=240, d=10, k=4):
    """Blobs on a 1/64 grid, written as "id,v1,...": member sums are exact
    in f32, so both packages' means round alike."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(-160, 160, size=(k, d))
    pts = (centers[rng.integers(0, k, n)] + rng.integers(-12, 13, size=(n, d))) / 64.0
    with open(path, "w") as f:
        for i, row in enumerate(pts.astype(np.float32)):
            f.write(",".join([f"v{i}"] + [repr(float(v)) for v in row]) + "\n")
    return str(path)


def _without_time(path):
    return [l for l in open(path).read().splitlines() if not l.startswith("clustering_time:")]


@pytest.mark.parametrize("args", [
    ["--clusters", "4", "--metric", "cosine"],
    ["--clusters", "4", "--metric", "euclidean", "--assignment", "lsh"],
    ["--clusters", "4", "--metric", "euclidean", "--assignment", "cube", "--update", "pam",
     "--complete"],
    ["--clusters", "3", "--metric", "euclidean", "--init", "random", "--seed", "5"],
], ids=["cosine-lloyd", "lsh", "cube-pam-complete", "random"])
def test_cluster_cli_writes_jax_file(tmp_path, monkeypatch, args):
    vec = _vectors_file(tmp_path / "v.csv", seed=len(args))
    assert jax_cli.main(["-i", vec, "-o", str(tmp_path / "jax.txt"), *args]) == 0
    real = driver.cluster

    def with_jax_draws(generator, x, k, metric, **kw):
        seed = int(args[args.index("--seed") + 1]) if "--seed" in args else 0
        draws = jax_draws(jax.random.PRNGKey(seed), x.numpy(), k, metric, kw["init"],
                          kw["assignment"], kw["lsh_k"], kw["lsh_l"],
                          kw["lsh_bucket_div"], kw["euclidean_h_w"])
        return real(generator, x, k, metric, **kw, **draws)

    monkeypatch.setattr(driver, "cluster", with_jax_draws)
    assert cluster_cli.main(["-i", vec, "-o", str(tmp_path / "port.txt"), *args,
                             "--device", "cpu"]) == 0
    want, got = _without_time(tmp_path / "jax.txt"), _without_time(tmp_path / "port.txt")
    assert got == want
    assert sum(l.startswith("CLUSTER-") for l in got) == int(args[1])


def test_cluster_cli_errors(tmp_path, monkeypatch):
    assert cluster_cli.main(["-i", str(tmp_path / "nope.csv"), "-o",
                             str(tmp_path / "o.txt"), "--device", "cpu"]) == 1
    vec = _vectors_file(tmp_path / "v.csv", seed=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cluster_cli.main(["-i", vec, "-o", str(tmp_path / "o.txt")]) == 2
    assert not (tmp_path / "o.txt").exists()
