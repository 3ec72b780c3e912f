"""IVF (models/ivf.py) against the JAX package, with JAX's k-means++ initial
rows handed over: centroids within rtol 1e-5, labels-derived tables
(capacity, dropped_rows, block_rows) exact, each cluster's row_ids equal
as a set (JAX's cluster sort is not stable by contract), blocks equal row
for row under the row ids, and retrieval ids equal wherever scores are not
tied, scores within rtol 1e-5 / atol 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.models.cluster.init import kmeans_pp_init
from crypto_rec_tpu.models.ivf import build_ivf as jax_build, ivf_retrieve_topk as jax_ret
from crypto_rec_tpu_torch.models.ivf import build_ivf, ivf_retrieve_topk

from _torch_parity import assert_topk_match, to_np

KEY = jax.random.PRNGKey(33)


def _clustered(seed, n, d, n_centers, spread=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * 4
    return (centers[rng.integers(0, n_centers, size=n)]
            + spread * rng.normal(size=(n, d)).astype(np.float32)).astype(np.float32)


CASES = {
    "euclidean-full": dict(n=512, d=16, centers=8, K=8, metric="euclidean", kw={}),
    "cosine-train": dict(n=2000, d=24, centers=32, K=32, metric="cosine",
                         kw=dict(max_iterations=8, train_rows=512)),
    "cosine-bf16": dict(n=1500, d=12, centers=16, K=16, metric="cosine",
                        kw=dict(block_dtype="bfloat16")),
    "euclidean-overflow": dict(n=900, d=8, centers=3, K=12, metric="euclidean",
                               kw=dict(capacity=48)),
}


@pytest.fixture(scope="module", params=list(CASES))
def built(request):
    c = CASES[request.param]
    x = _clustered(len(request.param), c["n"], c["d"], c["centers"])
    kw = dict(c["kw"])
    jkw = dict(kw, block_dtype=jnp.bfloat16) if "block_dtype" in kw else kw
    pkw = dict(kw, block_dtype=torch.bfloat16) if "block_dtype" in kw else kw
    want = jax_build(KEY, jnp.asarray(x), c["K"], c["metric"], **jkw)
    train_rows = kw.get("train_rows", 0)
    train = x[:train_rows] if 0 < train_rows < c["n"] else x
    init = np.asarray(kmeans_pp_init(KEY, jnp.asarray(train), c["K"], c["metric"]))
    got = build_ivf(None, torch.from_numpy(x), c["K"], c["metric"],
                    init_idx=torch.from_numpy(init.astype(np.int64)), **pkw)
    return dict(x=x, want=want, got=got, c=c)


def test_build_ivf_matches_jax(built):
    want, got = built["want"], built["got"]
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids),
                               rtol=1e-5, atol=1e-5)
    assert (got.capacity, got.dropped_rows, got.n_rows) == \
        (want.capacity, want.dropped_rows, want.n_rows)
    np.testing.assert_array_equal(got.block_rows.numpy(), np.asarray(want.block_rows))
    gi, wi = got.row_ids.numpy(), np.asarray(want.row_ids)
    for c in range(want.n_clusters):
        assert set(gi[c].tolist()) == set(wi[c].tolist()), c
    # each slot holds its row's vector (zero on pads), in the block dtype
    x = built["x"]
    rows = np.where(gi[..., None] >= 0, x[np.maximum(gi, 0)], 0.0)
    blocks = to_np(got.blocks)
    if got.blocks.dtype == torch.bfloat16:
        rows = to_np(torch.from_numpy(rows.astype(np.float32)).to(torch.bfloat16))
    np.testing.assert_array_equal(blocks, rows)
    if built["c"]["kw"].get("capacity"):
        assert got.dropped_rows > 0


@pytest.mark.parametrize("nprobe", [1, 3])
def test_ivf_retrieve_matches_jax(built, nprobe):
    """Both packages retrieve on the port's index layout: JAX's index is
    rebuilt from the port's arrays, so the probe and the scoring are
    compared on the same blocks."""
    from crypto_rec_tpu.models.ivf import IvfIndex

    got = built["got"]
    bdt = jnp.bfloat16 if got.blocks.dtype == torch.bfloat16 else jnp.float32
    jidx = IvfIndex(metric=got.metric, n_clusters=got.n_clusters, capacity=got.capacity,
                    n_rows=got.n_rows, dropped_rows=got.dropped_rows,
                    centroids=jnp.asarray(got.centroids.numpy()),
                    blocks=jnp.asarray(to_np(got.blocks)).astype(bdt),
                    block_rows=jnp.asarray(got.block_rows.numpy()),
                    row_ids=jnp.asarray(got.row_ids.numpy()))
    qs = built["x"][:40]
    want = jax_ret(jidx, jnp.asarray(qs), nprobe=nprobe, top_k=5, q_block=16)
    res = ivf_retrieve_topk(got, torch.from_numpy(qs), nprobe=nprobe, top_k=5, q_block=16)
    assert_topk_match(*want, *res, rtol=1e-5, atol=1e-5)
    assert res[1].dtype == torch.int32
