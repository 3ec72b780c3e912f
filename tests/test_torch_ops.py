"""ops/distances, ops/topk and ops/oracle: the port against the JAX package
on the same numpy inputs (f32 products: rtol 1e-5, atol 1e-5)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.ops import distances as jax_dist
from crypto_rec_tpu.ops import oracle as jax_oracle
from crypto_rec_tpu.ops import topk as jax_topk
from crypto_rec_tpu_torch.ops import distances, oracle, topk

RNG = np.random.default_rng(31)
A = RNG.normal(size=(37, 24)).astype(np.float32)
B = RNG.normal(size=(300, 24)).astype(np.float32)


@pytest.mark.parametrize("name", [
    "cosine_similarity_matrix", "cosine_distance_matrix",
    "sq_euclidean_distance_matrix", "euclidean_distance_matrix",
])
def test_distance_matrices_match_jax(name):
    want = np.asarray(getattr(jax_dist, name)(jnp.asarray(A), jnp.asarray(B)))
    got = getattr(distances, name)(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_topk_helpers_match_jax():
    vals = RNG.random((37, 300)).astype(np.float32)     # distinct: no ties
    mask = RNG.random((37, 300)) < 0.02                  # some rows run short
    w = jax_topk.masked_topk_desc(jnp.asarray(vals), jnp.asarray(mask), 8)
    g = topk.masked_topk_desc(torch.from_numpy(vals), torch.from_numpy(mask), 8)
    for a, b in zip(w, g):
        np.testing.assert_array_equal(b.numpy()[np.asarray(w[2])],
                                      np.asarray(a)[np.asarray(w[2])])
    np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
    np.testing.assert_array_equal(
        topk.topn_indices(torch.from_numpy(vals), torch.from_numpy(mask), 8).numpy(),
        np.asarray(jax_topk.topn_indices(jnp.asarray(vals), jnp.asarray(mask), 8)),
    )
    np.testing.assert_array_equal(
        topk.topk_desc(torch.from_numpy(vals), 5)[1].numpy(),
        np.asarray(jax_topk.topk_desc(jnp.asarray(vals), 5)[1]),
    )


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_exact_nearest_and_recall_match_jax(metric):
    wd, wi = jax_oracle.exact_nearest(jnp.asarray(A), jnp.asarray(B), metric, 10,
                                      block_rows=16)
    gd, gi = oracle.exact_nearest(torch.from_numpy(A), torch.from_numpy(B), metric,
                                  10, block_rows=16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5, atol=1e-5)
    got_ids = np.where(RNG.random((37, 10)) < 0.2, -1, np.asarray(wi))
    assert oracle.recall_at_k(torch.from_numpy(got_ids), gi) == pytest.approx(
        float(jax_oracle.recall_at_k(jnp.asarray(got_ids), wi)))


def test_masked_topk_takes_k_above_the_axis_length():
    """The reference keeps every candidate when there are fewer than P
    (crypto_rec.hpp:225-228): slots past the axis are invalid pads, and
    the first slots are the plain top-k."""
    from crypto_rec_tpu_torch.ops.topk import masked_topk_desc, topn_indices

    v = torch.tensor([[0.5, 0.9, 0.1], [0.3, 0.2, 0.8]])
    m = torch.tensor([[True, True, False], [True, True, True]])
    vals, idx, valid = masked_topk_desc(v, m, 5)
    assert vals.shape == idx.shape == valid.shape == (2, 5)
    assert valid.sum(1).tolist() == [2, 3]
    assert idx[0, :2].tolist() == [1, 0] and idx[1, :3].tolist() == [2, 0, 1]
    assert torch.isinf(vals[:, 3:]).all() and (idx[:, 3:] == 0).all()
    assert topn_indices(v, m, 4).tolist() == [[1, 0, -1, -1], [2, 0, 1, -1]]
