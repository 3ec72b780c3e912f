"""ops/distances.blocked_pairwise_distances and ops/oracle's exact k-NN
(resident and streamed from a host corpus): the port against the JAX
package on the same numpy inputs.

Distances: atol 1e-5 (f32 products).  Ids: exact.  The tie cases use
small-integer rows, whose dot products and squared norms are exact in f32,
so duplicate rows give bit-equal distances on both sides and the order
among them is the selection's alone: lowest index first, as `lax.top_k`.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.ops import distances as jax_dist
from crypto_rec_tpu.ops import oracle as jax_oracle
from crypto_rec_tpu_torch.ops import distances, oracle

METRICS = ["cosine", "euclidean"]


@pytest.mark.parametrize("metric", METRICS)
def test_blocked_pairwise_distances_match_jax(metric):
    """JAX's test_blocked_matches_unblocked point: [130, 8] x [17, 8] in
    blocks of 32 rows (the last block short)."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(130, 8)).astype(np.float32)
    b = rng.normal(size=(17, 8)).astype(np.float32)
    want = np.asarray(jax_dist.blocked_pairwise_distances(
        jnp.asarray(a), jnp.asarray(b), metric, block_rows=32))
    got = distances.blocked_pairwise_distances(torch.from_numpy(a), torch.from_numpy(b),
                                               metric, block_rows=32)
    assert got.shape == (130, 17) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    full = distances.pairwise_distances(torch.from_numpy(a), torch.from_numpy(b), metric)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5)


@pytest.mark.parametrize("metric", METRICS)
def test_exact_nearest_streamed_matches_jax_and_resident(metric):
    """JAX's test_exact_nearest_streamed_matches_resident point: [1000, 24]
    streamed in slices of 256 rows (the last one short)."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(1000, 24)).astype(np.float32)
    q = rng.normal(size=(33, 24)).astype(np.float32)
    wd, wi = jax_oracle.exact_nearest_streamed(jnp.asarray(q), x, metric, 7,
                                               corpus_block=256)
    gd, gi = oracle.exact_nearest_streamed(torch.from_numpy(q), x, metric, 7,
                                           corpus_block=256)
    rd, ri = oracle.exact_nearest(torch.from_numpy(q), torch.from_numpy(x), metric, 7,
                                  block_rows=16)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gi.numpy(), ri.numpy())
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)
    np.testing.assert_allclose(gd.numpy(), rd.numpy(), atol=1e-5)


def _tied(seed, n, d=12, distinct=40, q=9):
    """n integer rows drawn from `distinct` patterns (every pattern repeats,
    across any slicing), and q integer queries."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-2, 3, size=(distinct, d)).astype(np.float32)
    base[0] = 1.0                                    # no zero row (cosine)
    x = base[rng.integers(0, distinct, size=n)]
    x[x.sum(1) == 0] += 1.0
    qs = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    qs[:3] = x[[5, 250, 300]]                        # queries on duplicated rows
    return x, qs


def _lowest_first(dists, k):
    """The k smallest of each row of a full [q, n] matrix, equal values
    lowest index first."""
    return np.argsort(dists, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("metric", METRICS)
def test_exact_nearest_ties_go_to_the_lower_index(metric):
    """Duplicate corpus rows (the oracle's `torch.topk` site): the port's
    ids equal JAX's `lax.top_k` order exactly, the lowest duplicates first."""
    x, qs = _tied(1, 700)
    wd, wi = jax_oracle.exact_nearest(jnp.asarray(qs), jnp.asarray(x), metric, 12,
                                      block_rows=4)
    gd, gi = oracle.exact_nearest(torch.from_numpy(qs), torch.from_numpy(x), metric, 12,
                                  block_rows=4)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)
    full = distances.pairwise_distances(torch.from_numpy(qs), torch.from_numpy(x), metric)
    np.testing.assert_array_equal(gi.numpy(), _lowest_first(full.numpy(), 12))
    # the ties are real: most queries cut a run of equal distances
    assert int((gd[:, -1] == gd[:, -2]).sum()) >= 6


@pytest.mark.parametrize("metric", METRICS)
def test_exact_nearest_streamed_ties_straddle_slices(metric):
    """Duplicates spread over every 256-row slice: the running merge keeps
    the best-so-far first, so the ids equal JAX's streamed oracle, the
    resident oracle and the lowest-index-first reference."""
    x, qs = _tied(2, 1000)
    assert len({tuple(r) for r in x[240:260]} & {tuple(r) for r in x[260:290]}) > 0
    wd, wi = jax_oracle.exact_nearest_streamed(jnp.asarray(qs), x, metric, 10,
                                               corpus_block=256)
    gd, gi = oracle.exact_nearest_streamed(torch.from_numpy(qs), x, metric, 10,
                                           corpus_block=256)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-5)
    _, ri = oracle.exact_nearest(torch.from_numpy(qs), torch.from_numpy(x), metric, 10)
    np.testing.assert_array_equal(gi.numpy(), ri.numpy())
    full = distances.pairwise_distances(torch.from_numpy(qs), torch.from_numpy(x), metric)
    np.testing.assert_array_equal(gi.numpy(), _lowest_first(full.numpy(), 10))
    # the winners of queries on duplicated rows span several slices
    assert any(len(set(r // 256)) > 1 for r in gi.numpy()[:3])
