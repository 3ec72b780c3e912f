"""Tie order of the port's top-k primitives against JAX's `lax.top_k`:
exact ties planted in values (repeated values, rows of equal scores, -inf
masks, k above the axis), indices compared exactly — lowest index first
among equal values, on every device (the card's form is in
tests/test_torch_cuda.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.ops import topk as jax_topk
from crypto_rec_tpu_torch.ops import topk


def _tied(seed, shape, levels):
    """Values drawn from a few levels, so most rows hold exact ties."""
    rng = np.random.default_rng(seed)
    return rng.choice(np.linspace(-1.0, 1.0, levels).astype(np.float32), size=shape)


@pytest.mark.parametrize("m", [64, 5000])
@pytest.mark.parametrize("levels", [1, 3, 17])
@pytest.mark.parametrize("k", [1, 5, 64])
def test_topk_desc_breaks_ties_like_lax_top_k(levels, k, m):
    v = _tied(levels + m, (40, m), levels)
    wv, wi = jax_topk.topk_desc(jnp.asarray(v), k)
    gv, gi = topk.topk_desc(torch.from_numpy(v), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("m", [24, 5000])
def test_topk_desc_orders_zeros_nans_and_infs_as_a_stable_sort(m):
    """Signed zeros, NaNs, infinities and denormals: the order of a stable
    descending sort (NaN first, +0.0 and -0.0 equal, so lowest index
    first); lax.top_k agrees wherever no NaN or signed zero decides."""
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-45, 1.0],
                       np.float32)
    v = np.random.default_rng(m).choice(special, size=(16, m))
    nan = np.isnan(v)
    want = np.stack([np.lexsort((np.arange(m), -np.where(n, np.inf, r), ~n))
                     for r, n in zip(v, nan)])[:, :20]
    gv, gi = topk.topk_desc(torch.from_numpy(v), 20)
    np.testing.assert_array_equal(gi.numpy(), want)
    np.testing.assert_array_equal(gv.numpy(), np.take_along_axis(v, want, 1))
    plain = np.where(nan | (v == 0), 0.5, v).astype(np.float32)
    wv, wi = jax_topk.topk_desc(jnp.asarray(plain), 20)
    np.testing.assert_array_equal(topk.topk_desc(torch.from_numpy(plain), 20)[1].numpy(),
                                  np.asarray(wi))


@pytest.mark.parametrize("k", [3, 20])
def test_masked_topk_and_topn_break_ties_like_jax(k):
    v = _tied(4, (32, 20), 4)
    mask = np.random.default_rng(5).random((32, 20)) < 0.7
    mask[0] = False                                  # an empty row
    wv, wi, wok = jax_topk.masked_topk_desc(jnp.asarray(v), jnp.asarray(mask), k)
    gv, gi, gok = topk.masked_topk_desc(torch.from_numpy(v), torch.from_numpy(mask), k)
    np.testing.assert_array_equal(gok.numpy(), np.asarray(wok))
    np.testing.assert_array_equal(gi.numpy()[gok.numpy()], np.asarray(wi)[np.asarray(wok)])
    np.testing.assert_array_equal(
        topk.topn_indices(torch.from_numpy(v), torch.from_numpy(mask), k).numpy(),
        np.asarray(jax_topk.topn_indices(jnp.asarray(v), jnp.asarray(mask), k)))


def test_padded_topk_keeps_every_candidate_past_the_axis():
    """k above the axis: JAX raises; the port pads with -inf at index 0
    after the lowest-index-first order of the real slots."""
    v = torch.tensor([[0.5, 0.5, 1.0]])
    vals, idx, ok = topk.masked_topk_desc(v, torch.ones_like(v, dtype=torch.bool), 5)
    assert idx.tolist() == [[2, 0, 1, 0, 0]] and ok.tolist() == [[True] * 3 + [False] * 2]
    assert torch.isinf(vals[0, 3:]).all()
