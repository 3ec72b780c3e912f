"""Index build, packing and checkpoints: the port against the JAX package
on one corpus, with JAX's hash parameters handed over (cosine here;
euclidean build and packing in tests/test_torch_pstable.py, euclidean
archives here).

CSR tables must be exactly equal.  int8 slab elements may sit one
quantization step off in at most 0.01% of elements (the last bit of a row
norm can move a value across a rounding boundary); bf16 likewise by one
bf16 step.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu import checkpoint as jax_ckpt
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu_torch import checkpoint
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh

from _torch_parity import assert_topk_match, handover, to_np

N, D, K, L = 4096, 128, 5, 5


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(N, D)).astype(np.float32)
    jidx = jax_index.build_index(
        jax.random.PRNGKey(1), jnp.asarray(x), "cosine", k=K, L=L,
        lsh_bucket_div=4, euclidean_h_w=1.0,
    )
    fam = CosineLsh(proj=torch.from_numpy(np.asarray(jidx.family.proj).copy()),
                    k=K, L=L)
    pidx = port_index.build_index(None, torch.from_numpy(x), "cosine", K, L,
                                  family=fam)
    return x, jidx, pidx


def test_build_index_matches_jax(built):
    _, jidx, pidx = built
    assert pidx.n_buckets == jidx.n_buckets and pidx.n_rows == N
    for f in ("bucket_ids", "sorted_rows", "bucket_starts"):
        got, want = getattr(pidx, f), np.asarray(getattr(jidx, f))
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)


def _assert_slabs_close(got: torch.Tensor, want: np.ndarray):
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int64)
        w = want.view(np.int16).astype(np.int64)
    else:
        g, w = got.numpy().astype(np.int64), want.astype(np.int64)
    off = np.abs(g - w)
    assert off.max() <= 1, "slab element more than one step off"
    assert (off > 0).mean() <= 1e-4, f"{(off > 0).mean():.2e} of elements off"


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_pack_index_matches_jax(built, dtype):
    x, jidx, pidx = built
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dtype), pad=1024)
    pp = port_index.pack_index(pidx, torch.from_numpy(x),
                               dtype=port_index.pack_dtype(dtype), pad=1024)
    assert tuple(pp.packed.shape) == jp.packed.shape
    np.testing.assert_array_equal(pp.packed_rows.numpy(), np.asarray(jp.packed_rows))
    _assert_slabs_close(pp.packed, np.asarray(jp.packed))
    if dtype == "int8":
        np.testing.assert_allclose(float(pp.packed_gscale),
                                   float(jp.packed_gscale), rtol=1e-6)
    else:
        assert pp.packed_gscale is None and jp.packed_gscale is None


def test_candidate_mask_and_query_hashes_match_jax(built):
    x, jidx, pidx = built
    qs = x[:40] + 0.05 * np.random.default_rng(3).normal(size=(40, D)).astype(np.float32)
    jq, _ = jax_index.query_hashes(jidx, jnp.asarray(qs))
    pq, _ = port_index.query_hashes(pidx, torch.from_numpy(qs))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(
        port_index.candidate_mask(pidx, torch.from_numpy(qs)).numpy(),
        np.asarray(jax_index.candidate_mask(jidx, jnp.asarray(qs))),
    )


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_checkpoint_jax_to_port_round_trip(built, dtype, tmp_path):
    """An archive written by the JAX package loads into the port bit for bit
    (bf16 decoded from its uint16 view with torch alone)."""
    x, jidx, _ = built
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dtype), pad=1024)
    path = str(tmp_path / "idx.npz")
    jax_ckpt.save_index(path, jp)
    got = checkpoint.load_index(path, torch.device("cpu"))
    assert (got.metric, got.n_buckets, got.n_rows) == (jp.metric, jp.n_buckets, jp.n_rows)
    assert (got.family.k, got.family.L) == (K, L)
    np.testing.assert_array_equal(got.family.proj.numpy(), np.asarray(jp.family.proj))
    for f in ("bucket_ids", "sorted_rows", "bucket_starts", "packed_rows"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jp, f)))
    assert got.packed.dtype == port_index.pack_dtype(dtype)
    np.testing.assert_array_equal(to_np(got.packed), to_np(jp.packed))
    if dtype == "int8":
        assert float(got.packed_gscale) == float(jp.packed_gscale)


def test_checkpoint_port_to_jax_round_trip(built, tmp_path):
    """The port writes the same archive format: JAX reads it back."""
    x, jidx, pidx = built
    pp = port_index.pack_index(pidx, torch.from_numpy(x), dtype=torch.bfloat16, pad=1024)
    path = str(tmp_path / "idx.npz")
    checkpoint.save_index(path, pp)
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
    assert meta["version"] == 3 and meta["packed_dtypes"]["packed"] == "bfloat16"
    back = jax_ckpt.load_index(path)
    np.testing.assert_array_equal(np.asarray(back.sorted_rows), np.asarray(jidx.sorted_rows))
    np.testing.assert_array_equal(to_np(back.packed), to_np(pp.packed))
    again = port_index.index_from_numpy(*handover(back), torch.device("cpu"))
    assert torch.equal(again.packed, pp.packed)


def test_per_row_int8_archive_is_refused(built):
    """Per-row int8 slabs, refused before the port had packed_retrieve_core,
    now load bit for bit and serve JAX's top-k through the core and the
    exact rerank."""
    x, jidx, _ = built
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.int8, pad=1024,
                              scale_mode="row")
    got = port_index.index_from_numpy(*handover(jp), torch.device("cpu"))
    for f in ("packed", "packed_rows", "packed_scale"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jp, f)))
    assert got.packed_gscale is None
    qs = x[:16] + 0.05 * np.random.default_rng(2).normal(size=(16, D)).astype(np.float32)
    want = jax_index.retrieve_topk(jp, jnp.asarray(qs), jnp.asarray(x), top_k=10,
                                   per_table=200)
    res = port_index.retrieve_topk(got, torch.from_numpy(qs), torch.from_numpy(x),
                                   top_k=10, per_table=200)
    assert_topk_match(*want, *res, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def euclid():
    rng = np.random.default_rng(11)
    x = (2.0 * rng.normal(size=(N, D))).astype(np.float32)
    jidx = jax_index.build_index(
        jax.random.PRNGKey(2), jnp.asarray(x), "euclidean", k=4, L=3,
        lsh_bucket_div=4, euclidean_h_w=8.0,
    )
    return x, jidx


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_euclidean_checkpoint_jax_to_port(euclid, dtype, tmp_path):
    """A JAX-written euclidean archive (p-stable family, fingerprints,
    augmented slabs) loads into the port bit for bit."""
    x, jidx = euclid
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dtype), pad=1024,
                              augment=True)
    path = str(tmp_path / "idx.npz")
    jax_ckpt.save_index(path, jp)
    got = checkpoint.load_index(path, torch.device("cpu"))
    assert (got.metric, got.n_buckets, got.n_rows) == ("euclidean", N // 4, N)
    assert (got.family.k, got.family.L, got.family.w) == (4, 3, 8.0)
    for f in ("proj", "offsets", "weights"):
        np.testing.assert_array_equal(getattr(got.family, f).numpy(),
                                      np.asarray(getattr(jp.family, f)), err_msg=f)
    for f in ("bucket_ids", "sorted_rows", "bucket_starts", "detailed", "packed_rows",
              "packed_detailed", "packed_aug_scale"):
        np.testing.assert_array_equal(to_np(getattr(got, f)), to_np(getattr(jp, f)),
                                      err_msg=f)
    assert got.packed.dtype == port_index.pack_dtype(dtype)
    np.testing.assert_array_equal(to_np(got.packed), to_np(jp.packed))
    assert (got.packed_gscale is None) == (dtype != "int8")


def test_euclidean_checkpoint_port_to_jax(euclid, tmp_path):
    """A port-written euclidean archive loads in JAX, and both packages
    retrieve the same top-k from it."""
    x, jidx = euclid
    fam = port_index.family_from_numpy(*handover(jidx), torch.device("cpu"))
    pidx = port_index.build_index(None, torch.from_numpy(x), "euclidean", 4, 3,
                                  lsh_bucket_div=4, euclidean_h_w=8.0, family=fam)
    pp = port_index.pack_index(pidx, torch.from_numpy(x), dtype=torch.int8, pad=1024,
                               augment=True)
    path = str(tmp_path / "idx.npz")
    checkpoint.save_index(path, pp)
    back = jax_ckpt.load_index(path)
    assert back.metric == "euclidean" and back.family.w == 8.0
    for f in ("detailed", "sorted_rows", "packed_detailed", "packed"):
        np.testing.assert_array_equal(to_np(getattr(back, f)), to_np(getattr(pp, f)))
    assert float(back.packed_aug_scale) == float(pp.packed_aug_scale)
    qs = x[:16] + 0.05 * np.random.default_rng(1).normal(size=(16, D)).astype(np.float32)
    want = jax_index.retrieve_topk(back, jnp.asarray(qs), jnp.asarray(x), top_k=10,
                                   per_table=200)
    got = port_index.retrieve_topk(pp, torch.from_numpy(qs), torch.from_numpy(x),
                                   top_k=10, per_table=200)
    assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)


def test_hash_bits_match_jax(built):
    """CosineLsh.hash_bits: [n, L, k] int32 sign bits, equal to JAX's
    exactly wherever the projection is not within 1e-4 |x||r| of 0 (its
    sign there is f32 summation order; the f64 margin finds those), and
    packed MSB-first they are the port's bucket ids."""
    x, jidx, pidx = built
    want = np.asarray(jidx.family.hash_bits(jnp.asarray(x)))
    got = pidx.family.hash_bits(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (N, L, K) == want.shape
    proj = np.asarray(jidx.family.proj).astype(np.float64)
    exact = x.astype(np.float64) @ proj
    lim = 1e-4 * np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(proj, axis=0)[None, :]
    near0 = (np.abs(exact) <= lim).reshape(N, L, K)
    assert near0.mean() < 1e-3
    np.testing.assert_array_equal(got.numpy()[~near0], want[~near0])
    np.testing.assert_array_equal(got.numpy()[~near0], (exact >= 0).reshape(N, L, K)[~near0])
    weights = 1 << torch.arange(K - 1, -1, -1, dtype=torch.int32)
    np.testing.assert_array_equal((got * weights).sum(-1).numpy(),
                                  pidx.family.bucket_ids(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_rerank_exact_ties_go_to_the_earlier_candidate(metric):
    """Duplicate corpus rows in a candidate list (rerank_exact's `torch.topk`
    site): equal exact scores keep the candidate list's order, as JAX's
    `lax.top_k` does.  Integer rows and queries of norm 2 (four entries of
    +-1) make every product exact, so duplicates' scores are bit-equal."""
    rng = np.random.default_rng(9)
    base = rng.integers(-2, 3, size=(12, 16)).astype(np.float32)
    base[base.sum(1) == 0, 0] = 1.0
    corpus = base[rng.integers(0, 12, size=300)]
    qs = np.zeros((20, 16), np.float32)
    for row in qs:
        row[rng.permutation(16)[:4]] = rng.choice([-1.0, 1.0], size=4)
    ids = np.stack([rng.permutation(300)[:40] for _ in range(20)]).astype(np.int32)
    ids[:, -3:] = -1                                                  # pads
    want = jax_index.rerank_exact(jnp.asarray(corpus), metric, jnp.asarray(qs),
                                  jnp.asarray(ids), 8)
    got = port_index.rerank_exact(torch.from_numpy(corpus), metric, torch.from_numpy(qs),
                                  torch.from_numpy(ids), 8)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    assert int((got[0][:, 7] == got[0][:, 8 - 2]).sum()) >= 10       # cuts on ties
