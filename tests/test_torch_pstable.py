"""Euclidean p-stable LSH: the port against the JAX package, with JAX's
hash parameters handed over as arrays (index_from_numpy).

Exact: h-values (on inputs whose (v.x + t)/w lies >= 1e-4 from an
integer, asserted), bucket ids (with forced int32 overflow), fingerprints
(with negative h), CSR rows / starts / fingerprints, `_fp_run_starts`,
packed rows and packed fingerprints.  Augmented slabs: within one
quantization step (int8, bf16) on < 0.01% of elements, f32 within rtol
1e-6; gscale and aug_scale within rtol 1e-6.  Retrieval: assert_topk_match
at rtol 1e-5.  Without the exact rerank a score is -sqrt(|q|^2 - 2 rank),
a difference of two terms of size |q|^2 whose f32 summation order differs
between the packages, so those scores are compared squared, with atol
1e-5 |q|^2_max.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.models.lsh.pstable import PStableLsh as JaxPStable
from crypto_rec_tpu.ops.pallas import slabscore as jax_slab
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh
from crypto_rec_tpu_torch.ops.kernels import slabscore

from _torch_parity import assert_topk_match, handover

N, D, Q, K, L, W, PT = 4096, 128, 32, 4, 3, 8.0, 200
CPU = torch.device("cpu")
DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = 2.0 * rng.normal(size=(32, D))
    x = (centers[rng.integers(0, 32, N)] + 0.5 * rng.normal(size=(N, D))).astype(np.float32)
    qs = (x[:Q] + 0.05 * rng.normal(size=(Q, D))).astype(np.float32)
    jidx = jax_index.build_index(jax.random.PRNGKey(1), jnp.asarray(x), "euclidean",
                                 k=K, L=L, lsh_bucket_div=4, euclidean_h_w=W)
    fam = port_index.family_from_numpy(*handover(jidx), CPU)
    pidx = port_index.build_index(None, torch.from_numpy(x), "euclidean", K, L,
                                  lsh_bucket_div=4, euclidean_h_w=W, family=fam)
    packs = {dt: jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dt),
                                      pad=1024, augment=True) for dt in DTYPES}
    return dict(x=x, qs=qs, jidx=jidx, pidx=pidx, packs=packs)


def _families(rng, k=5, L=4, d=16, w=2.0):
    proj = rng.normal(size=(d, L * k)).astype(np.float32)
    offsets = (w * rng.random((L, k))).astype(np.float32)
    weights = rng.integers(0, 101, size=(L, k)).astype(np.int32)
    jf = JaxPStable(proj=jnp.asarray(proj), offsets=jnp.asarray(offsets),
                    weights=jnp.asarray(weights), w=w, k=k, L=L)
    pf = PStableLsh(proj=torch.from_numpy(proj), offsets=torch.from_numpy(offsets),
                    weights=torch.from_numpy(weights), w=w, k=k, L=L)
    return jf, pf


def test_hash_values_match_jax():
    rng = np.random.default_rng(0)
    jf, pf = _families(rng)
    x = rng.normal(size=(512, 16)).astype(np.float32)
    z = (x.astype(np.float64) @ np.asarray(jf.proj, np.float64)).reshape(512, 4, 5)
    z = (z + np.asarray(jf.offsets, np.float64)[None]) / jf.w
    keep = (np.abs(z - np.round(z)) >= 1e-4).all(axis=(1, 2))
    assert keep.mean() > 0.9
    x = x[keep]                       # precondition: no cell boundary within 1e-4
    want = np.asarray(jf.hash_values(jnp.asarray(x)))
    got = pf.hash_values(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_buckets", [7, 1024, 2**31 - 1])
def test_bucket_ids_wrap_like_int32(n_buckets):
    """phi's weighted sum overflows int32 for large h: both wrap."""
    rng = np.random.default_rng(1)
    jf, pf = _families(rng)
    h = rng.integers(-2**31, 2**31, size=(300, 4, 5)).astype(np.int32)
    h[:50] = rng.integers(-9, 9, size=(50, 4, 5))
    big = np.abs(h.astype(np.int64) * np.asarray(jf.weights)[None]).sum(-1)
    assert (big >= 2**31).mean() > 0.5          # overflow is forced
    want = np.asarray(jf.bucket_ids_from_hashes(jnp.asarray(h), n_buckets))
    got = pf.bucket_ids_from_hashes(torch.from_numpy(h), n_buckets)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and int(got.min()) >= 0


def test_fingerprints_match_jax_with_negative_h():
    rng = np.random.default_rng(2)
    jf, pf = _families(rng)
    h = rng.integers(-2**31, 2**31, size=(400, 4, 5)).astype(np.int32)
    h[:100] = rng.integers(-3, 3, size=(100, 4, 5))
    assert (h < 0).any()
    want = np.asarray(jf.fingerprints_from_hashes(jnp.asarray(h)))
    got = pf.fingerprints_from_hashes(torch.from_numpy(h))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_euclidean_build_index_matches_jax(data):
    jidx, pidx = data["jidx"], data["pidx"]
    assert pidx.n_buckets == jidx.n_buckets == N // 4
    for f in ("bucket_ids", "sorted_rows", "bucket_starts", "detailed"):
        got = getattr(pidx, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jidx, f)), err_msg=f)


def test_query_hashes_and_candidate_mask_match_jax(data):
    jidx, pidx, qs = data["jidx"], data["pidx"], data["qs"]
    jb, jd = jax_index.query_hashes(jidx, jnp.asarray(qs))
    pb, pd = port_index.query_hashes(pidx, torch.from_numpy(qs))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    for filtered in (True, False):
        want = np.asarray(jax_index.candidate_mask(jidx, jnp.asarray(qs), filtered=filtered))
        got = port_index.candidate_mask(pidx, torch.from_numpy(qs), filtered=filtered)
        np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_fp_run_starts_matches_jax(data):
    """The fingerprint-run binary search, on the queries' own runs and on
    targets that are absent from their bucket (-> the bucket end)."""
    jidx = data["packs"]["float32"]
    pd = np.asarray(jidx.packed_detailed)
    n_pad = pd.shape[1]
    qb, qd = jax_index.query_hashes(jidx, jnp.asarray(data["qs"]))
    qb, qd = np.array(qb), np.array(qd)
    starts = np.array(jidx.bucket_starts)
    l_idx = np.arange(L)
    start, end = starts[l_idx[None], qb], starts[l_idx[None], qb + 1]
    absent = qd ^ 0x55555555
    flat = pd.reshape(-1).copy()
    base = l_idx[None] * n_pad
    for target in (qd, absent):
        want = jax_index._fp_run_starts(
            lambda p: jnp.asarray(flat)[base + p], jnp.asarray(start),
            jnp.asarray(end), jnp.asarray(target), n_pad)
        tflat, tbase = torch.from_numpy(flat), torch.from_numpy(base)
        got = port_index._fp_run_starts(
            lambda p: tflat[tbase + p], torch.from_numpy(start), torch.from_numpy(end),
            torch.from_numpy(target), n_pad).numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        # the lower bound in signed int32 order: the run's start, or where
        # the run would begin (a window there holds no tuple match)
        for qi, li in np.ndindex(*got.shape):
            run = flat[base[0, li] + start[qi, li]:base[0, li] + end[qi, li]]
            assert got[qi, li] == start[qi, li] + np.searchsorted(run, target[qi, li])
    at = flat[base + np.minimum(got, n_pad - 1)]
    assert not ((got < end) & (at == absent)).any()


def _assert_slabs_close(got: torch.Tensor, want: np.ndarray):
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        return
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int64)
        w = want.view(np.int16).astype(np.int64)
    else:
        g, w = got.numpy().astype(np.int64), want.astype(np.int64)
    off = np.abs(g - w)
    assert off.max() <= 1, "slab element more than one step off"
    assert (off > 0).mean() <= 1e-4, f"{(off > 0).mean():.2e} of elements off"


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pack_index_augmented_matches_jax(data, dtype):
    jp = data["packs"][dtype]
    pp = port_index.pack_index(data["pidx"], torch.from_numpy(data["x"]),
                               dtype=DTYPES[dtype], pad=1024, augment=True)
    assert tuple(pp.packed.shape) == jp.packed.shape and jp.packed.shape[2] == 256
    for f in ("packed_rows", "packed_detailed"):
        np.testing.assert_array_equal(getattr(pp, f).numpy(), np.asarray(getattr(jp, f)))
    _assert_slabs_close(pp.packed, np.asarray(jp.packed))
    np.testing.assert_allclose(float(pp.packed_aug_scale), float(jp.packed_aug_scale),
                               rtol=1e-6)
    if dtype == "int8":
        np.testing.assert_allclose(float(pp.packed_gscale), float(jp.packed_gscale),
                                   rtol=1e-6)
    else:
        assert pp.packed_gscale is None and jp.packed_gscale is None


def _assert_euclid_topk(want, got, qs, rerank):
    if rerank:
        assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)
    else:
        assert_topk_match(-np.asarray(want[0]) ** 2, want[1], -got[0].numpy() ** 2,
                          got[1], rtol=1e-5, atol=1e-5 * float((qs ** 2).sum(1).max()))


@pytest.mark.parametrize("filtered", [True, False])
@pytest.mark.parametrize("int8_rerank", [True, False])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_retrieve_topk_augmented_matches_jax(data, dtype, int8_rerank, filtered):
    """JAX's retrieve_topk runs its augmented kernel branch in interpret
    mode on the CPU (packed_retrieve_pallas_euclid)."""
    jp, x, qs = data["packs"][dtype], data["x"], data["qs"]
    want = jax_index.retrieve_topk(jp, jnp.asarray(qs), jnp.asarray(x), top_k=10,
                                   per_table=PT, filtered=filtered,
                                   int8_rerank=int8_rerank)
    pidx = port_index.index_from_numpy(*handover(jp), CPU)
    got = port_index.retrieve_topk(pidx, torch.from_numpy(qs), torch.from_numpy(x),
                                   top_k=10, per_table=PT, filtered=filtered,
                                   int8_rerank=int8_rerank)
    _assert_euclid_topk(want, got, qs, int8_rerank)
    assert int(got[1].max()) < N and bool((got[0][:, 0] > -np.inf).all())


def test_packed_retrieve_pallas_euclid_matches_jax(data):
    """The euclidean fused core on JAX's own hashes, unfiltered windows."""
    jp, qs = data["packs"]["int8"], data["qs"]
    qb, _ = jax_index.query_hashes(jp, jnp.asarray(qs))
    want = jax_slab.packed_retrieve_pallas_euclid(
        jp.packed, jp.packed_rows, None, jp.bucket_starts, N, D, jnp.asarray(qs),
        qb, None, jp.packed_gscale, jp.packed_aug_scale, 10, PT, interpret=True)
    t = lambda a: torch.from_numpy(np.asarray(a).copy())
    got = slabscore.packed_retrieve_pallas_euclid(
        t(jp.packed), t(jp.packed_rows), None, t(jp.bucket_starts), N, D,
        torch.from_numpy(qs), t(qb), None, t(jp.packed_gscale),
        t(jp.packed_aug_scale), 10, PT)
    _assert_euclid_topk(want, got, qs, rerank=False)


def test_rerank_exact_euclidean_matches_jax(data):
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, N, size=(Q, 25)).astype(np.int32)
    want = jax_index.rerank_exact(jnp.asarray(data["x"]), "euclidean",
                                  jnp.asarray(data["qs"]), jnp.asarray(ids), 10)
    got = port_index.rerank_exact(torch.from_numpy(data["x"]), "euclidean",
                                  torch.from_numpy(data["qs"]), torch.from_numpy(ids), 10)
    assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)


def test_window_offsets_with_shared_row_and_salt():
    """The generalized window offset: one bucket_starts row read by every
    window (the cubes), salted by probe + cube * probes — JAX's arithmetic
    (hypercube.py:444-450, :645-653), int32 wrap included."""
    rng = np.random.default_rng(5)
    n_buckets, probes, per_probe = 1 << 13, 8, 50
    sizes = rng.integers(0, 400, size=n_buckets)
    starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    pv = rng.integers(0, n_buckets, size=(64, probes)).astype(np.int32)
    for ci in (0, 2):
        t_idx = jnp.arange(probes, dtype=jnp.int32)
        jstart, jend = jnp.asarray(starts)[pv], jnp.asarray(starts)[pv + 1]
        mix = (jnp.asarray(pv) * jnp.int32(-1640531527)) ^ (
            (t_idx + ci * probes)[None, :] * jnp.int32(40503))
        s0 = jstart + jnp.remainder(jnp.abs(mix),
                                    jnp.maximum(jend - jstart - per_probe, 0) + 1)
        got_s0, got_sz = slabscore._window_offsets(
            torch.from_numpy(starts)[None].expand(probes, -1), torch.from_numpy(pv),
            per_probe, salt=torch.arange(probes) + ci * probes)
        np.testing.assert_array_equal(got_s0.numpy(), np.asarray(s0))
        np.testing.assert_array_equal(got_sz.numpy(),
                                      np.asarray(jnp.minimum(jend - s0, per_probe)))


def test_unported_euclidean_layouts_raise(data):
    """Unaugmented euclidean slabs (per-row int8, or f32 with the sqnorm
    plane), refused before the port had packed_retrieve_core, now load,
    pack and serve as JAX's do (tests/test_torch_retrieve_core.py covers
    the core layout by layout)."""
    jp = jax_index.pack_index(data["jidx"], jnp.asarray(data["x"]), dtype=jnp.float32,
                              pad=1024)
    got = port_index.index_from_numpy(*handover(jp), CPU)
    np.testing.assert_array_equal(got.packed_sqnorm.numpy(), np.asarray(jp.packed_sqnorm))
    pp = port_index.pack_index(data["pidx"], torch.from_numpy(data["x"]), pad=1024)
    assert pp.packed.dtype == torch.bfloat16 and pp.packed_sqnorm is not None
    jr = jax_index.pack_index(data["jidx"], jnp.asarray(data["x"]), dtype=jnp.int8,
                              pad=1024)
    pr = port_index.pack_index(data["pidx"], torch.from_numpy(data["x"]),
                               dtype=torch.int8, pad=1024)
    np.testing.assert_allclose(pr.packed_scale.numpy(), np.asarray(jr.packed_scale),
                               rtol=1e-6)
    want = jax_index.retrieve_topk(jr, jnp.asarray(data["qs"]), jnp.asarray(data["x"]),
                                   top_k=10, per_table=PT)
    got = port_index.retrieve_topk(port_index.index_from_numpy(*handover(jr), CPU),
                                   torch.from_numpy(data["qs"]),
                                   torch.from_numpy(data["x"]), top_k=10, per_table=PT)
    qmax = float((data["qs"] ** 2).sum(1).max())
    assert_topk_match(-np.asarray(want[0]) ** 2, want[1], -got[0].numpy() ** 2, got[1],
                      rtol=1e-5, atol=1e-5 * qmax)


def test_port_built_euclidean_index_finds_planted_rows():
    """The port's own seeded build (no handover) end to end: augmented
    int8 slabs, rerank, nearest rows first."""
    rng = np.random.default_rng(4)
    centers = 2.0 * rng.normal(size=(16, 64))
    x = (centers[rng.integers(0, 16, 2048)] + 0.5 * rng.normal(size=(2048, 64))).astype(np.float32)
    qs = x[:24] + 0.01 * rng.normal(size=(24, 64)).astype(np.float32)
    X = torch.from_numpy(x)
    idx = port_index.build_index(torch.Generator().manual_seed(3), X, "euclidean",
                                 4, 4, lsh_bucket_div=4, euclidean_h_w=8.0)
    pidx = port_index.pack_index(idx, X, dtype=torch.int8, pad=1024, augment=True)
    s, ids = port_index.retrieve_topk(pidx, torch.from_numpy(qs), X, top_k=5,
                                      per_table=128)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(24))
    true_d = np.linalg.norm(qs - x[:24], axis=1)
    np.testing.assert_allclose(-s[:, 0].numpy(), true_d, rtol=1e-5, atol=1e-5)
