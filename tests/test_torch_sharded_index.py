"""The sharded index of the port (`crypto_rec_tpu_torch/parallel/
sharded_index.py`) against the JAX package's, on the JAX tests' inputs:
per-shard build and pack, the three retrieval legs of
sharded_retrieve_topk (the candidate gather, the blocked core, K1) and the
sharded checkpoint, on an 8-cell (1, 8) mesh of logical cells in one
process against JAX's 8-device CPU mesh.

Inputs are made from numpy seeds; JAX's hash parameters cross over as
arrays.  JAX's kernel legs run in interpret mode, as its own tests run
them; the port's run K1's plain version on CPU tensors.  CSR tables,
fingerprints and packed row ids must be equal; int8 slabs may sit one step
off on <= 1e-4 of the elements; scores agree within rtol 1e-5 and ids
wherever the score is not tied at the top-k boundary.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from crypto_rec_tpu import checkpoint as jax_ckpt
from crypto_rec_tpu.parallel import sharded_index as jsi
from crypto_rec_tpu.parallel.mesh import make_mesh as jax_mesh
from crypto_rec_tpu_torch import checkpoint
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh
from crypto_rec_tpu_torch.ops.oracle import exact_nearest, recall_at_k
from crypto_rec_tpu_torch.parallel import sharded_index as psi
from crypto_rec_tpu_torch.parallel.mesh import make_mesh

from _torch_parity import assert_topk_match, to_np, to_torch

JMESH = jax_mesh((1, 8))
PMESH = make_mesh((1, 8), device="cpu")
KEY = jax.random.PRNGKey(9)


def port_family(jfam, metric):
    """A JAX CosineLsh / PStableLsh -> the port's family, same parameters."""
    if metric == "cosine":
        return CosineLsh(proj=to_torch(jfam.proj), k=jfam.k, L=jfam.L)
    return PStableLsh(proj=to_torch(jfam.proj), offsets=to_torch(jfam.offsets),
                      weights=to_torch(jfam.weights), w=float(jfam.w), k=jfam.k, L=jfam.L)


def assert_slabs_close(got, want):
    """int8 / bf16 slabs equal but for one quantization (bf16: one bit)
    step on at most 1e-4 of the elements; f32 within rtol 1e-6 (the port
    sums row norms in float64)."""
    if got.dtype == torch.bfloat16:
        g = got.view(torch.int16).numpy().astype(np.int64)
        w = want.view(np.int16).astype(np.int64)
    elif got.dtype == torch.int8:
        g, w = got.numpy().astype(np.int64), want.astype(np.int64)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        return
    off = np.abs(g - w)
    assert off.max() <= 1, "slab element more than one step off"
    assert (off > 0).mean() <= 1e-4, f"{(off > 0).mean():.2e} of elements off"


def _clustered(seed, n, d, n_centers=32, spread=0.1):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centers, d)).astype(np.float32) * 4
    pts = centers[rng.integers(0, n_centers, size=n)] + spread * rng.normal(size=(n, d))
    return pts.astype(np.float32)


def _noisy(seed, rows, scale):
    rng = np.random.default_rng(seed)
    return (rows + scale * rng.normal(size=rows.shape)).astype(np.float32)


class Case:
    """One corpus, both packages' sharded indexes (the port's built from
    JAX's hash family) and both sharded corpora."""

    def __init__(self, corpus, queries, metric, k, L, key=KEY, **kw):
        self.corpus, self.queries, self.metric = corpus, queries, metric
        self.jc = jsi.shard_corpus(JMESH, jnp.asarray(corpus))
        self.pc = psi.shard_corpus(PMESH, torch.from_numpy(corpus))
        self.jidx = jsi.build_sharded_index(JMESH, key, self.jc, metric, k, L, **kw)
        self.pidx = psi.build_sharded_index(PMESH, None, self.pc, metric, k, L, **kw,
                                            family=port_family(self.jidx.family, metric))

    def pack(self, dtype, pad, augment=False):
        j = jsi.pack_sharded_index(JMESH, self.jidx, self.jc, dtype=jnp.dtype(dtype),
                                   pad=pad, augment=augment)
        p = psi.pack_sharded_index(PMESH, self.pidx, self.pc,
                                   dtype=getattr(torch, dtype), pad=pad, augment=augment)
        return j, p

    def retrieve(self, jidx, pidx, jax_kw=None, **kw):
        js, ji = jsi.sharded_retrieve_topk(JMESH, jidx, jnp.asarray(self.queries), self.jc,
                                           **kw, **(jax_kw or {}))
        ps, pi = psi.sharded_retrieve_topk(PMESH, pidx, torch.from_numpy(self.queries),
                                           self.pc, **kw)
        assert pi.dtype == torch.int32
        assert_scores_match(self.metric, self.queries, (js, ji), (ps, pi))
        return to_np(ps), to_np(pi)


def assert_scores_match(metric, queries, want, got):
    """assert_topk_match; euclidean -distances compared squared within
    1e-5 of the largest |q|^2, as tests/test_torch_retrieve_core.py does (the
    blocked core's |x|^2 - 2 x.q + |q|^2 cancels near 0)."""
    if metric == "cosine":
        assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)
    else:
        qmax = float((queries ** 2).sum(1).max())
        assert_topk_match(-to_np(want[0]) ** 2, want[1], -to_np(got[0]) ** 2, got[1],
                          rtol=1e-5, atol=1e-5 * qmax)


_CASES = {}


def case(name):
    """The JAX tests' corpora (tests/test_sharded_index.py), built once."""
    if name not in _CASES:
        if name == "cosine":        # test_sharded_cosine_retrieval_recall & packed legs
            x = _clustered(1, 8 * 256, 32)
            _CASES[name] = Case(x, _noisy(2, x[:64], 0.01), "cosine", 6, 6)
        elif name == "euclidean":   # test_sharded_euclidean_with_detailed_filter
            x = _clustered(3, 8 * 128, 16, n_centers=16)
            _CASES[name] = Case(x, x[:32].copy(), "euclidean", 3, 4, lsh_bucket_div=4,
                                euclidean_h_w=4.0)
        elif name == "kernel":      # test_sharded_pallas_leg_matches_xla
            x = _clustered(4, 8 * 512, 128)
            _CASES[name] = Case(x, _noisy(5, x[:16], 0.01), "cosine", 5, 4)
        elif name == "augmented":   # test_sharded_euclidean_augmented_kernel_leg
            rng = np.random.default_rng(41)
            x = rng.normal(size=(8 * 512, 128)).astype(np.float32)
            target = rng.choice(len(x), size=24, replace=False)
            c = Case(x, _noisy(6, x[target], 1e-3), "euclidean", 4, 6,
                     key=jax.random.PRNGKey(3), lsh_bucket_div=4, euclidean_h_w=8.0)
            c.target = target
            _CASES[name] = c
    return _CASES[name]


@pytest.mark.parametrize("name", ["cosine", "euclidean"])
def test_build_matches_jax(name):
    c = case(name)
    j, p = c.jidx, c.pidx
    assert (p.n_buckets, p.n_local, p.n_shards, p.shards) == (
        j.n_buckets, j.n_local, j.n_shards, tuple(range(8)))
    for f in ("sorted_rows", "bucket_starts", "detailed"):
        if getattr(j, f) is None:
            assert getattr(p, f) is None
            continue
        got = getattr(p, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(j, f)), err_msg=f)


@pytest.mark.parametrize("name", ["cosine", "euclidean"])
def test_unpacked_leg_matches_jax(name):
    c = case(name)
    if name == "cosine":
        s, ids = c.retrieve(c.jidx, c.pidx, budget=256, top_k=10)
        assert np.all(np.diff(s, axis=1) <= 1e-6)
        _, true_idx = exact_nearest(torch.from_numpy(c.queries), torch.from_numpy(c.corpus),
                                    "cosine", 10)
        assert recall_at_k(torch.from_numpy(ids), true_idx) > 0.95
    else:
        s, ids = c.retrieve(c.jidx, c.pidx, budget=128, top_k=5)
        # each query is a corpus row: its own row first, at distance 0
        np.testing.assert_allclose(s[:, 0], 0.0, atol=1e-4)
        np.testing.assert_array_equal(ids[:, 0], np.arange(32))


def test_global_ids_cover_all_shards():
    """Every row queries itself and finds itself, whichever shard owns it
    (test_sharded_index.py::test_global_ids_cover_all_shards, the port's
    own hash draw)."""
    x = np.random.default_rng(8).normal(size=(8 * 64, 8)).astype(np.float32)
    pc = psi.shard_corpus(PMESH, torch.from_numpy(x))
    idx = psi.build_sharded_index(PMESH, torch.Generator().manual_seed(9), pc, "cosine", 4, 8)
    _, ids = psi.sharded_retrieve_topk(PMESH, idx, torch.from_numpy(x), pc, budget=64, top_k=1)
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(len(x)))


@pytest.mark.parametrize("name,dtype,per_table,budget,top_k", [
    ("cosine", "float32", 256, 256, 10),      # test_sharded_packed_matches_unpacked
    ("cosine", "int8", 256, 256, 10),         # ..._int8_rerank_matches_unpacked
    ("euclidean", "float32", 128, 128, 5),    # test_sharded_packed_euclidean_filtered
])
def test_packed_core_leg_matches_jax(name, dtype, per_table, budget, top_k):
    """d % 128 != 0: every shard takes the blocked core (per-row scales
    for the euclidean slabs), int8 over-fetches and reranks exactly."""
    c = case(name)
    jp, pp = c.pack(dtype, 512)
    np.testing.assert_array_equal(pp.packed_rows.numpy(), np.asarray(jp.packed_rows))
    assert_slabs_close(pp.packed, np.asarray(jp.packed))
    for f in ("packed_gscale", "packed_scale", "packed_sqnorm"):
        assert (getattr(pp, f) is None) == (getattr(jp, f) is None), f
        if getattr(pp, f) is not None:
            np.testing.assert_allclose(getattr(pp, f).numpy(), np.asarray(getattr(jp, f)),
                                       rtol=1e-6, err_msg=f)
    if getattr(jp, "packed_detailed") is not None:
        np.testing.assert_array_equal(pp.packed_detailed.numpy(),
                                      np.asarray(jp.packed_detailed))
    s, ids = c.retrieve(jp, pp, budget=budget, top_k=top_k, per_table=per_table)
    if name == "euclidean":
        np.testing.assert_array_equal(ids[:, 0], np.arange(32))
        np.testing.assert_allclose(s[:, 0], 0.0, atol=2e-2)
    else:
        # the packed leg against the port's own unpacked leg: the same
        # neighbours but for one near-tie a query
        ws, wi = psi.sharded_retrieve_topk(PMESH, c.pidx, torch.from_numpy(c.queries), c.pc,
                                           budget=256, top_k=10, per_table=256)
        for qi in range(len(ids)):
            want = set(wi[qi][wi[qi] >= 0].tolist())
            assert len(want & set(ids[qi][ids[qi] >= 0].tolist())) >= len(want) - 1


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_kernel_leg_matches_jax(dtype):
    """d = 128 and a pad of per_table + 160: each shard's leg is K1
    (`packed_retrieve_pallas`); JAX's runs its Pallas kernel in interpret
    mode."""
    c = case("kernel")
    jp, pp = c.pack(dtype, 1024)
    assert pp.packed_scale is None
    assert_slabs_close(pp.packed, np.asarray(jp.packed))
    c.retrieve(jp, pp, jax_kw=dict(use_pallas=True, pallas_interpret=True), budget=256,
               top_k=8, per_table=256)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_augmented_kernel_leg_matches_jax(dtype):
    """Augmented euclidean shards: K1 on [x, -|x|^2/2, 0-pad] slabs, 2x
    over-fetch, the exact rerank per shard; the planted twins come first
    with their true distance."""
    c = case("augmented")
    jp, pp = c.pack(dtype, 512, augment=True)
    assert pp.packed.shape[-1] == 256
    assert_slabs_close(pp.packed, np.asarray(jp.packed))
    np.testing.assert_allclose(pp.packed_aug_scale.numpy(), np.asarray(jp.packed_aug_scale),
                               rtol=1e-6)
    s, ids = c.retrieve(jp, pp, jax_kw=dict(pallas_interpret=True), budget=128, top_k=5,
                        per_table=128)
    np.testing.assert_array_equal(ids[:, 0], c.target)
    true_d = np.linalg.norm(c.queries - c.corpus[c.target], axis=1)
    np.testing.assert_allclose(-s[:, 0], true_d, atol=1e-4)


def test_window_beyond_the_shard_takes_the_core_check():
    """A window wider than the shard's pad fails K1's guard (n_pad >=
    per_table + 160), so the shard takes the blocked core, as in JAX, whose
    own check raises before any kernel runs."""
    c = case("kernel")
    _, pp = c.pack("int8", 1024)
    pt = pp.packed.shape[2] - 160 + 1
    with pytest.raises(ValueError, match="re-pack"):
        psi.sharded_retrieve_topk(PMESH, pp, torch.from_numpy(c.queries), c.pc,
                                  budget=pt, top_k=8, per_table=pt)


# ---- checkpoints (tests/test_checkpoint.py:92 and the augmented round trip) ----

def test_sharded_checkpoint_roundtrip(tmp_path):
    """The port's per-shard save and restore on the 8-cell mesh: nine
    files, int8 slabs, identical retrieval."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(512, 16)).astype(np.float32)
    qs = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    pc = psi.shard_corpus(PMESH, torch.from_numpy(x))
    idx = psi.build_sharded_index(PMESH, torch.Generator().manual_seed(9), pc, "cosine", 3, 3)
    idx = psi.pack_sharded_index(PMESH, idx, pc, dtype=torch.int8, pad=512)
    prefix = str(tmp_path / "shidx")
    assert len(checkpoint.save_sharded_index(prefix, idx, PMESH)) == 1 + 8
    idx2 = checkpoint.load_sharded_index(prefix, PMESH)
    assert idx2.packed.dtype == torch.int8
    kw = dict(budget=64, top_k=5, per_table=32)
    s1, i1 = psi.sharded_retrieve_topk(PMESH, idx, qs, pc, **kw)
    s2, i2 = psi.sharded_retrieve_topk(PMESH, idx2, qs, pc, **kw)
    assert torch.equal(i1, i2) and torch.equal(s1, s2)


@pytest.mark.parametrize("name,dtype,augment,kw", [
    ("cosine", "int8", False, dict(budget=256, top_k=10, per_table=256)),
    ("augmented", "bfloat16", True, dict(budget=128, top_k=5, per_table=128)),
])
def test_jax_checkpoint_restores_in_port(tmp_path, name, dtype, augment, kw):
    """A sharded checkpoint JAX wrote (int8 and bf16 slabs, the augmented
    scale) restores in the port, which then returns JAX's ids on it."""
    c = case(name)
    jp, _ = c.pack(dtype, 512, augment=augment)
    prefix = str(tmp_path / "jax_shidx")
    jax_ckpt.save_sharded_index(prefix, jp)
    pidx = checkpoint.load_sharded_index(prefix, PMESH)
    assert pidx.packed.dtype == getattr(torch, dtype)
    for f in ("sorted_rows", "bucket_starts", "packed", "packed_rows"):
        np.testing.assert_array_equal(to_np(getattr(pidx, f)), to_np(getattr(jp, f)))
    assert (pidx.packed_aug_scale is not None) == augment
    c.retrieve(jp, pidx, jax_kw=dict(pallas_interpret=True) if augment else None, **kw)
    # and the port's own save of it reads back the same
    paths = checkpoint.save_sharded_index(str(tmp_path / "again"), pidx)
    assert len(paths) == 9
    back = checkpoint.load_sharded_index(str(tmp_path / "again"), PMESH)
    assert torch.equal(back.packed, pidx.packed)
