"""S1, the stage-1 selection of K1's epilogue (`window_topk`), on tied
inputs: the port against the JAX package on the CPU.

JAX selects K1's dots with `lax.approx_max_k` (which off the TPU returns
`lax.top_k`'s answer) or `lax.top_k`: the k largest, equal values lowest
index first.  Every input here ties: integer-valued dots, or corpora of
duplicated integer rows, made with numpy from a seed.  Ids must be
exactly equal, in set and in order; scores of the same dots exactly
equal, scores the packages compute each from the slabs within rtol 1e-5
(summation order).  JAX's slab and cube kernels run in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu.models.lsh import hypercube as jax_cube
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.ops.pallas import slabscore as jax_slab
from crypto_rec_tpu_torch.models.lsh import hypercube as port_cube
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.ops.kernels import int4slab, slabscore
from crypto_rec_tpu_torch.ops.kernels.windowtopk import order_bits, window_topk
from crypto_rec_tpu_torch.ops.topk import topk_desc

from _torch_parity import cube_handover, handover, multicube_handover, probe_functions

CPU = torch.device("cpu")


def _int_rows(seed, shape, levels):
    return np.random.default_rng(seed).integers(0, levels, size=shape).astype(np.float32)


def _norm2_rows(rng, n, d):
    """n rows of four entries +-1 (norm 2): normalized, they are +-0.5, and
    quantized to int8 with one global scale +-127, so every cosine dot is
    exact in f32 in any summation order."""
    x = np.zeros((n, d), np.float32)
    cols = np.argsort(rng.random((n, d)), axis=1)[:, :4]
    np.put_along_axis(x, cols, rng.choice([-1.0, 1.0], size=(n, 4)).astype(np.float32), 1)
    return x


@pytest.mark.parametrize("m,k", [(488, 12), (488, 20), (640, 32), (256, 3),
                                 (5120, 80), (4096, 40)])
def test_window_topk_equals_jax_selections_on_ties(m, k):
    """Both JAX selections, `lax.top_k` and `lax.approx_max_k`, against
    `window_topk` on integer rows: same values, same indices."""
    v = _int_rows(m + k, (64, m), 5)
    got_v, got_i = window_topk(torch.from_numpy(v), k)
    assert got_i.dtype == torch.int64
    for sel in (jax.lax.top_k, jax.lax.approx_max_k):
        want_v, want_i = sel(jnp.asarray(v), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("m", [37, 640, 16384])
def test_order_bits_sort_is_the_plain_order(m):
    """The kernel's key (`order_bits` above ~index) sorted descending is
    `topk_desc`'s order, with +-0, +-inf and NaN of both signs in ties."""
    rng = np.random.default_rng(m)
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.5, -1.5, 3.0,
                     np.float32(1e-45), -np.float32(1e-45)], np.float32)
    v = torch.from_numpy(pool[rng.integers(0, len(pool), size=(6, m))])
    img = order_bits(v)
    assert int(img.min()) >= 0 and int(img.max()) <= 0xFFFFFFFF
    # image descending, index ascending: one stable sort of the negated image
    key_order = torch.sort(-img, dim=1, stable=True).indices
    vals, idx = topk_desc(v, m)
    assert torch.equal(key_order, idx)
    got_v, got_i = window_topk(v, m)
    assert torch.equal(got_i, idx)
    assert torch.equal(got_v.view(torch.int32), vals.view(torch.int32))   # -0.0 kept


@pytest.mark.parametrize("kw", [{}, {"stage1_per_table": 6}, {"stage1_width": 24}],
                         ids=["per-window", "stage1_per_table", "stage1_width"])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("top_k", [10, 20])
def test_slab_topk_equals_jax_on_integer_dots(exact, top_k, kw):
    """slab_topk on the same integer dots [64, 4, 256] as JAX's: exact=True
    (flat `lax.top_k`), production (per-window or flat `approx_max_k`)."""
    rng = np.random.default_rng(top_k)
    q, L, win, n_pad = 64, 4, 256, 4096
    dots = rng.integers(-3, 4, size=(q, L, win)).astype(np.float32)
    a0 = rng.integers(0, n_pad - win, size=(q, L)).astype(np.int32)
    rows = np.stack([rng.permutation(n_pad) for _ in range(L)]).astype(np.int32)
    want = jax_slab.slab_topk(jnp.asarray(dots), jnp.asarray(a0), jnp.asarray(rows),
                              n_pad, top_k, exact=exact, **kw)
    got = slabscore.slab_topk(torch.from_numpy(dots), torch.from_numpy(a0),
                              torch.from_numpy(rows), n_pad, top_k, exact=exact, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_slab_topk_int4_equals_jax_on_integer_dots():
    """P6's epilogue (per-window stage 1 with the halves lane mapping) on
    the same integer dots as the JAX probe's `slab_topk_int4`."""
    rng = np.random.default_rng(3)
    q, L, win, n_pad = 64, 4, 256, 4096
    dots = rng.integers(-3, 4, size=(q, L, win)).astype(np.float32)
    a0 = (rng.integers(0, (n_pad - win) // 64, size=(q, L)) * 64).astype(np.int32)
    rows = np.stack([rng.permutation(n_pad) for _ in range(L)]).astype(np.int32)
    want = probe_functions()["p6"].slab_topk_int4(
        jnp.asarray(dots), jnp.asarray(a0), jnp.asarray(rows), n_pad, 10)
    got = int4slab.slab_topk_int4(torch.from_numpy(dots), torch.from_numpy(a0),
                                  torch.from_numpy(rows), n_pad, 10)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def _dup_corpus(seed, n, d, patterns, q):
    """n rows drawn from `patterns` distinct integer rows; the queries are
    corpus rows, so each query's best score ties across its copies."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, size=(patterns, d)).astype(np.float32)
    x = base[rng.integers(0, patterns, size=n)]
    return x, x[rng.choice(n, size=q, replace=False)].copy()


@pytest.fixture(scope="module")
def dup_packed():
    x, qs = _dup_corpus(11, 2048, 64, 40, 32)
    jidx = jax_index.build_index(jax.random.PRNGKey(4), jnp.asarray(x), "cosine", k=4,
                                 L=4, lsh_bucket_div=4, euclidean_h_w=1.0)
    qb, _ = jax_index.query_hashes(jidx, jnp.asarray(qs))
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.int8, scale_mode="global",
                              pad=512)
    return dict(x=x, qs=qs, qb=qb, jp=jp,
                pp=port_index.index_from_numpy(*handover(jp), CPU))


@pytest.mark.parametrize("strict", [True, False])
def test_packed_retrieve_pallas_ties_equal_jax(dup_packed, strict):
    """Strict (masked windows, flat `lax.top_k`) and production (maskless,
    per-window `approx_max_k`) retrieval over int8 slabs of duplicated
    rows: ids exactly JAX's."""
    jp, pp = dup_packed["jp"], dup_packed["pp"]
    want = jax_slab.packed_retrieve_pallas(
        jp.packed, jp.packed_rows, None, jp.bucket_starts, jp.n_rows,
        jnp.asarray(dup_packed["qs"]), dup_packed["qb"], 10, 100, interpret=True,
        strict=strict)
    got = slabscore.packed_retrieve_pallas(
        pp.packed, pp.packed_rows, pp.bucket_starts, pp.n_rows,
        torch.from_numpy(dup_packed["qs"]), torch.from_numpy(np.array(dup_packed["qb"])),
        10, 100, strict=strict)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    assert (got[1].numpy()[:, :5] >= 0).all()


@pytest.mark.parametrize("budget", [30, 64])
@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_candidate_ids_scored_ties_equal_jax_on_64_queries(kind, budget):
    """candidate_ids_scored on 2,048 rows drawn from 300 distinct ones, 64
    queries, every dot exact in both packages (so every equal score is a
    tie in both): every set and order exactly JAX's."""
    rng = np.random.default_rng(5)
    base = _norm2_rows(rng, 300, 64)
    x = base[rng.integers(0, 300, size=2048)]
    qs = x[:64].copy()
    jidx = jax_index.build_index(jax.random.PRNGKey(1), jnp.asarray(x), "cosine", k=4,
                                 L=4, lsh_bucket_div=4, euclidean_h_w=1.0)
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(kind),
                              scale_mode="global")
    want = np.asarray(jax_index.candidate_ids_scored(jp, jnp.asarray(qs), budget=budget,
                                                     per_table=100))
    pidx = port_index.index_from_numpy(*handover(jp), CPU)
    got = port_index.candidate_ids_scored(pidx, torch.from_numpy(qs), budget=budget,
                                          per_table=100)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def dup_cube_data():
    """4,096 rows of 1,000 norm-2 patterns (d = 128): a query's own pattern
    has a few copies, and the next scores (patterns sharing entries with
    it) tie exactly across many rows and probed vertices, so the stage-1
    cut falls among ties that reach the top 10."""
    rng = np.random.default_rng(13)
    x = _norm2_rows(rng, 1000, 128)[rng.integers(0, 1000, size=4096)]
    qs = x[rng.choice(4096, size=24, replace=False)].copy()
    return dict(x=x, qs=qs, X=torch.from_numpy(x), QS=torch.from_numpy(qs))


def test_cosine_cube_flat_stage1_ties_equal_jax(dup_cube_data):
    """The single cosine cube's shared-slab branch (`_cube_retrieve_kernel`:
    a flat stage 1 of max(4 top_k, 16) lanes over probes x win) on
    duplicated rows: ids exactly JAX's."""
    d = dup_cube_data
    jc = jax_cube.build_hypercube(jax.random.PRNGKey(2), jnp.asarray(d["x"]), "cosine",
                                  6, 1.0)
    jp = jax_cube.pack_cube(jc, jnp.asarray(d["x"]), dtype=jnp.int8, pad=1024)
    want = jax_cube.cube_retrieve_topk(jp, jnp.asarray(d["qs"]), jnp.asarray(d["x"]),
                                       top_k=10, probes=16, per_probe=200)
    pp = port_cube.hypercube_from_numpy(*cube_handover(jp), CPU)
    got = port_cube.cube_retrieve_topk(pp, d["QS"], d["X"], top_k=10, probes=16,
                                       per_probe=200)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_multicube_per_window_stage1_ties_equal_jax(dup_cube_data, metric):
    """MultiCube (C = 2 cubes in one shared slab, `_shared_slab_topk`: the
    per-window stage 1) on duplicated rows: ids exactly JAX's."""
    d = dup_cube_data
    jm = jax_cube.build_multicube(jax.random.PRNGKey(5), jnp.asarray(d["x"]), metric, 2,
                                  6, 1.0 if metric == "cosine" else 6.0,
                                  corpus_dtype=jnp.int8, pad=1024)
    want = jax_cube.multicube_retrieve_topk(jm, jnp.asarray(d["qs"]), top_k=10, probes=8,
                                            per_probe=200)
    pm = port_cube.multicube_from_numpy(*multicube_handover(jm), CPU)
    got = port_cube.multicube_retrieve_topk(pm, d["QS"], top_k=10, probes=8, per_probe=200)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
