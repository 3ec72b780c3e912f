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


# ---------------------------------------------------------------------------
# S1's threshold selection (csrc/windowtopk.cu) stated in plain torch: the
# same bound, counts, cap, bisection and tie path as the kernel, row by
# row, held against topk_desc and JAX's lax.top_k on the CPU.

WARP_CAP = 64          # kWarpCap: candidates a warp row sorts
TWO_MAX_K = 20         # kTwoMaxK: warp rows read second maxima above this k
BLOCK_GEOMETRY = [(1024, 128, 8), (2048, 128, 16), (4096, 256, 16), (6144, 256, 24),
                  (8192, 256, 32), (16384, 512, 32), (32768, 1024, 32)]


def _s1_geometry(m, k):
    """-> (threads a row, images a thread, candidate cap, warp rows?)."""
    if m <= 1024 and k <= 32:
        return 32, (m + 127) // 128 * 4, WARP_CAP, True
    nt, per = next((nt, per) for mmax, nt, per in BLOCK_GEOMETRY if m <= mmax)
    return nt, per, max(128, 2 * k), False


def _desc(x, dim=-1):
    return torch.sort(x, dim=dim, descending=True).values


def _s1_lower_bound(grid, k, warp):
    """The kernel's sound lower bound on each row's k-th largest image.
    grid [R, PER, NT]: image of index j * NT + t at [:, j, t], 0 past m."""
    lane_max = grid.max(1).values                                  # [R, NT]
    R, nt = lane_max.shape
    lo = torch.ones(R, dtype=torch.int64)
    if warp:
        lo = torch.maximum(lo, _desc(lane_max)[:, k - 1])
        if k > TWO_MAX_K:      # ceil(k / 2) lanes hold two images >= this
            second = _desc(grid, 1)[:, 1]
            lo = torch.maximum(lo, _desc(second)[:, (k + 1) // 2 - 1])
        return lo
    lists = _desc(lane_max.view(R, nt // 32, 32))                  # each warp's, descending
    for c in range(1, nt // 32 + 1):  # c warps hold ceil(k / c) lane maxima >= this
        jj = -(-k // c)
        if jj <= 32:
            lo = torch.maximum(lo, _desc(lists[:, :, jj - 1])[:, c - 1])
    return lo


def s1_threshold_select(values, k):
    """-> (values [R, k], indices [R, k], the path each row took): the
    kernel's algorithm.  A lower bound lo from the lanes' maxima; if at
    most `cap` images are >= lo, sort those (sort); else if fewer than k
    are > lo, lo is the k-th largest: take every image > lo, then images
    == lo lowest index first (tie); else bisect over (lo, row max] until
    one of the two holds (bisect + the path it ended in)."""
    R, m = values.shape
    nt, per, cap, warp = _s1_geometry(m, k)
    img = torch.zeros(R, per * nt, dtype=torch.int64)
    img[:, :m] = order_bits(values)
    lo_all = _s1_lower_bound(img.view(R, per, nt), k, warp)
    out_v = torch.empty(R, k, dtype=values.dtype)
    out_i = torch.empty(R, k, dtype=torch.int64)
    paths = []
    for r in range(R):
        row, lo = img[r, :m], int(lo_all[r])
        ge, gt = int((row >= lo).sum()), int((row > lo).sum())
        assert ge >= k, "the bound must be sound"
        path = ""
        if ge > cap and gt >= k:
            path, c_lo, hi, lo = "bisect+", gt, int(row.max()) + 1, lo + 1
            while c_lo > cap and hi - lo > 1:
                mid = lo + (hi - lo) // 2
                c = int((row >= mid).sum())
                lo, c_lo, hi = (mid, c, hi) if c >= k else (lo, c_lo, mid)
            ge, gt = int((row >= lo).sum()), int((row > lo).sum())
        if ge <= cap:
            path += "sort"
            cand = torch.nonzero(row >= lo).flatten()
        else:
            path += "tie"
            assert gt < k
            cand = torch.cat([torch.nonzero(row > lo).flatten(),
                              torch.nonzero(row == lo).flatten()[:k - gt]])
        cand = torch.sort(cand).values          # key = image above ~index
        cand = cand[torch.sort(-row[cand], stable=True).indices][:k]
        out_v[r], out_i[r] = values[r, cand], cand
        paths.append(path)
    return out_v, out_i, paths


def _special_rows(rng, R, m):
    """Rows of +-0, NaN of both signs, +-inf runs and a few integers."""
    pool = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1.0, -1.0, 2.0],
                    np.float32)
    v = pool[rng.integers(0, len(pool), size=(R, m))]
    for r in range(R):                          # a run of -inf and one of +inf
        a = rng.integers(0, m)
        v[r, a:a + rng.integers(1, m // 2 + 2)] = -np.inf if r % 2 else np.inf
    return v


def _cap_tie_rows(rng, R, m, k, cap):
    """More than `cap` images equal at the threshold, a few above it."""
    v = rng.integers(-50, 0, size=(R, m)).astype(np.float32)
    for r in range(R):
        at = rng.choice(m, size=min(m, cap + 1 + r), replace=False)
        v[r, at] = 7.0
        v[r, at[:r % k]] = 9.0                  # 0 .. k - 1 above the tie
    return v


def _lane_skewed_rows(rng, R, m):
    """Continuous rows whose largest values sit in 4 lanes of each warp, so
    the bound from lane maxima is weak and the bisection runs."""
    v = rng.standard_normal((R, m)).astype(np.float32)
    v[:, (np.arange(m) % 32) < 4] += 10.0
    return v


S1_LOGIC_CASES = [  # (kind, m, k): warp rows, block rows, k = 1, k = m, k past 32
    ("ints", 640, 12), ("ints", 1024, 10), ("ints", 896, 20), ("ints", 640, 32),
    ("ints", 37, 37), ("ints", 300, 1), ("ints", 640, 80), ("ints", 1025, 40),
    ("ints", 5120, 80), ("ints", 16384, 40), ("ints", 2048, 1024),
    ("special", 640, 12), ("special", 488, 32), ("special", 100, 100),
    ("special", 1024, 1), ("special", 5120, 40), ("special", 1500, 1024),
    ("equal", 640, 12), ("equal", 1024, 32), ("equal", 64, 64), ("equal", 8192, 256),
    ("cap_ties", 640, 12), ("cap_ties", 1024, 32), ("cap_ties", 4096, 40),
    ("cap_ties", 640, 50),
    ("skewed", 640, 12), ("skewed", 1024, 20), ("skewed", 5120, 40), ("skewed", 2048, 33),
    ("normal", 640, 12), ("normal", 640, 32), ("normal", 16384, 40),
]


def _logic_rows(kind, m, k, seed):
    rng = np.random.default_rng(seed)
    R = 6 if m > 4096 else 16
    if kind == "ints":
        return rng.integers(-4, 5, size=(R, m)).astype(np.float32)
    if kind == "special":
        return _special_rows(rng, R, m)
    if kind == "equal":
        return np.full((R, m), rng.choice([0.0, -1.5, 3.0]), np.float32)
    if kind == "cap_ties":
        return _cap_tie_rows(rng, R, m, k, _s1_geometry(m, k)[2])
    if kind == "skewed":
        return _lane_skewed_rows(rng, R, m)
    return rng.standard_normal((R, m)).astype(np.float32)


@pytest.mark.parametrize("kind,m,k", S1_LOGIC_CASES)
def test_s1_threshold_select_equals_topk_desc(kind, m, k):
    """The kernel's selection stated in plain torch returns topk_desc's
    answer bit for bit (values and indices) and, on rows without NaN or
    signed zeros, JAX's lax.top_k's."""
    v = _logic_rows(kind, m, k, seed=m * 31 + k)
    t = torch.from_numpy(v)
    got_v, got_i, paths = s1_threshold_select(t, k)
    want_v, want_i = topk_desc(t, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    if kind in ("ints", "cap_ties", "skewed", "normal") or (kind == "equal" and v[0, 0] != 0):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(jv))
    if kind in ("cap_ties", "equal") and k < m:
        assert all(p.endswith("tie") for p in paths), paths
    if kind == "skewed":
        assert all(p.startswith("bisect+") for p in paths), paths


def test_s1_threshold_select_reaches_every_path():
    """Across the cases above every path of the kernel runs, on warp rows
    and on block rows: sort, tie, and the bisection ending in each."""
    seen = set()
    for kind, m, k in S1_LOGIC_CASES:
        paths = s1_threshold_select(torch.from_numpy(_logic_rows(kind, m, k, m * 31 + k)),
                                    k)[2]
        seen |= {(_s1_geometry(m, k)[3], p) for p in paths}
    for warp in (True, False):
        assert {(warp, p) for p in ("sort", "tie", "bisect+sort")} <= seen, seen
