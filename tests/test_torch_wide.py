"""Wide rows and long selections: the port against the JAX package at the
shapes past what the card's kernels took before (K1 past d = 256, K2 past
what fits its shared memory, S1 past m = 32,768 and k = 1,024), on the CPU.

- K1 (`slab_window_dots`) against JAX's Pallas kernel (interpret mode):
  int8 / bf16 at d = 384 and 1,024, f32 at d = 15, 100 and 384, within
  rtol 1e-5 / atol 1e-6 of the largest |dot| (summation order over up to
  1,024 terms of up to 127 |q|); `candidate_ids_scored` on f32
  slabs at d = 15 (the program's coins), cosine `retrieve_topk` at
  d = 384, euclidean at d = 300 (augmented to 384), the cosine cube's flat
  stage 1 over 40 probes x 1,024 lanes on tied rows;
- K2 (`signproj_bucket_ids`) at d = 1,536, L = 8, k = 13 and at L = 80:
  ids equal away from projections at rounding distance of 0;
- plain-torch statements of the card's new schedules: K1's d-chunk loop
  (its staged, zero-padded 64-wide chunks, each 16-wide slice summed from
  zero and added in f32) and S1's two levels (`two_level` with plain
  selections in place of the launches) and radix select, against the
  plain versions and `lax.top_k` on tied rows;
- the envelope: the card route's own checks (plain Python, run here on
  CPU tensors) accept every shape the JAX functions accept.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu.models.lsh import hypercube as jax_cube
from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu.ops.pallas import signproj as jax_signproj
from crypto_rec_tpu.ops.pallas import slabscore as jax_slab
from crypto_rec_tpu_torch.models.lsh import hypercube as port_cube
from crypto_rec_tpu_torch.models.lsh import index as port_index
from crypto_rec_tpu_torch.ops.kernels import signproj, slabscore, windowtopk
from crypto_rec_tpu_torch.ops.kernels.windowtopk import (
    MAX_K, MAX_M, order_bits, segment_width, two_level,
)
from crypto_rec_tpu_torch.ops.topk import topk_desc

from _torch_parity import assert_topk_match, cube_handover, handover, to_np

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-4)
DT = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


def _slab_case(rng, dtype, T, n_pad, d, q):
    if dtype == "int8":
        packed = rng.integers(-127, 128, (T, n_pad, d)).astype(np.int8)
    else:
        packed = rng.normal(size=(T, n_pad, d)).astype(np.float32)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    starts = rng.integers(0, n_pad, (q, T)).astype(np.int32)
    sizes = rng.integers(0, 300, (q, T)).astype(np.int32)
    jp = jnp.asarray(packed).astype(jnp.dtype(dtype))
    return jp, queries, starts, sizes


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("dtype,d", [("int8", 384), ("int8", 1024), ("bfloat16", 384),
                                     ("bfloat16", 1024), ("float32", 15),
                                     ("float32", 100), ("float32", 384), ("int8", 100),
                                     ("bfloat16", 100)])
def test_k1_matches_jax_past_d256(dtype, d, mask):
    """K1 on slabs past d = 256, against the JAX kernel; the card route's
    checks take the shape and name the body that runs it."""
    rng = np.random.default_rng(d + len(dtype))
    T, n_pad, q, per_table = 2, 1024, 8, 200
    jp, queries, starts, sizes = _slab_case(rng, dtype, T, n_pad, d, q)
    want, a_want = jax_slab.slab_window_dots(jp, None, jnp.asarray(starts),
                                             jnp.asarray(sizes), jnp.asarray(queries),
                                             per_table=per_table, interpret=True, mask=mask)
    packed = torch.from_numpy(to_np(jp).copy()).to(DT[dtype])
    args = (packed, torch.from_numpy(starts), torch.from_numpy(sizes),
            torch.from_numpy(queries), per_table)
    got, a_got = slabscore.slab_window_dots(*args, mask=mask)
    np.testing.assert_array_equal(a_got.numpy(), np.asarray(a_want))
    want = np.asarray(want)
    scale = np.abs(want[np.isfinite(want)]).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * scale)
    slabscore.card_geometry(*args, mask, False)
    rt, m = slabscore.tile_shape(packed.dtype, d)
    assert m == 32 and rt == (32 if dtype == "float32" else 256)


# ---- K1's d-chunk loop, stated in plain torch ----

DC = 64          # the tensor-core body's d-chunk (csrc/slabtile.cu kDC)


def _slice_sums(terms, rows, slices, acc):
    """The tensor-core arithmetic over the given 16-wide slices, in order:
    each slice's three term products summed from zero in f32 (hi, then mid
    and lo onto it), then added to the running dots acc in f32."""
    for sl in slices:
        part = terms[:, 0, sl].float() @ rows[:, sl].float().T
        for t in (1, 2):
            part = part + terms[:, t, sl].float() @ rows[:, sl].float().T
        acc = acc + part
    return acc


def stream_dots(terms, rows, d):
    """K1's d-chunk loop: stage chunk c's rows and query terms zero-padded
    to DC columns, run its live slices (those that start before d), carry
    the dots to the next chunk."""
    acc = torch.zeros(terms.shape[0], rows.shape[0])
    for c0 in range(0, d, DC):
        w = min(DC, d - c0)
        r = torch.zeros(rows.shape[0], DC, dtype=rows.dtype)
        t = torch.zeros(terms.shape[0], 3, DC, dtype=terms.dtype)
        r[:, :w], t[:, :, :w] = rows[:, c0:c0 + w], terms[:, :, c0:c0 + w]
        ks = min(DC // 16, -(-w // 16))
        acc = _slice_sums(t, r, [slice(16 * j, 16 * j + 16) for j in range(ks)], acc)
    return acc


@pytest.mark.parametrize("dtype,d", [("int8", 384), ("int8", 1536), ("int8", 80),
                                     ("bfloat16", 392), ("bfloat16", 1024),
                                     ("int8", 128), ("bfloat16", 256), ("int8", 100),
                                     ("int8", 36), ("bfloat16", 100), ("int8", 15)])
def test_k1_stream_schedule_against_plain(dtype, d):
    """The chunk loop on integer rows and queries equals the plain dots
    exactly; on unit queries it stays within K1's tolerance of them; and
    at d % 64 == 0, d <= 256 the chunked sums are one pass over whole rows
    bit for bit (the same slices in the same order).  Rows that are not
    whole 16-byte chunks (d = 15, 36, 100) take the same loop: the last
    slice's columns past d are zero in the rows and in the query terms."""
    rng = np.random.default_rng(d)
    ints = torch.from_numpy(rng.integers(-127, 128, (96, d)).astype(np.int8)).to(DT[dtype])
    qi = torch.from_numpy(rng.integers(-3, 4, (32, d)).astype(np.float32))
    got = stream_dots(slabscore.split_bf16x3(qi), ints, d)
    assert torch.equal(got, qi @ ints.float().T)
    rows = ints if dtype == "int8" else torch.from_numpy(
        rng.normal(size=(96, d)).astype(np.float32)).bfloat16()
    qf = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(32, d)).astype(np.float32)), dim=1)
    terms = slabscore.split_bf16x3(qf)
    got = stream_dots(terms, rows, d)
    assert torch.allclose(got, qf @ rows.float().T, **TOL)
    if d % 64 == 0 and d <= 256:
        one = _slice_sums(terms, rows, [slice(16 * j, 16 * j + 16) for j in range(d // 16)],
                          torch.zeros(32, 96))
        assert torch.equal(got, one)


# ---- the paths at wide rows, against JAX ----

def test_candidate_ids_scored_f32_d15_matches_jax():
    """The program's own 15 coins on f32 slabs (the fused CV engine's
    candidate sets): d = 15 rows, not 16-byte aligned, the FFMA body."""
    rng = np.random.default_rng(15)
    n, d, q = 2048, 15, 32
    x = (2.0 * rng.normal(size=(32, d))[rng.integers(0, 32, n)]
         + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    qs = (x[:q] + 0.1 * rng.normal(size=(q, d))).astype(np.float32)
    jidx = jax_index.build_index(jax.random.PRNGKey(3), jnp.asarray(x), "cosine", k=4,
                                 L=4, lsh_bucket_div=4, euclidean_h_w=1.0)
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.float32)
    want = jax_index.candidate_ids_scored(jp, jnp.asarray(qs), budget=64, per_table=100)
    pidx = port_index.index_from_numpy(*handover(jp), CPU)
    got = port_index.candidate_ids_scored(pidx, torch.from_numpy(qs), budget=64,
                                          per_table=100)
    qv = torch.nn.functional.normalize(torch.from_numpy(qs), dim=1)
    rows = torch.nn.functional.normalize(torch.from_numpy(x), dim=1)

    def scores(ids):
        s = torch.einsum("qd,qkd->qk", qv, rows[torch.clamp(ids, min=0).long()])
        return torch.where(ids >= 0, s, float("-inf"))

    w = torch.from_numpy(np.asarray(want).copy())
    assert_topk_match(to_np(scores(w)), to_np(w), to_np(scores(got)), to_np(got),
                      rtol=1e-5, atol=1e-5)
    slabscore.card_geometry(pidx.packed, torch.zeros(q, 4, dtype=torch.int32),
                            None, qv, 100, False, False)


@pytest.fixture(scope="module")
def wide_corpus():
    """Clustered rows with planted neighbours: each query's 10 nearest are
    rows [10 i, 10 i + 10), the query plus 0.05 N(0, 1), far inside the
    rest (cluster points at 0.5 N(0, 1)), so the top 10 sit clear of the
    ties that quantized dots make among the cluster."""
    rng = np.random.default_rng(384)
    n, q = 2048, 16
    out = {}
    for d in (384, 300):
        centers = 2.0 * rng.normal(size=(32, d))
        x = (centers[rng.integers(0, 32, n)] + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
        qs = (centers[rng.integers(0, 32, q)] + 0.5 * rng.normal(size=(q, d))).astype(np.float32)
        x[:10 * q] = np.repeat(qs, 10, axis=0) + 0.05 * rng.normal(size=(10 * q, d))
        out[d] = (x, qs)
    return out


def test_cosine_retrieve_topk_d384_matches_jax(wide_corpus):
    """Cosine int8 slabs at d = 384 take the K1 branch
    (`retrieve_topk_pallas`: d % 128 == 0)."""
    x, qs = wide_corpus[384]
    jidx = jax_index.build_index(jax.random.PRNGKey(4), jnp.asarray(x), "cosine", k=4,
                                 L=3, lsh_bucket_div=4, euclidean_h_w=1.0)
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.int8, pad=1024)
    want = jax_index.retrieve_topk(jp, jnp.asarray(qs), jnp.asarray(x), top_k=10,
                                   per_table=200)
    pidx = port_index.index_from_numpy(*handover(jp), CPU)
    assert pidx.packed.shape[-1] == 384
    got = port_index.retrieve_topk(pidx, torch.from_numpy(qs), torch.from_numpy(x),
                                   top_k=10, per_table=200)
    assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)


def test_euclidean_retrieve_topk_d300_matches_jax(wide_corpus):
    """Euclidean rows of d = 300 pack to augmented int8 slabs of d_aug =
    384 and ride K1 (`packed_retrieve_pallas_euclid`); scores compared
    squared, atol 1e-5 |q|^2 (the rank cancels two terms of that size)."""
    x, qs = wide_corpus[300]
    jidx = jax_index.build_index(jax.random.PRNGKey(5), jnp.asarray(x), "euclidean", k=3,
                                 L=3, lsh_bucket_div=16, euclidean_h_w=30.0)
    jp = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.int8, pad=1024,
                              augment=True)
    want = jax_index.retrieve_topk(jp, jnp.asarray(qs), jnp.asarray(x), top_k=10,
                                   per_table=200)
    pidx = port_index.index_from_numpy(*handover(jp), CPU)
    assert pidx.packed.shape[-1] == 384
    got = port_index.retrieve_topk(pidx, torch.from_numpy(qs), torch.from_numpy(x),
                                   top_k=10, per_table=200)
    assert_topk_match(-np.asarray(want[0]) ** 2, want[1], -got[0].numpy() ** 2, got[1],
                      rtol=1e-5, atol=1e-5 * float((qs ** 2).sum(1).max()))


def plain_segments(values, k):
    """S1's first level stated in plain torch: each MAX_M-lane segment's
    top min(k, length) by `topk_desc`, laid end to end, indices in the
    row."""
    vs, ix = [], []
    for s in range(0, values.shape[1], MAX_M):
        v, i = topk_desc(values[:, s:s + MAX_M], min(k, values.shape[1] - s))
        vs.append(v)
        ix.append(i + s)
    return torch.cat(vs, 1), torch.cat(ix, 1)


def plain_two_level(values, k):
    return two_level(values, k, topk_desc, plain_segments)


def test_cube_flat_stage1_past_32768_lanes_ties_equal_jax(monkeypatch):
    """The single cosine cube at 40 probes x per_probe 992 (win 1,024): its
    flat stage 1 selects over 40,960 lanes, past one S1 launch.  On rows
    of duplicated norm-2 patterns (every dot exact in both packages, ties
    across rows and vertices), the card's two-level schedule stated in
    plain torch returns JAX's ids exactly."""
    rng = np.random.default_rng(41)
    base = np.zeros((600, 128), np.float32)
    cols = np.argsort(rng.random((600, 128)), axis=1)[:, :4]
    np.put_along_axis(base, cols, rng.choice([-1.0, 1.0], size=(600, 4)).astype(np.float32),
                      1)
    x = base[rng.integers(0, 600, size=4096)]
    qs = x[rng.choice(4096, size=6, replace=False)].copy()
    jc = jax_cube.build_hypercube(jax.random.PRNGKey(6), jnp.asarray(x), "cosine", 6, 1.0)
    jp = jax_cube.pack_cube(jc, jnp.asarray(x), dtype=jnp.int8, pad=1024)
    want = jax_cube.cube_retrieve_topk(jp, jnp.asarray(qs), jnp.asarray(x), top_k=10,
                                       probes=40, per_probe=992)
    pp = port_cube.hypercube_from_numpy(*cube_handover(jp), CPU)
    widths = []

    def stage1(values, k):
        widths.append(values.shape[1])
        return plain_two_level(values, k)

    monkeypatch.setattr(port_cube, "window_topk", stage1)
    got = port_cube.cube_retrieve_topk(pp, torch.from_numpy(qs), torch.from_numpy(x),
                                       top_k=10, probes=40, per_probe=992)
    assert widths == [40 * 1024]
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)


# ---- S1's schedules past one launch, stated in plain torch ----

def _tied_rows(seed, R, m):
    """Integer levels with +-0, +-inf, NaN and -inf runs."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-4, 5, size=(R, m)).astype(np.float32)
    u = rng.integers(0, 1000, size=(R, m))
    v[(v == 0) & (u % 2 == 1)] = -0.0
    v[u < 2] = np.nan
    v[(u >= 2) & (u < 4)] = np.inf
    v[(u >= 4) & (u < 40)] = -np.inf
    v[1::4] = np.where(u[1::4] < 990, -np.inf, v[1::4])       # short masked rows
    return torch.from_numpy(v)


@pytest.mark.parametrize("m,k", [(40960, 40), (131072, 40), (65537, 1024), (32769, 3),
                                 (70000, 7)])
def test_s1_two_levels_equal_topk_desc_and_lax_top_k(m, k):
    """`two_level` with plain selections in place of its launches: bit for
    bit `topk_desc`'s answer, and `lax.top_k`'s indices, on tied rows; the
    first level keeps `segment_width` entries a row."""
    v = _tied_rows(m + k, 6, m)
    got = plain_two_level(v, k)
    want = topk_desc(v, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert plain_segments(v, k)[0].shape[1] == segment_width(m, k)
    # lax.top_k on integer rows (it orders +0.0 before -0.0, topk_desc ties them)
    vi = torch.from_numpy(np.random.default_rng(m).integers(-4, 5, (6, m)).astype(np.float32))
    _, li = jax.lax.top_k(jnp.asarray(vi.numpy()), k)
    np.testing.assert_array_equal(plain_two_level(vi, k)[1].numpy(), np.asarray(li))


def radix_select(values, k):
    """The card's k > MAX_K schedule (`radix_rows`) in plain torch: four
    8-bit passes over the order images find the k-th largest image T and
    how many images equal to it are taken (lowest index first, beside all
    images above it); those k sorted by (image desc, index asc), the
    order of the kernel's keys image << 32 | ~index."""
    img = order_bits(values)
    out_v, out_i = [], []
    for r in range(values.shape[0]):
        prefix, mask, rest = 0, 0, k
        for shift in (24, 16, 8, 0):
            match = (img[r] & mask) == prefix
            hist = torch.bincount((img[r][match] >> shift) & 255, minlength=256)
            above, b = 0, 255
            while b > 0 and above + int(hist[b]) < rest:
                above += int(hist[b])
                b -= 1
            prefix |= b << shift
            mask |= 255 << shift
            rest -= above
        take = (img[r] > prefix) | ((img[r] == prefix)
                                    & (torch.cumsum(img[r] == prefix, 0) <= rest))
        idx = torch.nonzero(take)[:, 0]              # ascending: ties lowest index first
        assert idx.numel() == k
        i = idx[torch.sort(img[r][idx], descending=True, stable=True).indices]
        out_i.append(i)
        out_v.append(values[r, i])
    return torch.stack(out_v), torch.stack(out_i)


@pytest.mark.parametrize("m,k", [(8192, 2048), (2049, 2049), (40960, 1500)])
def test_s1_radix_select_equals_topk_desc(m, k):
    v = _tied_rows(m * 3 + k, 5, m)
    got = radix_select(v, k)
    want = topk_desc(v, k)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


# ---- K2 at wide rows and many tables ----

@pytest.mark.parametrize("n,d,k,L", [(600, 1536, 13, 8), (900, 128, 13, 80),
                                     (300, 768, 22, 64)])
def test_signproj_wide_matches_jax(n, d, k, L):
    """Ids equal JAX's (interpret mode) away from projections within 1e-4
    |x||r| of 0; the card route's checks take the shape.  (k <= 24: JAX
    packs the bits with an f32 product, exact below 2^24.)"""
    rng = np.random.default_rng(d + L)
    x = rng.normal(size=(n, d)).astype(np.float32)
    proj = rng.normal(size=(d, L * k)).astype(np.float32)
    want = np.asarray(jax_signproj.signproj_bucket_ids(jnp.asarray(x), jnp.asarray(proj),
                                                       k=k, L=L, interpret=True))
    xt, pt = torch.from_numpy(x), torch.from_numpy(proj)
    got = signproj.signproj_bucket_ids(xt, pt, k, L).numpy()
    acc = np.abs(x @ proj) <= 1e-4 * np.linalg.norm(x, axis=1)[:, None] * np.linalg.norm(
        proj, axis=0)[None, :]
    near = acc.reshape(n, L, k).any(-1)
    assert ((got == want) | near).all()
    signproj.check_signproj(xt, pt, k, L)


# ---- the envelope: the card's checks accept whatever JAX accepts ----

def jax_k1_accepts(dtype, d, win):
    """JAX's slab_window_dots at its defaults (nbuf 4): the fused form
    shrinks, then falls back to the per-window kernel, which raises only
    past its VMEM guard (crypto_rec_tpu/ops/pallas/slabscore.py:305-316)."""
    return 4 * win * d * DT[dtype].itemsize <= jax_slab._VMEM_SCRATCH_BUDGET


@pytest.mark.parametrize("dtype", list(DT))
def test_k1_card_checks_accept_what_jax_accepts(dtype):
    seen = 0
    for d in (15, 16, 48, 100, 128, 200, 256, 300, 384, 392, 512, 768, 960, 1024, 1025,
              1536, 2048, 2560):
        for win in (128, 256, 512, 1024):
            if not jax_k1_accepts(dtype, d, win):
                continue
            packed = torch.empty(2, win + 64, d, dtype=DT[dtype])
            starts = torch.zeros(3, 2, dtype=torch.int32)
            sizes = torch.full((3, 2), 5, dtype=torch.int32)
            queries = torch.zeros(3, d)
            for mask in (True, False):       # per_table win - 32: windows of win lanes
                slabscore.card_geometry(packed, starts, sizes, queries, win - 32,
                                        mask, False)
            slabscore.card_geometry(packed[:1].contiguous(), starts, None, queries,
                                    win - 32, False, True)
            rt, m = slabscore.tile_shape(DT[dtype], d)
            assert (rt, m) == ((32, 32) if dtype == "float32" else (256, 32))
            seen += 1
    assert seen >= 40


@pytest.mark.parametrize("dtype", list(DT))
def test_row_slab_takes_states_check_row_slab(dtype):
    """The row-slab limit (`row_slab_takes`) is exactly where
    `check_row_slab`, the check the tile-major probe kernels' wrappers make
    before their launch, raises: d % 16 == 0, at most 2,048 B a row."""
    for d in (15, 16, 100, 128, 256, 384, 512, 1024, 1536, 2048, 2560):
        packed = torch.zeros(1, 4, d, dtype=DT[dtype])
        try:
            slabscore.check_row_slab("K1", packed, torch.zeros(2, 1), torch.zeros(2, d),
                                     slabscore._DTYPE_CODE)
            raised = False
        except ValueError:
            raised = True
        assert slabscore.row_slab_takes(DT[dtype], d) == (not raised)
        assert raised == (d % 16 != 0 or d * DT[dtype].itemsize > 2048)


@pytest.mark.parametrize("d,k,L", [(128, 13, 8), (128, 13, 1), (16, 4, 5), (15, 4, 5),
                                   (256, 13, 8), (384, 13, 8), (768, 13, 8), (1536, 13, 8),
                                   (128, 30, 16), (64, 7, 256), (64, 1, 257), (1024, 1, 56)])
def test_card_k2_takes_every_shape(d, k, L):
    """The card's K2 takes any d and any L (it streams proj beside x and
    splits the tables into groups): `check_signproj` accepts float32
    x [2, d] and proj [d, L k] at every shape, and raises at k = 31, past
    the 30 bits of an int32 bucket id."""
    signproj.check_signproj(torch.zeros(2, d), torch.zeros(d, L * k), k, L)
    with pytest.raises(ValueError, match="30 bits"):
        signproj.check_signproj(torch.zeros(2, d), torch.zeros(d, L * 31), 31, L)


def test_k1_card_checks_raise_where_jax_or_the_cpu_path_raises():
    """The card route raises on a window longer than the slab, a scale with
    shared_slab (both as JAX does) and mask=True without sizes (as the CPU
    path does); each call raises on the CPU too."""
    packed = torch.zeros(2, 300, 384, dtype=torch.int8)
    starts = torch.zeros(3, 2, dtype=torch.int32)
    q = torch.zeros(3, 384)
    bad = [
        ((packed, starts, starts, q, 400, True, False), "exceeds"),
        ((packed[:1].contiguous(), starts, starts, q, 100, False, True,
          torch.ones(1, 300)), "shared_slab"),
        ((packed, starts, None, q, 100, True, False), "sizes"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            slabscore.card_geometry(*args)
        with pytest.raises(ValueError, match=match):
            slabscore.slab_window_dots(*args[:5], mask=args[5], shared_slab=args[6],
                                       packed_scale=args[7] if len(args) > 7 else None)


def test_s1_card_checks_accept_every_k_up_to_m():
    """`lax.top_k` takes any 1 <= k <= m; so does the card's S1."""
    for m in (1, 37, 1024, 32768, 32769, 40960, 131072, 1 << 20):
        for k in sorted({1, 32, 33, 1024, 1025, 2048, m // 2, m} - {0}):
            if k <= m:
                windowtopk.check_window_topk(torch.empty(4, m, device="meta"), k)
    with pytest.raises(ValueError):
        windowtopk.check_window_topk(torch.empty(4, 10, device="meta"), 11)
    assert MAX_M == 32768 and MAX_K == 1024


@pytest.mark.parametrize("d", [16, 128, 384, 960, 1536, 4096])
@pytest.mark.parametrize("k,L", [(13, 8), (13, 64), (13, 80), (30, 64), (1, 200), (4, 1)])
def test_k2_card_checks_accept_any_width_and_table_count(d, k, L):
    """JAX's signproj takes any d and L (crypto_rec_tpu/ops/pallas/
    signproj.py:61); so do the card's checks."""
    signproj.check_signproj(torch.empty(8, d, device="meta"),
                            torch.empty(d, L * k, device="meta"), k, L)
