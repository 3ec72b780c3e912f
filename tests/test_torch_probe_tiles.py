"""The tensor-core P3 and P6 bodies' schedules and combine, on the CPU.

The CUDA kernel (csrc/probetile.cu) runs only on the card, so its pieces
are stated and checked here in plain torch:

- the schedule: each tile's range of pairs sorted by first row
  (`tile_ranges`), which the kernel finds on the device (`tile_bounds`,
  transliterated here), covers every (pair, tile) meeting once;
- P6: that schedule, in packed rows, drives an emulation that unpacks each
  tile once (hi nibbles, then lo nibbles), dots it with chunks of 16 pairs'
  queries through the three-term bf16 split, and writes each pair's lanes
  in the halves layout; it must agree with
  `slab_window_dots_int4_plain` within the dot tolerance (rtol 1e-5, atol
  1e-4: the split and the summation order), with every lane written once
  and the aligned starts exact;
- P3: the combine key (`bin_key` / `bin_unkey`) orders -inf, negatives,
  both zeros and ties as the plain version's max and lowest row do;
- P3: the schedule (tiles and their chunks of 16 pairs), its per-(pair,
  bin) pre-reduction and the max combine of the keys, fed the plain
  version's dots, must equal `binned_dots_plain` exactly, vals and pos bit
  for bit, ties included; one integer-valued case also equals the JAX
  probe in interpret mode;
- the domain the tensor-core wrappers check before they launch: int8 and
  bf16 slabs (P3) or uint8 (P6) with d % 64 == 0 and d <= 256; f32 slabs
  and other widths raise, though the plain versions take them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu_torch.ops.kernels import binned, int4slab
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _check_tile_slab, _geometry, probe_tile_rows, slab_window_dots_plain, split_bf16x3,
)

from _torch_parity import probe_functions

TOL = dict(rtol=1e-5, atol=1e-4)
M = 16            # pairs a chunk (csrc/probetile.cu kM)
PT = 200          # per_table: windows of 256 lanes (int4: 384)

# name -> (T, n_pad, d, q, how the starts are drawn)
CASES = {
    "heavy sharing": (4, 2048, 128, 90, "few"),
    "sparse": (2, 8192, 128, 7, "uniform"),
    "last tile cut, d256": (3, 2048 - 96, 256, 40, "end"),
    "d256": (2, 2048, 256, 30, "uniform"),
}


def _starts(rng, how, q, T, n_pad):
    if how == "few":           # most windows on a few buckets
        return rng.integers(0, 3, (q, T)) * 500
    if how == "end":           # windows clamped to end inside the slab
        return rng.integers(n_pad - 300, n_pad, (q, T))
    return rng.integers(0, n_pad, (q, T))


def _case(name, seed, integer=False):
    T, n_pad, d, q, how = CASES[name]
    rng = np.random.default_rng(seed)
    if integer:                # exact dots, frequent ties
        p8 = rng.integers(-2, 3, (T, n_pad, d)).astype(np.int8)
        qv = rng.integers(-1, 2, (q, d)).astype(np.float32)
    else:
        p8 = rng.integers(-127, 128, (T, n_pad, d)).astype(np.int8)
        qv = rng.normal(size=(q, d)).astype(np.float32)
        qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    starts = _starts(rng, how, q, T, n_pad).astype(np.int32)
    return torch.from_numpy(p8), torch.from_numpy(starts), torch.from_numpy(qv)


# ---- the schedule and the key, as csrc/probetile.cu computes them ----

def tile_ranges(row0: torch.Tensor, span: int, n_rows: int, rt: int):
    """The tensor-core probe kernels' schedule (`tile_bounds` in
    csrc/probetile.cu).  row0: [P] first rows of the windows [row0, row0 +
    span) in a flat slab of n_rows rows, cut into tiles of rt rows.  Sorted
    by row0, the pairs whose windows meet tile j are the positions
    [lo_j, hi_j): lo_j the first row0 > j rt - span, hi_j the first row0 >=
    (j + 1) rt.

    -> (pairs [P] int64 in row0 order, sorted row0 [P], lo, hi [n_tiles])."""
    sr, order = torch.sort(row0.reshape(-1))
    t0 = torch.arange(0, -(-n_rows // rt) * rt, rt, device=row0.device,
                      dtype=row0.dtype)
    lo, hi = torch.searchsorted(sr, torch.stack([t0 - (span - 1), t0 + rt]))
    return order, sr, lo, hi


def bin_key(vals: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """P3's combine key (`bin_key` in csrc/probetile.cu): the dot as an
    order-preserving unsigned in the high word (-0 as +0), 0xFFFFFFFF - p
    in the low one, so the larger key holds the larger dot and, among equal
    dots, the lower flat lane p (within a bin, the lower row).  The
    kernel's key is unsigned; this is it less 2^63, so int64 order is its
    order.  -> int64 keys of vals' shape."""
    v = torch.where(vals == 0, torch.zeros_like(vals), vals.float())
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    enc = torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | 1 << 31)
    return ((enc - (1 << 31)) << 32) | (0xFFFFFFFF - pos.to(torch.int64))


def bin_unkey(keys: torch.Tensor):
    """`bin_key`'s inverse (`bin_decode`) -> (vals f32, pos int32)."""
    enc = (keys >> 32) + (1 << 31)
    u = torch.where(enc >= 1 << 31, enc - (1 << 31), 0xFFFFFFFF - enc)
    u = torch.where(u >= 1 << 31, u - (1 << 32), u)
    return (u.to(torch.int32).view(torch.float32),
            (0xFFFFFFFF - (keys & 0xFFFFFFFF)).to(torch.int32))


# ---- P6 ----

def chunks(row0, span, n_rows, rt):
    """The tile-major kernels' blocks and chunks: -> [(first tile row,
    pair ids, their row0)] for every chunk of at most M sorted pairs of
    every tile (`tile_ranges`)."""
    order, sr, lo, hi = tile_ranges(row0, span, n_rows, rt)
    return [(j * rt, order[c:min(c + M, e)], sr[c:min(c + M, e)])
            for j, (s, e) in enumerate(zip(lo.tolist(), hi.tolist()))
            for c in range(s, e, M)]


def emulate_int4(p4, starts, queries, per_table):
    """The tile-major P6 in plain torch -> (dots [q, T, win] f32, aligned,
    writes [q, T, win]: how often each lane was written)."""
    win, aligned, row0 = int4slab._geometry4(p4, starts, per_table)
    q, T = starts.shape
    d = p4.shape[2]
    win2 = win // 2
    flat = p4.reshape(-1, d).to(torch.int32)
    n_rows = flat.shape[0]
    nib = torch.cat([(((flat >> 4) ^ 8) - 8), (((flat & 15) ^ 8) - 8)], 1).float()
    terms = split_bf16x3(queries)                                # [q, 3, d]
    rt = probe_tile_rows(d) // 2
    dots = torch.full((q * T, win), float("nan"))
    writes = torch.zeros(q * T, win, dtype=torch.int64)
    for t0, p, r0 in chunks(row0, win2, n_rows, rt):
        rows = torch.arange(t0, min(t0 + rt, n_rows))
        staged = torch.cat([nib[rows, :d], nib[rows, d:]])       # hi rows, then lo rows
        block = sum(terms[p // T, t].float() @ staged.T for t in range(3))
        j = rows[None, :] - r0.long()[:, None]
        pi, ri = torch.nonzero((j >= 0) & (j < win2), as_tuple=True)
        for half in range(2):
            dots[p[pi], half * win2 + j[pi, ri]] = block[pi, half * len(rows) + ri]
            writes[p[pi], half * win2 + j[pi, ri]] += 1
    return dots.reshape(q, T, win), aligned, writes.reshape(q, T, win)


@pytest.mark.parametrize("case", list(CASES))
def test_int4_tile_schedule_matches_plain(case):
    p8, starts, qv = _case(case, list(CASES).index(case))
    p4 = int4slab.repack_int4(p8)
    got, a_got, writes = emulate_int4(p4, starts, qv, PT)
    want, a_want = int4slab.slab_window_dots_int4_plain(p4, starts, qv, PT)
    assert torch.equal(a_got, a_want)
    assert torch.equal(writes, torch.ones_like(writes))
    torch.testing.assert_close(got, want, **TOL)
    if case == "heavy sharing":    # some tile walks more than one chunk
        _, _, row0 = int4slab._geometry4(p4, starts, PT)
        _, _, lo, hi = tile_ranges(row0, got.shape[2] // 2, p4.shape[0] * p4.shape[1],
                                   probe_tile_rows(p4.shape[2]) // 2)
        assert int((hi - lo).max()) > M


def tile_bounds(sr, span, rt, n_tiles):
    """`tile_bounds` of csrc/probetile.cu in Python: sorted position i is
    lo_j for row0[i - 1] + span <= j rt < row0[i] + span and hi_j for
    row0[i - 1] < (j + 1) rt <= row0[i] (row0[-1] = -inf, row0[P] = inf)."""
    P = len(sr)
    lo, hi = [None] * n_tiles, [None] * n_tiles
    for i in range(P + 1):
        prev = -(1 << 40) if i == 0 else sr[i - 1]
        cur = (1 << 40) if i == P else sr[i]
        for j in range(max(0, -((-(prev + span)) // rt)),
                       min(n_tiles, -((-(cur + span)) // rt))):
            assert lo[j] is None
            lo[j] = i
        for j in range(max(0, prev // rt), min(n_tiles, cur // rt)):
            assert hi[j] is None
            hi[j] = i
    return lo, hi


# name -> (row0 values, span, n_rows, rt)
RANGE_CASES = {
    "uniform": (np.random.default_rng(1).integers(0, 5000, 300), 640, 6000, 128),
    "duplicates and gaps": ([0, 0, 0, 17, 17, 3000, 3000, 3001], 320, 4000, 64),
    "last tile cut": ([100, 900, 1200, 1300, 1360], 640, 2000, 128),
    "one pair": ([500], 256, 8192, 128),
}


@pytest.mark.parametrize("case", list(RANGE_CASES))
def test_tile_ranges_cover_each_meeting_once(case):
    r, span, n_rows, rt = RANGE_CASES[case]
    row0 = torch.tensor(r, dtype=torch.int32)
    order, sr, lo, hi = tile_ranges(row0, span, n_rows, rt)
    n_tiles = -(-n_rows // rt)
    assert (lo.tolist(), hi.tolist()) == tile_bounds(sr.tolist(), span, rt, n_tiles)
    meet = {(p, j) for p in range(len(r)) for j in range(n_tiles)
            if r[p] < (j + 1) * rt and r[p] + span > j * rt}
    got = [(int(order[i]), j) for j in range(n_tiles) for i in range(lo[j], hi[j])]
    assert len(got) == len(set(got)) and set(got) == meet


# ---- P3: the key ----

KEY_CASES = {
    "infinities and signs": ([float("-inf"), -3.5, -1e-30, 1e-30, 2.0, float("inf")],
                             [9, 8, 7, 6, 5, 4]),
    "both zeros tie": ([-0.0, 0.0, -0.0, 0.0], [6, 5, 4, 3]),
    "ties go to the lower lane": ([1.5, 1.5, 1.5, -2.0, -2.0], [700, 3, 41, 12, 2]),
    "subnormals and extremes": ([-3.4e38, -1e-45, 1e-45, 3.4e38], [0, 1, 2, 2 ** 31 - 1]),
}


@pytest.mark.parametrize("case", list(KEY_CASES))
def test_bin_key_orders_as_max_then_lowest_lane(case):
    vals, pos = KEY_CASES[case]
    v = torch.tensor(vals, dtype=torch.float32)
    p = torch.tensor(pos, dtype=torch.int32)
    keys = bin_key(v, p)
    # key order == (value ascending, lane descending), zeros as one value
    want = sorted(range(len(vals)), key=lambda i: (vals[i] + 0.0, -pos[i]))
    assert torch.argsort(keys).tolist() == want
    dv, dp = bin_unkey(keys)
    assert torch.equal(dp, p)
    assert torch.equal(dv, v)                           # -0 decodes as +0, equal
    nz = v != 0
    assert torch.equal(dv[nz].view(torch.int32), v[nz].view(torch.int32))


# ---- P3: the schedules, pre-reduction and combine ----

def emulate_binned(dots, row0, win, n_rows, nbins, rt):
    """The tensor-core P3's schedule on given dots [q, T, win]: each block
    (a tile's chunk of at most M pairs, `tile_ranges`) reduces, for each of
    its pairs, the run of lanes its tile covers to one candidate per bin
    (the largest dot, the lowest lane of a tie) and combines its key into
    the query's bin with a max.  -> (vals, pos) decoded from the keys."""
    q, T, _ = dots.shape
    keys = torch.full((q, nbins), -(1 << 63), dtype=torch.int64)    # zeroed u64 keys
    for r_lo, pids, r0s in chunks(row0, win, n_rows, rt):
        for pid, r0 in zip(pids.tolist(), r0s.tolist()):
            j_lo, j_hi = max(0, r_lo - r0), min(win, r_lo + rt - r0)
            qi, t = divmod(pid, T)
            run = dots[qi, t, j_lo:j_hi]
            n = j_hi - j_lo
            width = min(n, nbins)
            steps = -(-n // nbins)
            col = torch.full((steps * nbins,), float("-inf"))
            col[:n] = run
            col = col.reshape(steps, nbins)[:, :width]          # lanes j_lo + c + s nbins
            best = col.amax(dim=0)
            first = (col == best).int().argmax(dim=0)           # the lowest lane of a tie
            p = t * win + j_lo + torch.arange(width) + first * nbins
            keys[qi].scatter_reduce_(0, p % nbins, bin_key(best, p), "amax")
    return bin_unkey(keys)


def _binned_emulation(packed, starts, qv, nbins):
    dots, _ = slab_window_dots_plain(packed, starts, None, qv, PT, mask=False)
    win, _, row0, _, _ = _geometry(packed, starts, None, PT, False)
    n_rows = packed.shape[0] * packed.shape[1]
    return emulate_binned(dots, row0, win, n_rows, nbins,
                          probe_tile_rows(packed.shape[2]))


@pytest.mark.parametrize("integer", [False, True], ids=["float", "ties"])
@pytest.mark.parametrize("nbins", [128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_binned_schedule_and_combine_equal_plain(case, nbins, integer):
    packed, starts, qv = _case(case, 31 + list(CASES).index(case), integer)
    if not integer:
        packed = packed.to(torch.bfloat16) if nbins == 256 else packed
    got_v, got_p = _binned_emulation(packed, starts, qv, nbins)
    want_v, want_p, _ = binned.binned_dots_plain(packed, starts, qv, PT, nbins)
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_p, want_p)
    if integer:                # ties must have happened for the case to count
        dots, _ = slab_window_dots_plain(packed, starts, None, qv, PT, mask=False)
        b = dots.reshape(dots.shape[0], -1, nbins)
        assert int(((b == want_v[:, None, :]).sum(1) > 1).sum()) > 0


def test_binned_schedule_equals_the_jax_probe():
    """The tile-major schedule against the TPU kernel (interpret mode) on
    integer-valued slabs and queries, where every dot is exact."""
    p3 = probe_functions()["p3"]
    packed, starts, qv = _case("heavy sharing", 7, integer=True)
    want_v, want_p, want_a = p3.binned_dots(
        jnp.asarray(packed.numpy()), jnp.asarray(starts.numpy()), jnp.asarray(qv.numpy()),
        PT, nbins=128)
    got_v, got_p = _binned_emulation(packed, starts, qv, 128)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


# ---- the tensor-core wrappers' domain ----

# name -> (kernel, slab dtype, d, the error its CUDA checks raise, or None)
DOMAIN = {
    "P3 f32": ("binned", torch.float32, 128, TypeError),
    "P3 int8 d80": ("binned", torch.int8, 80, ValueError),
    "P3 bf16 d320": ("binned", torch.bfloat16, 320, ValueError),
    "P3 int8 d64": ("binned", torch.int8, 64, None),
    "P3 bf16 d192": ("binned", torch.bfloat16, 192, None),
    "P3 int8 d256": ("binned", torch.int8, 256, None),
    "P6 int8": ("int4", torch.int8, 128, TypeError),
    "P6 d48": ("int4", torch.uint8, 48, ValueError),
    "P6 d80": ("int4", torch.uint8, 80, ValueError),
    "P6 d320": ("int4", torch.uint8, 320, ValueError),
    "P6 d64": ("int4", torch.uint8, 64, None),
    "P6 d256": ("int4", torch.uint8, 256, None),
}


@pytest.mark.parametrize("case", list(DOMAIN))
def test_tile_wrappers_check_their_domain(case):
    """The checks `binned_dots` and `slab_window_dots_int4` run on CUDA
    tensors before their launch, here on CPU tensors: the plain versions
    take every case, the tensor-core kernels only int8 / bf16 (P3) or
    uint8 (P6) slabs with d % 64 == 0, d <= 256."""
    kernel, dtype, d, error = DOMAIN[case]
    g = torch.Generator().manual_seed(5)
    q, T, n_pad = 6, 2, 1024
    packed = torch.randint(-7, 8, (T, n_pad, d), generator=g).to(dtype)
    starts = torch.randint(0, n_pad, (q, T), generator=g, dtype=torch.int32)
    qv = torch.randn(q, d, generator=g)
    if kernel == "binned":
        binned.binned_dots_plain(packed, starts, qv, PT)
        check = lambda: binned._cuda_binned(packed, starts, qv, PT, 128)  # noqa: E731
    else:
        int4slab.slab_window_dots_int4_plain(packed.view(torch.uint8), starts, qv, PT)

        def check():
            _check_tile_slab(packed)
            int4slab._cuda_int4("slab_window_dots_int4", packed, starts, qv, PT)
    if error is None:
        check()
    else:
        with pytest.raises(error):
            check()
