"""The tile-major probe bodies' schedules and combine (P2 rounded_query and
load_floor, P3, P4, P5, P6), on the CPU.

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
- P2 rounded_query: the schedule drives an emulation that stages each
  tile's bf16 rows once and dots them with chunks of 16 pairs' queries
  rounded to ONE bf16 term, each 16-wide slice of d summed from zero and
  added in f32 as the kernel does; it must agree with the plain version
  within the dot tolerance (the products are exact: only the order of the
  sum differs), bit for bit on integer-valued slabs and queries, and with
  the JAX probe ("mxu_rep", interpret mode) within test_torch_probes.py's
  bf16 tolerance (rtol 1e-5, atol 1e-6);
- P5: tiles of one 128-row block (half a block at d = 256), row starts
  blk0 * 128, each staged as stored ([d][rt]) and read transposed, the
  query in three bf16 terms; every (pair, tile) meeting must be a whole
  run of the pair's window, every lane written once; against the plain
  version within the dot tolerance on int8 and bf16 slabs at d = 64, 128
  and 256 with windows meeting the slab's first and last tiles, and
  against the JAX probe in interpret mode within test_torch_probes.py's
  tolerances (atol 1e-4 int8, 1e-6 bf16);
- P4 i8_dot: tiles of 128 int8 rows as stored, chunks of 16 pairs' int8
  queries, each dot one int32 sum (the s8 MMA's); P2 load_floor: tiles of
  128 rows, each covered row folded once, the prefix XOR over the tile
  giving each pair its share of the query's fold, the query's first
  element on its lanes.  Both equal the plain versions exactly over CASES
  at d = 64, 128 and 256 (load_floor on int8, bf16 and f32 slabs), with
  every lane written once: XOR hides a lane folded twice and drops one no
  tile folds, so the cases hold heavy sharing, windows ending in a cut
  last tile and one query's windows of two tables meeting in one tile;
  and both equal the JAX probes in interpret mode exactly (P4 "mxu_i8"
  dots, P2 "zeros" output);
- the domain the tile-major wrappers check before they launch: int8 and
  bf16 slabs (P3, P5), bf16 (P2), int8 (P4) or uint8 (P6) with d % 64 ==
  0 and d <= 256, load_floor d % 16 == 0 rows of <= 2048 B; other slab
  types and widths raise, though the plain versions take them (P2's
  rounded_query plain version, too, takes only bf16 slabs, P4's only
  int8).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu_torch.ops.kernels import binned, blkslab, int4slab, slabvariants
from crypto_rec_tpu_torch.ops.kernels.probetile import BYTE_TILE_ROWS
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
    "tables meet in a tile": (3, 2048 - 96, 128, 40, "straddle"),
}


def _starts(rng, how, q, T, n_pad):
    if how == "few":           # most windows on a few buckets
        return rng.integers(0, 3, (q, T)) * 500
    if how == "end":           # windows clamped to end inside the slab
        return rng.integers(n_pad - 300, n_pad, (q, T))
    if how == "straddle":      # a table's end and the next one's start: with
        #                        n_pad no multiple of a tile, one query's
        #                        windows of two tables meet in one tile
        return np.where(np.arange(T) % 2 == 0, rng.integers(n_pad - 100, n_pad, (q, T)),
                        rng.integers(0, 100, (q, T)))
    return rng.integers(0, n_pad, (q, T))


def _case(name, seed, integer=False, d=None):
    """CASES[name] as (int8 slabs, starts, f32 queries); d overrides the
    case's width."""
    T, n_pad, d0, q, how = CASES[name]
    d = d0 if d is None else d
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


# ---- P2 rounded_query and P5: dots written as whole runs ----

def slice_sum(terms: torch.Tensor, staged: torch.Tensor) -> torch.Tensor:
    """The kernels' f32 sum: terms [NQ, cnt, d] bf16-exact query terms,
    staged [rows, d] -> [cnt, rows]; each 16-wide slice of d summed over
    the terms from zero, then added to the running dots."""
    acc = torch.zeros(terms.shape[1], staged.shape[0])
    for s in range(0, staged.shape[1], 16):
        acc = acc + sum(t[:, s:s + 16] @ staged[:, s:s + 16].T for t in terms)
    return acc


def emulate_rounded(packed, starts, queries, per_table):
    """The tile-major P2 rounded_query in plain torch -> (dots [q, T, win],
    aligned, writes [q, T, win]: how often each lane was written)."""
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    d = packed.shape[2]
    flat = packed.reshape(-1, d).float()
    n_rows = flat.shape[0]
    term = queries.to(torch.bfloat16).float()[None]              # ONE bf16 term
    dots = torch.full((q * T, win), float("nan"))
    writes = torch.zeros(q * T, win, dtype=torch.int64)
    for t0, p, r0 in chunks(row0, win, n_rows, probe_tile_rows(d)):
        rows = torch.arange(t0, min(t0 + probe_tile_rows(d), n_rows))
        block = slice_sum(term[:, p // T], flat[rows])
        j = rows[None, :] - r0.long()[:, None]
        pi, ri = torch.nonzero((j >= 0) & (j < win), as_tuple=True)
        dots[p[pi], j[pi, ri]] = block[pi, ri]
        writes[p[pi], j[pi, ri]] += 1
    return dots.reshape(q, T, win), aligned, writes.reshape(q, T, win)


def _p2_case(name, seed, integer):
    """bf16 slabs of CASES' shape: unit rows, or small integers; f32
    queries (unit, not pre-rounded, or integer-valued)."""
    p8, starts, qv = _case(name, seed, integer)
    if integer:
        return p8.to(torch.bfloat16), starts, qv
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=p8.shape)
                         .astype(np.float32))
    return torch.nn.functional.normalize(x, dim=-1).to(torch.bfloat16), starts, qv


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
@pytest.mark.parametrize("case", list(CASES))
def test_rounded_query_tile_schedule_matches_plain(case, integer):
    packed, starts, qv = _p2_case(case, 50 + list(CASES).index(case), integer)
    got, a_got, writes = emulate_rounded(packed, starts, qv, PT)
    want, a_want = slabvariants.slab_window_variant_plain(packed, starts, qv, PT,
                                                          "rounded_query")
    assert torch.equal(a_got, a_want)
    assert torch.equal(writes, torch.ones_like(writes))
    if integer:                 # exact products and sums: any order, same bits
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, **TOL)


def emulate_blk(packed_blk, starts, queries, per_table):
    """The tile-major P5 in plain torch -> (dots [q, T, win], aligned,
    writes).  A tile is rt lanes of one block, staged as stored ([d][rt])
    and read transposed; each pair it meets gets one whole run."""
    win, aligned, blk0 = blkslab._geometry_blk(packed_blk, starts, per_table)
    q, T = starts.shape
    L, npb, d, B = packed_blk.shape
    blocks = packed_blk.reshape(-1, d, B).float()
    n_rows, rt = L * npb * B, probe_tile_rows(d)
    terms = split_bf16x3(queries).float().transpose(0, 1)       # [3, q, d]
    dots = torch.full((q * T, win), float("nan"))
    writes = torch.zeros(q * T, win, dtype=torch.int64)
    for t0, p, r0 in chunks(blk0 * B, win, n_rows, rt):
        staged = blocks[t0 // B, :, t0 % B:t0 % B + rt]         # [d, rt]
        j0 = t0 - r0.long()
        assert bool(((j0 >= 0) & (j0 + rt <= win)).all())      # whole runs
        lanes = j0[:, None] + torch.arange(rt)
        dots[p[:, None], lanes] = slice_sum(terms[:, p // T], staged.T)
        writes[p[:, None], lanes] += 1
    return dots.reshape(q, T, win), aligned, writes.reshape(q, T, win)


# name -> (T, n_pad, d, q): windows at both ends of the slab ("ends"), on a
# few buckets ("few") or anywhere ("uniform")
BLK_CASES = {
    "d64 ends": (3, 2048, 64, 40, "ends"),
    "d128 heavy sharing": (4, 2048, 128, 90, "few"),
    "d128 sparse": (2, 8192, 128, 7, "uniform"),
    "d256 ends": (2, 2048, 256, 30, "ends"),
}


def _blk_case(name, seed, dtype):
    T, n_pad, d, q, how = BLK_CASES[name]
    rng = np.random.default_rng(seed)
    if how == "ends":          # table 0's first block and the last table's last
        starts = np.where(rng.random((q, T)) < 0.5, rng.integers(0, 200, (q, T)),
                          rng.integers(n_pad - 200, n_pad, (q, T)))
    else:
        starts = _starts(rng, how, q, T, n_pad)
    x = rng.normal(size=(T, n_pad, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    qv = rng.normal(size=(q, d)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    packed = (np.clip(np.round(x / (np.abs(x).max() / 127)), -127, 127).astype(np.int8)
              if dtype == torch.int8 else x)
    packed = torch.from_numpy(packed).to(dtype)
    return (blkslab.to_blk(packed), torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(qv))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("case", list(BLK_CASES))
def test_blk_tile_schedule_matches_plain(case, dtype):
    blk, starts, qv = _blk_case(case, 60 + list(BLK_CASES).index(case), dtype)
    got, a_got, writes = emulate_blk(blk, starts, qv, PT)
    want, a_want = blkslab.blk_window_dots_plain(blk, starts, qv, PT)
    assert torch.equal(a_got, a_want)
    assert torch.equal(writes, torch.ones_like(writes))
    torch.testing.assert_close(got, want, **TOL)
    if BLK_CASES[case][4] == "ends":      # the slab's first and last tiles are met
        _, _, blk0 = blkslab._geometry_blk(blk, starts, PT)
        L, npb = blk.shape[:2]
        assert int(blk0.min()) == 0
        assert int(blk0.max()) * 128 + got.shape[2] == L * npb * 128


JAX_TOL = {torch.int8: dict(rtol=1e-5, atol=1e-4), torch.bfloat16: dict(rtol=1e-5, atol=1e-6)}


def test_rounded_query_schedule_matches_the_jax_probe():
    """The emulation against run_variant's "mxu_rep" (interpret mode) on
    unit bf16 rows and unit f32 queries, which the probe rounds itself."""
    p2 = probe_functions()["p2"]
    packed, starts, qv = _p2_case("heavy sharing", 70, integer=False)
    want = p2.run_variant(jnp.asarray(packed.float().numpy(), jnp.bfloat16),
                          jnp.asarray(starts.numpy()), jnp.asarray(starts.numpy()),
                          jnp.asarray(qv.numpy()), PT, 16, 4, "mxu_rep")[:qv.shape[0]]
    got, _, _ = emulate_rounded(packed, starts, qv, PT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_blk_schedule_matches_the_jax_probe(dtype):
    p5 = probe_functions()["p5"]
    blk, starts, qv = _blk_case("d128 heavy sharing", 71, dtype)
    jblk = (jnp.asarray(blk.numpy()) if dtype == torch.int8
            else jnp.asarray(blk.float().numpy(), jnp.bfloat16))
    want_d, want_a = p5.blk_window_dots(jblk, jnp.asarray(starts.numpy()),
                                        jnp.asarray(qv.numpy()), PT)
    got_d, got_a, _ = emulate_blk(blk, starts, qv, PT)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **JAX_TOL[dtype])


# ---- P4 i8_dot and P2 load_floor: int8 rows as stored; no product ----

def emulate_i8(packed, starts, queries, per_table):
    """The tile-major P4 in plain torch -> (dots [q, T, win] f32, aligned,
    writes [q, T, win]).  Tiles of BYTE_TILE_ROWS int8 rows as stored, the
    chunks of 16 pairs' int8 queries, each dot one int32 sum over all of d
    (the s8 MMA's, exact in any order), written as f32."""
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    d = packed.shape[2]
    flat = packed.reshape(-1, d).to(torch.int32)
    n_rows, rt = flat.shape[0], BYTE_TILE_ROWS
    qi = queries.to(torch.int32)
    dots = torch.full((q * T, win), float("nan"))
    writes = torch.zeros(q * T, win, dtype=torch.int64)
    for t0, p, r0 in chunks(row0, win, n_rows, rt):
        rows = torch.arange(t0, min(t0 + rt, n_rows))
        block = (qi[p // T][:, None, :] * flat[rows][None]).sum(-1, dtype=torch.int32)
        j = rows[None, :] - r0.long()[:, None]
        pi, ri = torch.nonzero((j >= 0) & (j < win), as_tuple=True)
        dots[p[pi], j[pi, ri]] = block[pi, ri].float()
        writes[p[pi], j[pi, ri]] += 1
    return dots.reshape(q, T, win), aligned, writes.reshape(q, T, win)


def emulate_load_floor(packed, starts, per_table):
    """The tile-major P2 load_floor in plain torch and numpy -> (out
    [q, T, win] f32, aligned, fold [q] int32, writes [q, T, win]).  Each
    tile of BYTE_TILE_ROWS rows that some window meets folds each row it
    covers (its first pair's row0 to its last pair's window end) to one
    word, takes the prefix XOR over the tile's rows, and gives each of its
    pairs (`tile_ranges`) prefix[j_hi] ^ prefix[j_lo] into the query's fold
    and the query's first element on the lanes [j_lo, j_hi)."""
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    d = packed.shape[2]
    flat = packed.reshape(-1, d)
    n_rows, rt = flat.shape[0], BYTE_TILE_ROWS
    row_word = np.bitwise_xor.reduce(flat.contiguous().view(torch.int32).numpy(), axis=1)
    first = flat[row0[:, 0].long(), 0].float()
    out = torch.full((q * T, win), float("nan"))
    writes = torch.zeros(q * T, win, dtype=torch.int64)
    fold = np.zeros(q, np.int32)
    order, sr, lo, hi = tile_ranges(row0, win, n_rows, rt)
    for j, (s, e) in enumerate(zip(lo.tolist(), hi.tolist())):
        if e <= s:
            continue
        t0 = j * rt
        a, b = max(t0, int(sr[s])), min(t0 + rt, n_rows, int(sr[e - 1]) + win)
        words = np.zeros(rt, np.int32)
        words[a - t0:b - t0] = row_word[a:b]
        prefix = np.concatenate([[0], np.bitwise_xor.accumulate(words)]).astype(np.int32)
        for pid, r0 in zip(order[s:e].tolist(), sr[s:e].tolist()):
            j_lo, j_hi = max(0, t0 - r0), min(win, t0 + rt - r0)
            out[pid, j_lo:j_hi] = first[pid // T]
            writes[pid, j_lo:j_hi] += 1
            fold[pid // T] ^= prefix[r0 - t0 + j_hi] ^ prefix[r0 - t0 + j_lo]
    return (out.reshape(q, T, win), aligned, torch.from_numpy(fold),
            writes.reshape(q, T, win))


def _int8_queries(seed, q, d):
    """int8 queries over the whole of [-127, 127], no symmetry, both ends
    reached."""
    qi = np.random.default_rng(seed).integers(-127, 128, (q, d)).astype(np.int8)
    qi[0, 0], qi[-1, -1] = 127, -127
    return torch.from_numpy(qi)


def _floor_slab(p8, dtype, seed):
    """int8 slabs as drawn; bf16 / f32 ones of the same shape from normals
    (every bit of their words in play)."""
    if dtype == torch.int8:
        return p8
    x = np.random.default_rng(seed).normal(size=p8.shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


D_SWEEP = [64, 128, 256]


@pytest.mark.parametrize("d", D_SWEEP)
@pytest.mark.parametrize("case", list(CASES))
def test_i8_tile_schedule_equals_plain(case, d):
    """Bit for bit on every lane, each written once; the int8 slabs and
    queries reach -127 and 127."""
    seed = 80 + list(CASES).index(case)
    packed, starts, _ = _case(case, seed, d=d)
    qi = _int8_queries(seed, starts.shape[0], d)
    got, a_got, writes = emulate_i8(packed, starts, qi, PT)
    want, a_want = slabvariants.slab_window_variant_plain(packed, starts, qi, PT, "i8_dot")
    assert torch.equal(a_got, a_want)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, want)
    assert int(packed.min()) == -127 and int(packed.max()) == 127
    assert int(qi.min()) == -127 and int(qi.max()) == 127


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32],
                         ids=["int8", "bf16", "f32"])
@pytest.mark.parametrize("d", D_SWEEP)
@pytest.mark.parametrize("case", list(CASES))
def test_load_floor_tile_schedule_equals_plain(case, d, dtype):
    """Output and fold exact, every lane written once: XOR would hide a
    lane folded twice, and drop one that no tile folds."""
    seed = 90 + list(CASES).index(case)
    p8, starts, qv = _case(case, seed, d=d)
    packed = _floor_slab(p8, dtype, seed)
    got, a_got, fold, writes = emulate_load_floor(packed, starts, PT)
    want, a_want, want_fold = slabvariants.slab_window_variant_plain(
        packed, starts, qv, PT, "load_floor")
    assert torch.equal(a_got, a_want)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, want)
    assert torch.equal(fold, want_fold)


def test_load_floor_cases_meet_what_the_fold_can_hide():
    """The cases above hold what XOR would hide: a tile walked by many
    pairs (heavy sharing), windows ending at the slab's end in a cut last
    tile, and one query's windows of two tables meeting in one tile."""
    def meetings(case):
        T, n_pad, _, _, _ = CASES[case]
        _, starts, _ = _case(case, 90 + list(CASES).index(case))
        win, _, row0, _, _ = _geometry(torch.zeros(T, n_pad, 1), starts, None, PT, False)
        return win, row0, T * n_pad
    win, row0, n_rows = meetings("heavy sharing")
    _, _, lo, hi = tile_ranges(row0, win, n_rows, BYTE_TILE_ROWS)
    assert int((hi - lo).max()) > 2 * M
    win, row0, n_rows = meetings("last tile cut, d256")
    assert n_rows % BYTE_TILE_ROWS and int((row0 + win).max()) == n_rows
    win, row0, n_rows = meetings("tables meet in a tile")
    tiles = lambda r: torch.div(r, BYTE_TILE_ROWS, rounding_mode="floor")  # noqa: E731
    last_of_0, first_of_1 = tiles(row0[:, 0] + win - 1), tiles(row0[:, 1])
    assert bool((last_of_0 == first_of_1).any())


def test_i8_schedule_equals_the_jax_probe():
    """The emulation against nomask_dots' "mxu_i8" (interpret mode) on the
    probe's int8 slabs and int8 queries: exact."""
    p4 = probe_functions()["p4"]
    packed, starts, _ = _case("heavy sharing", 95)
    qi = _int8_queries(95, starts.shape[0], packed.shape[2])
    want_d, want_a = p4.nomask_dots(jnp.asarray(packed.numpy()), jnp.asarray(starts.numpy()),
                                    jnp.asarray(qi.numpy()), PT, score="mxu_i8")
    got_d, got_a, _ = emulate_i8(packed, starts, qi, PT)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_load_floor_schedule_equals_the_jax_probe(dtype):
    """The emulation's output against run_variant's "zeros" (interpret
    mode): the first element of table 0's window on every lane, exact."""
    p2 = probe_functions()["p2"]
    p8, starts, qv = _case("tables meet in a tile", 96)
    packed = _floor_slab(p8, dtype, 96)
    jp = (jnp.asarray(packed.numpy()) if dtype == torch.int8
          else jnp.asarray(packed.float().numpy(), jnp.bfloat16))
    want = p2.run_variant(jp, jnp.asarray(starts.numpy()), jnp.asarray(starts.numpy()),
                          jnp.asarray(qv.numpy()), PT, 16, 4, "zeros")[:qv.shape[0]]
    got, _, _, _ = emulate_load_floor(packed, starts, PT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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
    "P2 f32": ("rounded", torch.float32, 128, TypeError),
    "P2 int8": ("rounded", torch.int8, 128, TypeError),
    "P2 bf16 d80": ("rounded", torch.bfloat16, 80, ValueError),
    "P2 bf16 d320": ("rounded", torch.bfloat16, 320, ValueError),
    "P2 bf16 d64": ("rounded", torch.bfloat16, 64, None),
    "P2 bf16 d256": ("rounded", torch.bfloat16, 256, None),
    "P5 f32": ("blk", torch.float32, 128, TypeError),
    "P5 int8 d80": ("blk", torch.int8, 80, ValueError),
    "P5 bf16 d320": ("blk", torch.bfloat16, 320, ValueError),
    "P5 int8 d64": ("blk", torch.int8, 64, None),
    "P5 bf16 d64": ("blk", torch.bfloat16, 64, None),
    "P5 int8 d256": ("blk", torch.int8, 256, None),
    "P5 bf16 d256": ("blk", torch.bfloat16, 256, None),
    "P4 bf16": ("i8", torch.bfloat16, 128, TypeError),
    "P4 int8 d80": ("i8", torch.int8, 80, ValueError),
    "P4 int8 d320": ("i8", torch.int8, 320, ValueError),
    "P4 int8 d64": ("i8", torch.int8, 64, None),
    "P4 int8 d192": ("i8", torch.int8, 192, None),
    "P4 int8 d256": ("i8", torch.int8, 256, None),
    "P2 floor uint8": ("floor", torch.uint8, 128, TypeError),
    "P2 floor int8 d40": ("floor", torch.int8, 40, ValueError),
    "P2 floor f32 d1024": ("floor", torch.float32, 1024, ValueError),
    "P2 floor int8 d48": ("floor", torch.int8, 48, None),
    "P2 floor bf16 d1024": ("floor", torch.bfloat16, 1024, None),
    "P2 floor f32 d64": ("floor", torch.float32, 64, None),
}


@pytest.mark.parametrize("case", list(DOMAIN))
def test_tile_wrappers_check_their_domain(case):
    """The checks `binned_dots`, `slab_window_dots_int4`,
    `rounded_query_dots`, `i8_dots`, `blk_window_dots` and `load_floor`
    run on CUDA tensors before their launch, here on CPU tensors: the plain
    versions take every case (P2's rounded_query every bf16 case, P4 every
    int8 one), the tensor-core kernels only int8 / bf16 (P3, P5), bf16 (P2),
    int8 (P4, with int8 queries) or uint8 (P6) slabs with d % 64 == 0,
    d <= 256; load_floor int8, bf16 and f32 rows with d % 16 == 0 of at
    most 2048 bytes."""
    kernel, dtype, d, error = DOMAIN[case]
    g = torch.Generator().manual_seed(5)
    q, T, n_pad = 6, 2, 1024
    packed = torch.randint(-7, 8, (T, n_pad, d), generator=g).to(dtype)
    starts = torch.randint(0, n_pad, (q, T), generator=g, dtype=torch.int32)
    qv = torch.randn(q, d, generator=g)
    if kernel == "binned":
        binned.binned_dots_plain(packed, starts, qv, PT)
        check = lambda: binned._cuda_binned(packed, starts, qv, PT, 128)  # noqa: E731
    elif kernel == "rounded":
        if dtype == torch.bfloat16:
            slabvariants.slab_window_variant_plain(packed, starts, qv, PT, "rounded_query")
        check = lambda: slabvariants._cuda_rounded(packed, starts, qv, PT)  # noqa: E731
    elif kernel == "i8":
        qi = slabvariants.quantize_queries(qv)
        if dtype == torch.int8:
            slabvariants.slab_window_variant_plain(packed, starts, qi, PT, "i8_dot")
        check = lambda: slabvariants._cuda_i8(packed, starts, qi, PT)  # noqa: E731
    elif kernel == "floor":
        slabvariants.slab_window_variant_plain(packed, starts, qv, PT, "load_floor")
        check = lambda: slabvariants._cuda_floor(packed, starts, qv, PT)  # noqa: E731
    elif kernel == "blk":
        blk = blkslab.to_blk(packed)
        blkslab.blk_window_dots_plain(blk, starts, qv, PT)
        check = lambda: blkslab._cuda_blk(blk, starts, qv, PT)  # noqa: E731
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
