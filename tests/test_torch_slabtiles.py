"""The tile-major K1's schedule, arithmetic and bounds, on the CPU.

The CUDA kernel (csrc/slabtile.cu) runs only on the card, so its pieces are
checked here in plain torch:

- the work list (`tile_work`) drives an emulation that fills dots tile by
  tile as the kernel does; on integer-valued inputs every dot is exact, so
  it must EQUAL `slab_window_dots_plain`, with every (pair, lane) written
  exactly once;
- the three-term bf16 split of the f32 query (`split_bf16x3`) keeps the
  dots within rtol 1e-5 / atol 1e-4 of the f32 plain version, and two
  terms do not on raw int8 dots;
- the bounds' byte and FLOP counts (`ops/kernels/bounds.py`) against
  hand-reckoned cases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu.ops.pallas import slabscore as jax_slab
from crypto_rec_tpu_torch.ops.kernels import bounds
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _geometry, slab_window_dots_plain, split_bf16x3, tile_shape, tile_work,
)

TOL = dict(rtol=1e-5, atol=1e-4)


def emulate(packed, starts, sizes, queries, per_table, mask, shared_slab, rt, m):
    """The tile-major schedule in plain torch: each work item dots its
    tile's rows with its pairs' queries (float64) and writes the lanes
    tile_row - row0 in [0, win).  -> (dots [q, T, win] f32, aligned,
    writes [q, T, win] int: how often each lane was written)."""
    win, aligned, row0, head, size = _geometry(packed, starts, sizes, per_table,
                                               shared_slab)
    q, T = starts.shape
    d = packed.shape[2]
    flat = packed.reshape(-1, d).double()
    n_rows = flat.shape[0]
    r0 = row0.reshape(-1).long()
    pairs, item_tile, item_lo, item_cnt = tile_work(row0, win, n_rows, rt, m)
    assert bool((item_cnt <= m).all()) and bool((item_cnt >= 0).all())
    dots = torch.full((q * T, win), float("nan"), dtype=torch.float64)
    writes = torch.zeros(q * T, win, dtype=torch.int64)
    for tile, lo, cnt in zip(item_tile.tolist(), item_lo.tolist(), item_cnt.tolist()):
        if cnt == 0:
            continue
        rows = torch.arange(tile * rt, min((tile + 1) * rt, n_rows))
        p = pairs[lo:lo + cnt].long()
        block = queries.double()[p // T] @ flat[rows].T          # [cnt, rows]
        lane = rows[None, :] - r0[p][:, None]
        ok = (lane >= 0) & (lane < win)
        pi, ri = torch.nonzero(ok, as_tuple=True)
        dots[p[pi], lane[pi, ri]] = block[pi, ri]
        writes[p[pi], lane[pi, ri]] += 1
    dots = dots.float().reshape(q, T, win)
    if mask:
        ln = torch.arange(win)
        valid = (ln >= head[..., None]) & (ln < (head + size)[..., None])
        dots = torch.where(valid, dots, float("-inf"))
    return dots, aligned, writes.reshape(q, T, win)


def _int_case(rng, n_slabs, n_pad, d, q, T):
    packed = torch.from_numpy(rng.integers(-127, 128, (n_slabs, n_pad, d)).astype(np.int8))
    queries = torch.from_numpy(rng.integers(-3, 4, (q, d)).astype(np.float32))
    return packed, queries


# name -> (shared_slab, d, q, T, n_pad, how the starts are drawn)
CASES = {
    "per-table d128": (False, 128, 40, 3, 2048, "uniform"),
    "per-table d256": (False, 256, 30, 2, 1536, "uniform"),
    "shared d128": (True, 128, 40, 8, 4096, "uniform"),
    "shared d256": (True, 256, 24, 8, 2048, "uniform"),
    "clamped at the slab's end": (False, 128, 40, 3, 1024, "end"),
    "MultiCube segments": (True, 256, 30, 6, 3 * 1024, "segments"),
    "hot tile beyond M pairs": (True, 128, 100, 4, 2048, "hot"),
    "untouched tiles": (False, 128, 20, 2, 8192, "low"),
}


def _starts(rng, how, q, T, n_pad):
    if how == "end":           # windows clamped to end inside the slab
        return rng.integers(n_pad - 300, n_pad, (q, T))
    if how == "segments":      # C = 3 cubes of 1,024 rows end to end
        local = rng.integers(0, 1024, (q, T))
        return local + (np.arange(T) % 3)[None, :] * 1024
    if how == "hot":           # most windows start in one bucket
        s = rng.integers(0, n_pad, (q, T))
        s[: q - 10] = 700
        return s
    if how == "low":           # only the slab's first rows are probed
        return rng.integers(0, 600, (q, T))
    return rng.integers(0, n_pad, (q, T))


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("case", list(CASES))
def test_tile_schedule_equals_plain(case, mask):
    shared, d, q, T, n_pad, how = CASES[case]
    rng = np.random.default_rng(list(CASES).index(case))
    packed, queries = _int_case(rng, 1 if shared else T, n_pad, d, q, T)
    starts = torch.from_numpy(_starts(rng, how, q, T, n_pad).astype(np.int32))
    sizes = torch.from_numpy(rng.integers(0, 500, (q, T)).astype(np.int32))
    per_table = 300
    rt, m = tile_shape(packed.dtype, d)
    got, a_got, writes = emulate(packed, starts, sizes, queries, per_table, mask,
                                 shared, rt, m)
    want, a_want = slab_window_dots_plain(packed, starts, sizes, queries, per_table,
                                          mask=mask, shared_slab=shared)
    assert torch.equal(a_got, a_want)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, want)
    _, _, row0, _, _ = _geometry(packed, starts, sizes, per_table, shared)
    win = got.shape[2]
    n_rows = packed.shape[0] * n_pad
    _, item_tile, _, item_cnt = tile_work(row0, win, n_rows, rt, m)
    busy = torch.zeros(-(-n_rows // rt), dtype=torch.int64)
    busy.index_add_(0, item_tile.long(), item_cnt.long())
    if how == "hot":           # the hot tile's pairs are split over items
        assert int(busy.max()) > m
        assert int((item_cnt == m).sum()) >= 2
    if how == "low":
        assert int((busy == 0).sum()) > 0


def test_tile_schedule_matches_jax_interpret():
    """The emulated schedule against the JAX Pallas kernel (interpret
    mode) at one small int8 geometry."""
    rng = np.random.default_rng(11)
    T, n_pad, d, q, per_table = 3, 1024, 128, 12, 200
    packed, queries = _int_case(rng, T, n_pad, d, q, T)
    starts = rng.integers(0, n_pad, (q, T)).astype(np.int32)
    sizes = rng.integers(0, 300, (q, T)).astype(np.int32)
    jd, ja = jax_slab.slab_window_dots(
        jnp.asarray(packed.numpy()), None, jnp.asarray(starts), jnp.asarray(sizes),
        jnp.asarray(queries.numpy()), per_table=per_table, interpret=True, mask=True)
    got, a_got, _ = emulate(packed, torch.from_numpy(starts), torch.from_numpy(sizes),
                            queries, per_table, True, False, *tile_shape(torch.int8, d))
    np.testing.assert_array_equal(a_got.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd))


def test_work_list_upper_bound_and_padding():
    """Items past the real ones carry count 0; the real ones cover every
    (pair, tile) meeting exactly once."""
    rng = np.random.default_rng(3)
    row0 = torch.from_numpy(rng.integers(0, 5000, 300).astype(np.int32))
    win, n_rows, rt, m = 640, 6000, 128, 64
    pairs, item_tile, item_lo, item_cnt = tile_work(row0, win, n_rows, rt, m)
    assert sorted(pairs.tolist()) == list(range(300))
    meet = {(p, t) for p in range(300) for t in range(-(-n_rows // rt))
            if row0[p] < (t + 1) * rt and row0[p] + win > t * rt}
    got = [(int(pairs[i]), t) for t, lo, c in zip(item_tile.tolist(), item_lo.tolist(),
                                                  item_cnt.tolist())
           for i in range(lo, lo + c)]
    assert len(got) == len(set(got)) and set(got) == meet


def _split_dots(terms, slab):
    """The tensor-core arithmetic: each bf16 term times the slab (exact
    products) accumulated in f32, the terms' dots summed in f32."""
    out = torch.zeros(terms.shape[0], slab.shape[0])
    for t in range(terms.shape[1]):
        out = out + terms[:, t].float() @ slab.float().T
    return out


def _queries(rng, d, unit):
    q = torch.from_numpy(rng.normal(size=(64, d)).astype(np.float32))
    return torch.nn.functional.normalize(q, dim=1) if unit else q


def _slab(rng, dtype, d):
    if dtype == torch.int8:
        return torch.from_numpy(rng.integers(-127, 128, (512, d)).astype(np.int8))
    return torch.from_numpy(rng.normal(size=(512, d)).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("slab_dtype", [torch.int8, torch.bfloat16])
def test_three_term_split_keeps_k1_tolerance(slab_dtype, d):
    """Unit queries (the cosine paths): three terms stay within K1's
    tolerance of the f32 plain version; raw queries (augmented euclidean
    rows, dots of ~10^3): three terms stay as close to the exact dots as
    the f32 plain version itself."""
    rng = np.random.default_rng(5)
    slab = _slab(rng, slab_dtype, d)
    for unit in (True, False):
        q = _queries(rng, d, unit)
        terms = split_bf16x3(q)
        assert terms.shape == (64, 3, d) and terms.dtype == torch.bfloat16
        # the three terms hold the query to f32 precision
        recon = terms.double().sum(dim=1)
        assert float((recon - q.double()).abs().max()) <= 2.0 ** -23 * float(q.abs().max())
        want = q @ slab.float().T
        got = _split_dots(terms, slab)
        if unit:
            assert torch.allclose(got, want, **TOL)
        exact = q.double() @ slab.double().T
        assert (got.double() - exact).abs().max() <= (want.double() - exact).abs().max()


@pytest.mark.parametrize("d", [128, 256])
def test_two_term_split_misses_k1_tolerance_on_raw_int8(d):
    rng = np.random.default_rng(6)
    q = _queries(rng, d, True)
    slab = _slab(rng, torch.int8, d)
    two = split_bf16x3(q)[:, :2]
    assert not torch.allclose(_split_dots(two, slab), q @ slab.float().T, **TOL)


def test_covered_rows_hand_reckoned():
    t = lambda xs: torch.tensor(xs, dtype=torch.int32)
    # [0, 80): blocks 0-2
    assert bounds.covered_rows(t([0, 16]), 64, 10_000) == 96
    # overlapping windows count once: [0, 64) and [1000, 1064) -> blocks
    # {0, 1} and {31, 32, 33}
    assert bounds.covered_rows(t([0, 0, 32, 1000, 1000]), 64, 10_000) == 5 * 32 + 32
    # [36, 100) in a 100-row slab: blocks 1, 2 and the 4-row block 3
    assert bounds.covered_rows(t([36]), 64, 100) == 68
    assert bounds.covered_rows(t([]), 64, 100) == 0


def test_k1_and_k2_bounds_hand_reckoned():
    # one slab [2, 1024, 128] int8, q = 2 queries, T = 2, per_table 96 ->
    # win 128; starts 0 and 64 -> aligned 0 and 64; flat row0 0, 1088 and
    # 0, 1088 -> covered rows [0, 128) and [1088, 1216): 256 rows x 128 B
    packed = torch.zeros(2, 1024, 128, dtype=torch.int8)
    starts = torch.tensor([[0, 64], [0, 64]], dtype=torch.int32)
    queries = torch.zeros(2, 128)
    b = bounds.k1_call(packed, starts, None, queries, 96)
    assert b["bytes"] == 256 * 128 + 2 * 128 * 4 + 2 * 2 * (128 * 4 + 4)
    assert b["flops"] == 2.0 * 2 * 2 * 128 * 128
    assert b["bound_by"] == "bytes" and b["peak"] == bounds.BF16_TC
    assert b["bound_ms"] == pytest.approx(b["bytes"] / 3.35e12 * 1e3)
    assert b["ffma_bound_ms"] >= b["bound_ms"]
    k2 = bounds.k2_call(2_000_000, 128, 13, 8)
    assert k2["bytes"] == 4 * (2_000_000 * 128 + 128 * 104 + 2_000_000 * 8)
    assert k2["flops"] == 2.0 * 2_000_000 * 128 * 104
    assert k2["bound_by"] == "operations"
    assert k2["bound_ms"] == pytest.approx(k2["flops"] / 67e12 * 1e3)
    assert bounds.k2_call(2_000_000, 128, 13, 1)["bound_by"] == "bytes"


def test_k1_bound_prices_f32_slabs_on_ffma():
    """f32 slabs are not exact in bf16: K1 takes f32 FFMA for them, and its
    bound uses that unit's peak (the same geometry as above, 4 B a value)."""
    packed = torch.zeros(2, 1024, 128, dtype=torch.float32)
    starts = torch.tensor([[0, 64], [0, 64]], dtype=torch.int32)
    b = bounds.k1_call(packed, starts, None, torch.zeros(2, 128), 96)
    assert b["peak"] == bounds.F32_FFMA
    assert b["bytes"] == 256 * 128 * 4 + 2 * 128 * 4 + 2 * 2 * (128 * 4 + 4)
    assert b["bound_ms"] == b["ffma_bound_ms"] == pytest.approx(
        max(b["bytes"] / 3.35e12, b["flops"] / 67e12) * 1e3)
