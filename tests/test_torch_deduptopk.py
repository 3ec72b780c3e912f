"""D1, the dedup top-k epilogue (`ops/kernels/deduptopk.py`,
`csrc/deduptopk.cu`), on the CPU.

- the card route's checks accept what the plain version takes (both
  operand forms, ids int32 and int64, m up to MAX_M) and raise on the rest;
  its launch hands the library the operands and sizes `build._SIGNATURES`
  names (library and stream stubbed), the counter's pointer only while a
  profiler records;
- on CPU tensors `_dedup_topk_pairs` and `slab_topk` are bit for bit the
  ops they ran before the kernel, stated here as they were;
- the kernel's arithmetic, stated in plain Python (a first-occurrence
  table, each survivor's unique 64-bit key, the keys sorted descending;
  the lanes form's row ids and pads), equals the plain version on rows of
  tied, signed-zero, NaN and infinite scores with repeated ids;
- "dedup.lanes" and "dedup.kept" count while a profiler records and not
  otherwise;
- `bounds.dedup_call` counts each byte once.

The kernel itself runs only on the card (`tests/test_torch_cuda.py`).
"""

import contextlib
import math
import re
import struct
import types

import pytest
import torch

from crypto_rec_tpu_torch.ops.kernels import bounds, build, deduptopk, slabscore
from crypto_rec_tpu_torch.ops.kernels.deduptopk import (
    MAX_M, check_dedup_topk, dedup_topk, dedup_topk_plain,
)
from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
from crypto_rec_tpu_torch.ops.topk import topk_desc
from crypto_rec_tpu_torch.utils import timing
from portbench import readers

NEG_INF = float("-inf")


# ---- the parent's ops, as they were before the kernel ----

def parent_dedup_topk_pairs(scores, ids, n_rows, top_k):
    """`slabscore._dedup_topk_pairs` as it was before D1."""
    raw_sorted, perm = torch.sort(ids, dim=1, stable=True)
    s_sorted = torch.gather(scores, 1, perm)
    dup = torch.zeros_like(raw_sorted, dtype=torch.bool)
    dup[:, 1:] = raw_sorted[:, 1:] == raw_sorted[:, :-1]
    s_sorted = torch.where(
        dup | (raw_sorted >= n_rows) | ~torch.isfinite(s_sorted),
        float("-inf"), s_sorted,
    )
    s2, pos2 = topk_desc(s_sorted, top_k)
    ids_sorted = torch.clamp(raw_sorted, max=n_rows - 1)
    out_ids = torch.where(
        s2 > float("-inf"), torch.gather(ids_sorted, 1, pos2), -1
    )
    return s2, out_ids.to(torch.int32)


def parent_lane_rows(pos, aligned_starts, packed_rows, win):
    n_pad = packed_rows.shape[1]
    pos = pos.long()
    l_of = torch.div(pos, win, rounding_mode="floor")
    gpos = l_of * n_pad + torch.clamp(
        torch.gather(aligned_starts.long(), 1, l_of) + pos % win, max=n_pad - 1
    )
    return packed_rows.reshape(-1)[gpos]


def parent_slab_topk(dots, aligned_starts, packed_rows, n_rows, top_k, exact=True,
                     stage1_width=0, stage1_per_table=0):
    """`slabscore.slab_topk` as it was before D1 (its stage 1 on the CPU is
    `window_topk`'s `topk_desc`)."""
    q, L, win = dots.shape
    if not exact and (stage1_per_table or not stage1_width):
        kk = min(max(stage1_per_table or top_k, -(-top_k // L)), win)
        s1, lane = window_topk(dots.reshape(q * L, win), kk)
        s1 = s1.reshape(q, L * kk)
        l_base = torch.arange(L, device=dots.device)[None, :, None] * win
        pos1 = (l_base + lane.reshape(q, L, kk)).reshape(q, L * kk)
    else:
        m1 = min(L * top_k, L * win)
        if stage1_width:
            m1 = min(m1, max(stage1_width, top_k))
        s1, pos1 = window_topk(dots.reshape(q, L * win), m1)
    ids1 = parent_lane_rows(pos1, aligned_starts, packed_rows, win)
    ids1 = torch.where(s1 > float("-inf"), ids1, n_rows)
    return parent_dedup_topk_pairs(s1, ids1, n_rows, top_k)


# ---- cases ----

LEVELS = torch.tensor([-1.0, -0.0, 0.0, 0.5, 2.0, float("nan"), float("inf"), NEG_INF])


def _pairs(q, m, n_rows, seed, id_dtype=torch.int64, id_span=None):
    """Scores: half the rows random, half on a few levels (ties, +-0, NaN,
    +-inf); ids drawn from id_span values (repeats) up to n_rows + 3 (the
    ids >= n_rows are pads), a few negative."""
    g = torch.Generator().manual_seed(seed)
    s = torch.rand(q, m, generator=g) * 4 - 2
    tied = LEVELS[torch.randint(0, len(LEVELS), (q, m), generator=g)]
    s[q // 2:] = tied[q // 2:]
    span = id_span or max(2, m // 3)
    ids = torch.randint(0, span, (q, m), generator=g) + torch.randint(
        0, max(1, n_rows + 3 - span), (q, 1), generator=g)
    ids[0, :3] = torch.tensor([-5, -5, -7])[: min(3, m)]
    ids[1 % q] = n_rows + 1                         # an all-pad row
    return s, ids.to(id_dtype)


def _windows(q, T, win, n_pad, n_rows, seed):
    """Lanes-form windows: aligned starts [q, T] int32 and CSR rows [T,
    n_pad] int32 holding row ids and pad sentinels (n_rows) at the end."""
    g = torch.Generator().manual_seed(seed)
    aligned = torch.randint(0, n_pad - win + 1, (q, T), generator=g, dtype=torch.int32)
    rows = torch.stack([torch.randperm(n_pad, generator=g) for _ in range(T)])
    rows = torch.where(rows < n_rows, rows, n_rows).to(torch.int32)
    return aligned, rows


def _bits(t):
    return t.view(torch.int32)


def _equal(got, want):
    assert got[0].shape == want[0].shape and got[1].dtype == want[1].dtype == torch.int32
    assert torch.equal(_bits(got[0]), _bits(want[0])) and torch.equal(got[1], want[1])


# ---- the kernel's arithmetic, stated in plain Python ----

def _order_bits(x: float) -> int:
    u = struct.unpack("<I", struct.pack("<f", x))[0]
    img = u ^ (0xFFFFFFFF if u >> 31 else 0x80000000)
    return 0x80000000 if img == 0x7FFFFFFF else img


def _key(score: float, row_id: int) -> int:
    return (_order_bits(score) << 32) | (~((row_id & 0xFFFFFFFF) ^ 0x80000000) & 0xFFFFFFFF)


def _kernel_lane_id(lanes, aligned, rows, win, kk, r, e, score, n_rows):
    """csrc/deduptopk.cu `candidate_id` in the lanes form (None: a pad)."""
    if not score > NEG_INF:
        return None
    v = int(lanes[r, e])
    t, off = (e // kk, v) if kk else (v // win, v % win)
    row_id = int(rows[t, min(int(aligned[r, t]) + off, rows.shape[1] - 1)])
    return row_id if row_id < n_rows else None


def kernel_statement(scores, ids, n_rows, top_k, windows=None):
    """What the kernel computes, row by row: each id's least position (the
    hash table's atomicMin), the survivors' keys (score image over the
    inverted biased id), sorted descending; output t reads the score at its
    id's first position.  Returns the outputs and the survivors counted."""
    q, m = scores.shape
    k = min(top_k, m)
    out_s = torch.full((q, k), NEG_INF)
    out_i = torch.full((q, k), -1, dtype=torch.int32)
    kept = 0
    for r in range(q):
        first = {}
        for e in range(m):
            s = float(scores[r, e])
            if windows is None:
                v = int(ids[r, e])
                row_id = v if v < n_rows else None
            else:
                row_id = _kernel_lane_id(ids, *windows, r, e, s, n_rows)
            if row_id is not None:
                first.setdefault(row_id, e)
        keys = sorted(((_key(float(scores[r, e]), i), e, i) for i, e in first.items()
                       if math.isfinite(float(scores[r, e]))), reverse=True)
        kept += len(keys)
        for t, (_, e, i) in enumerate(keys[:k]):
            out_s[r, t] = scores[r, e]
            out_i[r, t] = i
    return (out_s, out_i), kept


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("q,m,k,n_rows", [(24, 96, 20, 60), (12, 320, 40, 500),
                                          (10, 37, 50, 30), (8, 5, 3, 4), (6, 64, 64, 1000)])
def test_kernel_statement_equals_plain_on_resolved_ids(q, m, k, n_rows, id_dtype):
    s, ids = _pairs(q, m, n_rows, seed=q * m + k, id_dtype=id_dtype)
    want = dedup_topk_plain(s, ids, n_rows, k)
    got, _ = kernel_statement(s, ids, n_rows, k)
    _equal(got, want)


@pytest.mark.parametrize("kk", [12, 0])
@pytest.mark.parametrize("q,T,win,k", [(16, 8, 128, 20), (10, 4, 96, 7)])
def test_kernel_statement_equals_plain_on_lanes(q, T, win, k, kk):
    """The lanes form: per-table (kk) and flat lanes, tied dots with -inf
    and NaN lanes (pads) and +inf lanes (dropped, yet first occurrences)."""
    n_pad, n_rows = 700, 650
    g = torch.Generator().manual_seed(T * win + kk)
    m = T * kk if kk else T * 6
    s = LEVELS[torch.randint(0, len(LEVELS), (q, m), generator=g)]
    s[: q // 2] = torch.randint(-2, 3, (q // 2, m), generator=g).float()
    if kk:
        lanes = torch.randint(0, win, (q, m), generator=g)
    else:
        lanes = torch.randint(0, T * win, (q, m), generator=g)
    aligned, rows = _windows(q, T, win, n_pad, n_rows, seed=kk + 1)
    aligned[0, 0] = n_pad - win // 2                # lanes past the slab clamp to its end
    want = dedup_topk(s, lanes, n_rows, k, aligned, rows, win, kk)
    got, _ = kernel_statement(s, lanes, n_rows, k, (aligned, rows, win, kk))
    _equal(got, want)


def _warp_nth(keys, n):
    """csrc/deduptopk.cu `warp_nth` over a row's keys (0: dropped): the
    bits below the nonzero keys' common high-word prefix set from the top
    while at least n keys stay at or above, stopping where exactly n do."""
    his = [k >> 32 for k in keys if k]
    hmax, hmin = max(his), min(his)
    d = hmax ^ hmin
    if d:
        p = d.bit_length() - 1
        b, lo = 32 + p, (hmax & ~((2 << p) - 1) & 0xFFFFFFFF) << 32
    else:
        b, lo = 31, hmax << 32
    while b >= 0:
        cand = lo | (1 << b)
        c = sum(k >= cand for k in keys)
        if c >= n:
            lo = cand
            if c == n:
                break
        b -= 1
    return lo


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("m", [5, 96, 320, 1000])
def test_kernel_threshold_is_the_nth_largest_key(m, tied):
    """The kernel's threshold leaves exactly n of a row's unique keys at or
    above it, for every 1 <= n < the kept count, on random scores and on
    scores of a few levels (equal high words: the ids decide)."""
    g = torch.Generator().manual_seed(m + tied)
    s = (LEVELS[:5][torch.randint(0, 5, (m,), generator=g)] if tied
         else torch.randn(m, generator=g))
    ids = torch.randperm(4 * m, generator=g)[:m]
    keys = [_key(float(v), int(i)) if torch.rand(1, generator=g) < 0.8 else 0
            for v, i in zip(s, ids)]
    kept = sorted((k for k in keys if k), reverse=True)
    for n in range(1, len(kept)):
        lo = _warp_nth(keys, n)
        assert sum(k >= lo for k in keys) == n and lo <= kept[n - 1]


# ---- the CPU route is the parent's ----

@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("q,m,k,n_rows", [(64, 96, 20, 200), (32, 320, 40, 2000),
                                          (16, 33, 40, 25), (8, 1, 1, 1)])
def test_dedup_topk_pairs_on_cpu_is_the_parents(q, m, k, n_rows, id_dtype):
    s, ids = _pairs(q, m, n_rows, seed=q + m + k, id_dtype=id_dtype)
    _equal(slabscore._dedup_topk_pairs(s, ids, n_rows, k),
           parent_dedup_topk_pairs(s, ids, n_rows, k))


@pytest.mark.parametrize("mode", ["per_table", "per_table_kk", "flat_exact", "flat_width"])
@pytest.mark.parametrize("integer", [True, False])
def test_slab_topk_on_cpu_is_the_parents(mode, integer):
    """Both stage-1 branches, on integer dots (ties at every stage) and on
    masked -inf lanes."""
    g = torch.Generator().manual_seed(11)
    q, L, win, n_pad, n_rows = 48, 8, 128, 1500, 1400
    dots = torch.randn(q, L, win, generator=g)
    if integer:
        dots = dots.mul(2).round()
    dots[:, :, 100:] = NEG_INF if integer else dots[:, :, 100:]
    dots[3] = NEG_INF
    aligned, rows = _windows(q, L, win, n_pad, n_rows, seed=12)
    kw = dict(per_table=dict(exact=False), per_table_kk=dict(exact=False, stage1_per_table=12),
              flat_exact=dict(exact=True), flat_width=dict(exact=False, stage1_width=60))[mode]
    for top_k in (10, 20):
        _equal(slabscore.slab_topk(dots, aligned, rows, n_rows, top_k, **kw),
               parent_slab_topk(dots, aligned, rows, n_rows, top_k, **kw))


# ---- the card route's checks and launch ----

def _lanes_case(q, T, kk, win=128, n_pad=900, n_rows=800, lane_dtype=torch.int64):
    g = torch.Generator().manual_seed(q + T + kk)
    m = T * kk if kk else T * 5
    hi = win if kk else T * win
    lanes = torch.randint(0, hi, (q, m), generator=g).to(lane_dtype)
    aligned, rows = _windows(q, T, win, n_pad, n_rows, seed=kk)
    return torch.randn(q, m, generator=g), lanes, n_rows, aligned, rows, win, kk


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("m", [1, 33, 96, 320, 1025, MAX_M])
def test_card_checks_accept_what_the_plain_version_takes(m, id_dtype):
    """Every shape and id type the plain version runs, the card's checks
    take too (meta tensors of the same shapes), in both forms."""
    for k, n_rows in ((0, 10), (1, 0), (20, 1000), (m + 5, (1 << 31) - 1)):
        s, ids = _pairs(2, m, min(n_rows, 1 << 20), seed=m + k, id_dtype=id_dtype)
        out = dedup_topk(s, ids, n_rows, k)
        assert out[0].shape == (2, min(k, m)) and out[1].dtype == torch.int32
        check_dedup_topk(s.to("meta"), ids.to("meta"), n_rows, k)
    for T, kk in ((8, 12), (4, 0), (1, 1)):
        s, lanes, n_rows, aligned, rows, win, kk = _lanes_case(3, T, kk, lane_dtype=id_dtype)
        out = dedup_topk(s, lanes, n_rows, 20, aligned, rows, win, kk)
        assert out[1].shape == (3, min(20, s.shape[1]))
        check_dedup_topk(*(t.to("meta") for t in (s, lanes)), n_rows, 20,
                         *(t.to("meta") for t in (aligned, rows)), win, kk)


def _bad_resolved(i, fn):
    s, ids = _pairs(4, 96, 50, seed=1)
    args = [s, ids, 50, 20]
    args[i] = fn(args[i])
    return args


@pytest.mark.parametrize("i,fn,err", [
    (0, lambda t: t.double(), TypeError),                 # scores f64
    (0, lambda t: t.bfloat16(), TypeError),               # scores bf16
    (1, lambda t: t.to(torch.int16), TypeError),          # ids int16
    (1, lambda t: t.float(), TypeError),                  # ids as floats
    (1, lambda t: t[:, :50], ValueError),                 # ids of another m
    (0, lambda t: t[None], ValueError),                   # 3-D scores
    (1, lambda t: t.to("meta"), ValueError),              # ids on another device
    (3, lambda k: -1, ValueError),                        # a negative top_k
    (2, lambda n: 1 << 31, ValueError),                   # n_rows past int32
    (2, lambda n: -1, ValueError),                        # a negative n_rows
])
def test_card_checks_raise_on_what_the_kernel_does_not_take(i, fn, err):
    with pytest.raises(err):
        check_dedup_topk(*_bad_resolved(i, fn))


@pytest.mark.parametrize("change,err", [
    ("m_past_max", ValueError), ("aligned_shape", ValueError), ("rows_1d", ValueError),
    ("kk_not_tiling", ValueError), ("kk_past_win", ValueError), ("win_zero", ValueError),
    ("aligned_float", TypeError), ("rows_on_meta", ValueError),
])
def test_card_checks_raise_on_windows_the_kernel_does_not_take(change, err):
    s, lanes, n_rows, aligned, rows, win, kk = _lanes_case(3, 8, 12)
    if change == "m_past_max":
        s, lanes = torch.zeros(2, MAX_M + 1), torch.zeros(2, MAX_M + 1, dtype=torch.int64)
        aligned, rows, kk = None, None, 0
    elif change == "aligned_shape":
        aligned = aligned[:, :4]
    elif change == "rows_1d":
        rows = rows[0]
    elif change == "kk_not_tiling":
        kk = 11
    elif change == "kk_past_win":
        win = 8
    elif change == "win_zero":
        win = 0
    elif change == "aligned_float":
        aligned = aligned.float()
    else:
        rows = rows.to("meta")
    with pytest.raises(err):
        check_dedup_topk(s, lanes, n_rows, 20, aligned, rows, win, kk)


@pytest.fixture
def stub_library(monkeypatch):
    calls = []
    lib = types.SimpleNamespace(crt_dedup_topk=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    return calls


def test_card_route_hands_the_library_its_signature(stub_library):
    """Both forms pass (scores, ids, aligned, rows, out_s, out_i, kept, q, m,
    k, n_rows, id bytes, T, n_pad, win, kk, stream): as many arguments as
    `build._SIGNATURES` declares, null windows in the resolved form, int32
    windows (int64 ones as converted copies), one launch counted a call,
    none where nothing is selected."""
    calls = stub_library
    s, ids = _pairs(6, 96, 50, seed=2, id_dtype=torch.int32)
    before = dedup_topk.launches
    out = deduptopk._launch(s, ids, 50, 20, None, None, 0, 0)
    a = calls[-1]
    assert len(a) == len(build._SIGNATURES["crt_dedup_topk"])
    assert a[:2] == (s.data_ptr(), ids.data_ptr()) and a[2] is None and a[3] is None
    assert a[4:6] == (out[0].data_ptr(), out[1].data_ptr()) and a[6] is None
    assert a[7:] == (6, 96, 20, 50, 4, 0, 0, 0, 0, 7)
    assert out[0].shape == out[1].shape == (6, 20) and out[1].dtype == torch.int32
    s, lanes, n_rows, aligned, rows, win, kk = _lanes_case(5, 8, 12)
    deduptopk._launch(s, lanes, n_rows, 30, aligned.long(), rows, win, kk)
    a = calls[-1]
    assert a[2] != aligned.data_ptr() and a[3] == rows.data_ptr()
    assert a[7:] == (5, 96, 30, n_rows, 8, 8, rows.shape[1], win, 12, 7)
    assert dedup_topk.launches == before + 2
    for q, k in ((0, 20), (5, 0)):
        out = deduptopk._launch(s[:q], lanes[:q], n_rows, k, aligned[:q], rows, win, kk)
        assert out[0].shape == (q, min(k, 96))
    assert len(calls) == 2 and dedup_topk.launches == before + 2


def test_card_route_passes_the_counter_while_tracing(stub_library):
    """While a profiler records, the launch hands the kernel "dedup.kept"'s
    device counter (a 0-d int64 tensor the snapshot reads), and counts q m
    lanes; off, a null pointer and no counter."""
    calls = stub_library
    s, ids = _pairs(4, 96, 50, seed=3)
    timing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        deduptopk._launch(s, ids, 50, 20, None, None, 0, 0)
        kept = timing.TRACER.counters["dedup.kept"]
        assert calls[-1][6] == kept.data_ptr() and kept.dtype == torch.int64
        kept += 17                                # what the kernel would add
        deduptopk._launch(s, ids, 50, 20, None, None, 0, 0)
        assert calls[-1][6] == kept.data_ptr()
    assert timing.snapshot()["counters"] == {"dedup.kept": 17}
    timing.reset()
    deduptopk._launch(s, ids, 50, 20, None, None, 0, 0)
    assert calls[-1][6] is None and timing.snapshot()["counters"] == {}


def test_counters_record_only_while_tracing():
    """On the CPU route "dedup.lanes" sums q m and "dedup.kept" the
    survivors of the id and pad drop (the kernel statement's count), for
    both forms, while a profiler records; nothing otherwise."""
    s, ids = _pairs(12, 96, 60, seed=5)
    s2, lanes, n_rows, aligned, rows, win, kk = _lanes_case(6, 8, 12)
    timing.reset()
    dedup_topk(s, ids, 60, 20)
    assert timing.snapshot()["counters"] == {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        dedup_topk(s, ids, 60, 20)
        dedup_topk(s2, lanes, n_rows, 20, aligned, rows, win, kk)
    _, kept1 = kernel_statement(s, ids, 60, 20)
    _, kept2 = kernel_statement(s2, lanes, n_rows, 20, (aligned, rows, win, kk))
    counters = timing.snapshot()["counters"]
    assert counters == {"dedup.lanes": 12 * 96 + 6 * 96, "dedup.kept": kept1 + kept2}
    assert 0 < kept1 < 12 * 96 and 0 < kept2 <= 6 * 96
    timing.reset()


@pytest.mark.parametrize("q,m,k,id_bytes,T", [(73_421, 96, 20, 8, 8), (8192, 320, 40, 8, 8),
                                              (1000, 640, 10, 4, 0), (7, 5, 9, 8, 0)])
def test_dedup_bound_counts_each_byte_once(q, m, k, id_bytes, T):
    """Scores and ids (or lanes) read once, in the lanes form the aligned
    starts and one 4-byte row id a lane, the [q, min(k, m)] outputs written
    once; no operations."""
    b = bounds.dedup_call(q, m, k, id_bytes, T)
    kout = min(k, m)
    want = (q * m * 4 + q * m * id_bytes + q * kout * 4 + q * kout * 4
            + (q * T * 4 + q * m * 4 if T else 0))
    assert b["bytes"] == want and b["flops"] == 0.0 and b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(want / 3.35e12 * 1e3)


def test_kernel_names_are_not_read_as_another_kernels():
    """The benchmark's readers find K1's and S1's device time by kernel
    name (a substring match): no D1 kernel's name may contain theirs."""
    src = (build.CSRC / "deduptopk.cu").read_text()
    names = re.findall(r"^(\w+)\(const Rows o", src, re.M)      # the __global__ bodies
    assert sorted(names) == ["block_dedup", "warp_dedup"]
    for name in names:
        assert not any(k in name for k in readers.K1_KERNELS + readers.S1_KERNELS), name
