"""K1: slab-window dots + the dedup top-k epilogue (packed retrieval).

Replaces the TPU kernel `crypto_rec_tpu/ops/pallas/slabscore.py`.  For
each query and each of its T table windows, `slab_window_dots` dots the
f32 query with every row of the window in the CSR-ordered slab copy
(int8, bf16 or f32, upcast to f32 before the multiply).  A CUDA tensor
launches the tile-major Hopper kernel in `csrc/slabtile.cu` (or raises); a
CPU tensor runs `slab_window_dots_plain`, a gather + f32 einsum chunked
over queries.

The window geometry is the JAX kernel's, computed here in plain torch so
outputs match lane for lane: each start is aligned DOWN to `ALIGN` rows
and the window widened to `win = ceil((per_table + ALIGN) / WIN_ROUND) *
WIN_ROUND` rows, clamped to end inside the slab; `head` = start - aligned.
Lane j of window (q, t) holds the dot against CSR position
aligned[q, t] + j.  mask=True sets lanes outside [head, head + size) to
-inf (exact reference windows); mask=False (production) keeps every lane —
the aligned overfetch scores real neighbouring CSR rows, a free multiprobe,
and pad-sentinel rows are dropped by id in the epilogue.

The epilogue (`slab_topk`) is two kernels on the card where the JAX package
ran XLA ops outside Pallas: the dedup top-k is D1
(`ops/kernels/deduptopk.dedup_topk`, `csrc/deduptopk.cu`; the plain
sort-dedup on CPU tensors), and the stage-1 selection S1
(`ops/kernels/windowtopk.window_topk`, the Hopper kernel
`csrc/windowtopk.cu` on CUDA tensors, `topk_desc` on CPU ones) per table
window where the TPU ran `approx_max_k` (recall target 0.9), and flat
where JAX runs `lax.top_k` (exact=True) or `approx_max_k`.  It is exact,
so the port's stage-1 survivors are a superset of the TPU's; equal dots
come back lowest lane first, as JAX's selections return them off the TPU
(`approx_max_k` there is `lax.top_k`), so the CPU references agree lane
for lane.  Cosine slabs are pre-normalized by pack_index, so the dot IS
the similarity; euclidean slabs are augmented ([x, -|x|^2/2, 0-pad]) and
dotted with [q, s, 0-pad], so the dot is the rank x.q - |x|^2/2
(`packed_retrieve_pallas_euclid`).
int8 global-scale slabs rank raw dots; callers dequantize scores with the
stored scalar.  `packed_scale` ([L, n_pad] f32, per-row int8 packs) scales
every lane by its slab row's scale, as the JAX package does after its
kernel: the Hopper kernel multiplies each lane as it stores it (pad rows
carry scale 1).  shared_slab=True is the hypercube form: every window reads
one slab (for the MultiCube, C cube segments laid end to end).
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.kernels.deduptopk import dedup_topk
from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
from crypto_rec_tpu_torch.utils import timing

ALIGN = 32         # window starts align down to this many rows
WIN_ROUND = 128    # window length rounds up to a multiple of this

# plain version: bound the gathered [chunk, T, win, d] f32 block to ~1 GB
_PLAIN_BYTES = 1 << 30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_ROW_BYTES = 2048      # the probe wrappers' row limit (`check_row_slab`)


def window_len(per_table: int) -> int:
    return (per_table + ALIGN + WIN_ROUND - 1) // WIN_ROUND * WIN_ROUND


def align_starts(starts: torch.Tensor, align: int, last: int) -> torch.Tensor:
    """Window starts aligned DOWN to `align` rows, clamped to `last` (the
    last start whose window still ends inside the slab), int32."""
    starts = starts.to(torch.int32)
    return torch.clamp(torch.div(starts, align, rounding_mode="floor") * align, max=last)


def row_slab_takes(dtype: torch.dtype, d: int) -> bool:
    """Whether a row-slab kernel takes rows of d values of this dtype:
    whole 16-value chunks, at most _MAX_ROW_BYTES a row."""
    return d % 16 == 0 and d * dtype.itemsize <= _MAX_ROW_BYTES


def check_row_slab(name: str, packed, starts, queries, dtypes) -> None:
    """Raise on what a row-slab kernel ([L, n_pad, d] slabs read as 16-byte
    chunks, <= 2048 B a row) does not take: the slab dtype, d % 16, the
    query shape, operands on other devices, a misaligned slab."""
    if packed.dtype not in dtypes:
        names = "/".join(str(t)[6:] for t in dtypes)
        raise TypeError(f"{name} takes {names} slabs, got {packed.dtype}")
    d = packed.shape[2]
    if not row_slab_takes(packed.dtype, d):
        raise ValueError(f"{name} takes rows of d % 16 == 0 and at most {_MAX_ROW_BYTES} "
                         f"B; got d={d}, {d * packed.element_size()} B")
    if queries.shape != (starts.shape[0], d):
        raise ValueError(f"queries must be [q, {d}], got {tuple(queries.shape)}")
    if starts.device != packed.device or queries.device != packed.device:
        raise ValueError(f"{name}: slabs, starts and queries must share one CUDA device")
    if not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned slab")


def window_chunks(packed: torch.Tensor, row0: torch.Tensor, win: int, elem_bytes: int = 4):
    """Plain versions' gather: yield (s, e, rows [e - s, T, win, d]) in the
    slab's dtype for query chunks [s, e), sized so one chunk's upcast
    ([c, T, win, d] x elem_bytes) stays near 1 GB."""
    q, T = row0.shape
    d = packed.shape[-1]
    flat = packed.reshape(-1, d)
    lane = torch.arange(win, device=packed.device)
    step = max(1, _PLAIN_BYTES // (T * win * d * elem_bytes))
    for s in range(0, q, step):
        e = min(q, s + step)
        yield s, e, flat[row0[s:e].long()[:, :, None] + lane]


def _geometry(packed, starts, sizes, per_table, shared_slab):
    """-> (win, aligned [q, T], row0 [q, T] absolute flat rows, head, size);
    sizes None (maskless callers) gives size None."""
    n_pad = packed.shape[1]
    T = starts.shape[1] if shared_slab else packed.shape[0]
    if shared_slab and packed.shape[0] != 1:
        raise ValueError("shared_slab expects packed [1, n_pad, d]")
    if starts.shape[1] != T or (sizes is not None and sizes.shape != starts.shape):
        raise ValueError("starts and sizes must be [q, L] for L = packed.shape[0]")
    win = window_len(per_table)
    if n_pad < win:
        raise ValueError(f"window {win} exceeds packed length {n_pad}")
    starts = starts.to(torch.int32)
    aligned = align_starts(starts, ALIGN, n_pad - win)
    head = starts - aligned
    size = (None if sizes is None else
            torch.minimum(torch.clamp(sizes.to(torch.int32), max=per_table), win - head))
    # absolute row offsets into the flattened [L * n_pad, d] slab array
    l_off = (
        torch.zeros(T, dtype=torch.int32, device=starts.device) if shared_slab
        else torch.arange(T, dtype=torch.int32, device=starts.device) * n_pad
    )
    return win, aligned, aligned + l_off[None, :], head, size


def _check_sizes(sizes, mask: bool) -> None:
    if mask and sizes is None:
        raise ValueError("mask=True needs the window sizes")


def _check_scale(packed, packed_scale, shared_slab: bool) -> None:
    """packed_scale: None, or f32 [L, n_pad] on the slab's device."""
    if packed_scale is None:
        return
    if shared_slab:
        raise ValueError("shared_slab covers scale-free slabs only")
    if (packed_scale.dtype != torch.float32 or packed_scale.shape != packed.shape[:2]
            or packed_scale.device != packed.device):
        raise ValueError(f"packed_scale must be float32 {list(packed.shape[:2])} on the "
                         f"slab's device, got {packed_scale.dtype} "
                         f"{list(packed_scale.shape)} on {packed_scale.device}")


def _mask(dots, head, size):
    lane = torch.arange(dots.shape[2], device=dots.device)
    valid = (lane >= head[..., None]) & (lane < (head + size)[..., None])
    return torch.where(valid, dots, float("-inf"))


def slab_window_dots_plain(
    packed: torch.Tensor,    # [L, n_pad, d] int8 / bf16 / f32 CSR slabs
    starts: torch.Tensor,    # [q, T] window starts within a table
    sizes,                   # [q, T] valid rows per window (None: mask=False)
    queries: torch.Tensor,   # [q, d] f32, pre-normalized for cosine
    per_table: int,
    mask: bool = True,
    shared_slab: bool = False,
    packed_scale=None,       # [L, n_pad] f32 per-row scales, or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: gather [q, T, win, d], upcast, f32 einsum; with
    packed_scale, times the [q, T, win] gathered scale windows."""
    _check_sizes(sizes, mask)
    _check_scale(packed, packed_scale, shared_slab)
    win, aligned, row0, head, size = _geometry(
        packed, starts, sizes, per_table, shared_slab
    )
    q, T = starts.shape
    qv = queries.float()
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
    for s, e, cand in window_chunks(packed, row0, win):
        dots[s:e] = torch.einsum("qd,qtwd->qtw", qv[s:e], cand.float())
    if packed_scale is not None:
        lane = torch.arange(win, device=packed.device)
        dots *= packed_scale.reshape(-1)[row0.long()[:, :, None] + lane]
    if mask:
        dots = _mask(dots, head, size)
    return dots, aligned


def split_bf16x3(queries: torch.Tensor) -> torch.Tensor:
    """[q, d] f32 -> [q, 3, d] bf16 terms hi, mid, lo with hi + mid + lo ==
    q to f32 precision: each term rounds what the ones before it left.
    int8 and bf16 slab values are exact in bf16, so the three bf16 products
    summed in f32 keep f32 accuracy; hi + mid alone leaves ~2^-16 of |q|
    (beyond K1's tolerance on raw int8 dots).  The tensor-core K1 does this
    split in registers as it stages each query (`split3` in
    `csrc/slabtile.cu`); this is its plain statement, which the tests
    hold to the tolerance."""
    q = queries.float()
    hi = q.to(torch.bfloat16)
    r = q - hi.float()
    mid = r.to(torch.bfloat16)
    return torch.stack([hi, mid, (r - mid.float()).to(torch.bfloat16)], dim=1)


TC_SHAPE = (256, 32)     # (RT, M) of the tensor-core body


def rows_aligned(dtype: torch.dtype, d: int) -> bool:
    """Whether slab rows of d values are whole 16-byte chunks.  The
    tensor-core K1 body then loads a chunk at a time from a slab that must
    be 16-byte aligned (`check_k1`); other rows take its instantiations
    that read int8 4-byte words (d % 4 == 0) or words shifted into place,
    from any address."""
    return d * dtype.itemsize % 16 == 0


def tile_shape(dtype: torch.dtype, d: int) -> Tuple[int, int]:
    """(RT tile rows, M pairs per work item) of the tile-major K1 body that
    takes a slab dtype (`crt_slab_tile_dots` checks the pair): f32 slabs,
    which are not exact in bf16, the FFMA body, 32 and 32; int8 / bf16
    slabs the tensor-core body at every width d (it streams d in 64-wide
    chunks, and reads rows that are not whole 16-byte chunks by 4-byte or
    shifted words), 256 and 32.  No width is kept on FFMA: alone on the
    card the tensor-core body beat the FFMA body that took such rows
    before at the program's int8 d = 15 (0.190 against 0.398 ms) and at
    the recommender's d = 100 (1.535 against 5.373 ms)."""
    if dtype == torch.float32:
        return 32, 32
    return TC_SHAPE


def tile_work(row0: torch.Tensor, win: int, n_rows: int, rt: int, m: int):
    """The tile-major K1's work list, plain torch on row0's device.

    row0: [P] absolute first rows of the windows [row0, row0 + win) in a
    flat slab of n_rows rows.  The pairs are sorted by row0; the slab is cut
    into tiles of rt rows; the pairs whose windows meet tile j have row0 in
    (j rt - win, (j + 1) rt), a contiguous range of the sorted list, cut
    into work items of at most m pairs.  The item count is an upper bound
    from the shapes alone (n_tiles + ceil(P (ceil(win / rt) + 1) / m)), so
    nothing waits on the device; the real items come first and every item
    after them has count 0.

    -> (pairs [P] int32 sorted by row0, item_tile, item_lo, item_cnt [I]
    int32: tile, first sorted position and pair count of each item)."""
    dev = row0.device
    P = row0.numel()
    sr, order = torch.sort(row0.reshape(-1).to(torch.int32))
    n_tiles = -(-n_rows // rt)
    t0 = torch.arange(0, n_tiles * rt, rt, device=dev, dtype=torch.int32)
    # lo: first row0 > t0 - win; hi: first row0 >= t0 + rt
    lo, hi = torch.searchsorted(sr, torch.stack([t0 - (win - 1), t0 + rt]), out_int32=True)
    per = torch.div(hi - lo + (m - 1), m, rounding_mode="floor")  # items of each tile
    cum = torch.cumsum(per, 0, dtype=torch.int32)
    n_items = n_tiles + -(-P * (-(-win // rt) + 1) // m)
    i = torch.arange(n_items, device=dev, dtype=torch.int32)
    tile = torch.searchsorted(cum, i, right=True, out_int32=True).clamp_(max=n_tiles - 1)
    # per tile: the sorted position item i would start at, less i m; past
    # the real items tile is the last one and its start passes hi, so the
    # count clamps to 0
    base_hi = torch.stack([lo - (cum - per) * m, hi])[:, tile]
    item_lo = base_hi[0] + i * m
    cnt = (base_hi[1] - item_lo).clamp_(0, m)
    return order.to(torch.int32), tile, item_lo, cnt


def tile_plan(packed: torch.Tensor, row0, head, size, win: int):
    """The work list for one K1 call and its pairs' fields in sorted order:
    -> (meta int32 [4, P] (pair id, row0, head, head + size), or [2, P]
    without the mask (size None); item_tile, item_lo, item_cnt)."""
    n_rows = packed.shape[0] * packed.shape[1]
    rt, m = tile_shape(packed.dtype, packed.shape[2])
    pairs, item_tile, item_lo, item_cnt = tile_work(row0, win, n_rows, rt, m)
    p = pairs.long()
    if size is None:
        return torch.stack([pairs, row0.reshape(-1)[p]]), item_tile, item_lo, item_cnt
    fields = torch.stack([row0.reshape(-1), head.reshape(-1), (head + size).reshape(-1)])
    return torch.cat([pairs[None], fields[:, p]]), item_tile, item_lo, item_cnt


def probe_tile_rows(d: int) -> int:
    """Staged bf16 rows a tile of the tensor-core probe kernels
    (`csrc/probetile.cu`: P3 binned, P6 int4, whose packed rows unpack
    into two bf16 rows each): 128 at d <= 128, 64 at d = 256 (32 KB)."""
    return 128 if d <= 128 else 64


def tile_launch(packed: torch.Tensor, queries: torch.Tensor, plan,
                dots: torch.Tensor, mask: bool, scale=None) -> None:
    """Launch the tile-major kernel (`csrc/slabtile.cu`) on a plan from
    `tile_plan` and contiguous, 16-byte aligned f32 queries [q, d].
    Writes dots [q, T, win]; scale: contiguous f32 [L, n_pad] per-row
    scales, or None.  Traced (`timing`): the counter "k1.tc_calls" counts
    the launches of the tensor-core body."""
    meta, item_tile, item_lo, item_cnt = plan
    d = packed.shape[2]
    rt, m = tile_shape(packed.dtype, d)
    if (rt, m) == TC_SHAPE:
        timing.count("k1.tc_calls", 1)
    with torch.cuda.device(packed.device):
        err = build.library().crt_slab_tile_dots(
            packed.data_ptr(), queries.data_ptr(), None if scale is None else scale.data_ptr(),
            meta.data_ptr(), item_tile.data_ptr(),
            item_lo.data_ptr(), item_cnt.data_ptr(), dots.data_ptr(), item_tile.numel(),
            meta.shape[1], dots.shape[1], dots.shape[2], d,
            packed.shape[0] * packed.shape[1], int(mask),
            _DTYPE_CODE[packed.dtype], rt, m, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "slab_window_dots")


def _check_tile_slab(packed: torch.Tensor) -> None:
    """The probe kernels' tile-major bodies (`csrc/probetile.cu`: P2-P6)
    stage whole rows: d % 64 == 0 and d <= 256 (f32 rows d % 4 == 0)."""
    d = packed.shape[2]
    if packed.dtype == torch.float32:
        ok = d % 4 == 0 and d <= 256
    else:
        ok = d % 64 == 0 and d <= 256
    if not ok:
        raise ValueError(f"the tile-major slab kernel takes d <= 256 with d % "
                         f"{4 if packed.dtype == torch.float32 else 64} == 0 "
                         f"for {str(packed.dtype)[6:]} slabs, got d={d}")
    if packed.numel() // d >= 1 << 31:
        raise ValueError("the slab kernel indexes rows with int32")


def check_k1(packed: torch.Tensor, starts: torch.Tensor, queries: torch.Tensor) -> None:
    """Raise on what K1's card route does not take, before any launch:
    slabs other than int8 / bf16 / f32, queries not [q, d], operands on
    other devices, a slab that is not contiguous (or, where its rows are
    whole 16-byte chunks, not 16-byte aligned), more rows or (query,
    window) pairs than int32 counts.  Any row width: the tensor-core body
    streams d in chunks and loads rows of any alignment, the FFMA body
    takes any f32 row."""
    if packed.dtype not in _DTYPE_CODE:
        raise TypeError(f"the slab kernel takes int8/bfloat16/float32 slabs, "
                        f"got {packed.dtype}")
    d = packed.shape[2]
    if queries.shape != (starts.shape[0], d):
        raise ValueError(f"queries must be [q, {d}], got {tuple(queries.shape)}")
    if starts.device != packed.device or queries.device != packed.device:
        raise ValueError("the slab kernel: slabs, starts and queries must share one "
                         "CUDA device")
    if not packed.is_contiguous() or (rows_aligned(packed.dtype, d)
                                      and packed.data_ptr() % 16):
        raise ValueError("the slab kernel needs a contiguous slab, 16-byte aligned "
                         "where its rows are")
    if packed.shape[0] * packed.shape[1] >= 1 << 31 or starts.numel() >= 1 << 31:
        raise ValueError("the slab kernel indexes rows and pairs with int32")


def card_geometry(packed, starts, sizes, queries, per_table, mask, shared_slab,
                  packed_scale=None):
    """Every check K1's card route makes before its launch (plain torch,
    so it runs on any device) -> its geometry (win, aligned, row0, head,
    size; size None with the mask off).  Where the JAX function raises too:
    a window longer than the slab, mask=True without sizes, a scale with
    shared_slab."""
    _check_sizes(sizes, mask)
    _check_scale(packed, packed_scale, shared_slab)
    check_k1(packed, starts, queries)
    win, aligned, row0, head, size = _geometry(
        packed, starts, sizes if mask else None, per_table, shared_slab)
    return win, aligned, row0.contiguous(), head.contiguous(), size


def slab_window_dots(
    packed: torch.Tensor,
    starts: torch.Tensor,
    sizes,
    queries: torch.Tensor,
    per_table: int,
    mask: bool = True,
    shared_slab: bool = False,
    packed_scale=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dots [q, T, win] f32, aligned window starts [q, T] int32, LOCAL
    to each table).  Arguments as `slab_window_dots_plain`.

    shared_slab=True: `packed` is ONE slab ([1, n_pad, d]) that every one
    of the starts.shape[1] windows reads (the hypercube form).
    packed_scale: [L, n_pad] f32 per-row scales (pad rows 1): every lane is
    multiplied by its slab row's scale before the mask; not with
    shared_slab.

    CPU tensors take the plain version; CUDA tensors the tile-major Hopper
    kernel (`csrc/slabtile.cu`), scale included, at any row width
    (`card_geometry` holds its checks); its work list (`tile_plan`) runs
    here on the device, inside K1's time.

    Traced (`timing`): spans "k1.plan" (the checks, geometry and work list)
    and "k1" (the launch; on the CPU the plain call), and, where the window
    sizes are given, the counters "k1.lanes" and "k1.window_rows"
    (`_count_lanes`)."""
    if timing.tracing() and sizes is not None:
        _count_lanes(packed, starts, sizes, per_table)
    if not packed.is_cuda:
        with timing.span("k1"):
            return slab_window_dots_plain(
                packed, starts, sizes, queries, per_table, mask, shared_slab, packed_scale
            )
    with timing.span("k1.plan"):
        win, aligned, row0, head, size = card_geometry(
            packed, starts, sizes, queries, per_table, mask, shared_slab, packed_scale)
        q, T = starts.shape
        dots = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
        if q == 0:
            return dots, aligned
        qv = queries.float().contiguous()
        if qv.data_ptr() % 16:
            qv = qv.clone()
        scale = None if packed_scale is None else packed_scale.contiguous()
        with torch.cuda.device(packed.device):
            plan = tile_plan(packed, row0, head, size, win)
    with timing.span("k1"):
        tile_launch(packed, qv, plan, dots, mask, scale)
    slab_window_dots.launches += 1
    return dots, aligned


def _count_lanes(packed, starts, sizes, per_table: int) -> None:
    """Count one K1 call's lanes (q T win, a host int) as "k1.lanes" and
    the lanes that hold rows of the query's own bucket window (each
    window's size as `_geometry` clips it, summed on the device) as
    "k1.window_rows"."""
    win = window_len(per_table)
    head = starts.to(torch.int32) - align_starts(starts, ALIGN, packed.shape[1] - win)
    rows = torch.minimum(torch.clamp(sizes.to(torch.int32), max=per_table), win - head)
    timing.count("k1.lanes", starts.numel() * win)
    timing.count("k1.window_rows", torch.clamp(rows, min=0).sum(dtype=torch.int64))


slab_window_dots.launches = 0


# the JAX function's name, which the resolved-id callers import: D1 on the
# card, the plain sort-dedup on the CPU
_dedup_topk_pairs = dedup_topk


def slab_topk(
    dots: torch.Tensor,            # [q, T, win] from slab_window_dots
    aligned_starts: torch.Tensor,  # [q, T] local CSR positions of lane 0
    packed_rows: torch.Tensor,     # [L, n_pad] int32 CSR-ordered row ids
    n_rows: int,
    top_k: int,
    exact: bool = True,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-stage dedup top-k over kernel dots.

    Stage 1 (exact=False, production) selects PER TABLE WINDOW: the top kk
    lanes of each [win] row (`window_topk`: S1 on the card, equal dots
    lowest lane first, as JAX's `approx_max_k` off the TPU and
    `lax.top_k`).  Rows within one window are distinct corpus
    rows, so if >= top_k lanes beat a lane in its own window, >= top_k
    distinct rows beat it globally — the union of per-window top-k's
    contains the global dedup top-k.  stage1_per_table overrides kk below
    top_k (relaxing that guarantee to kk, the top-P > 10 CF form).
    exact=True, or a stage1_width without stage1_per_table, selects the
    flat top min(L * top_k, stage1_width) over [q, T * win].  Stage 2 is
    D1 on S1's lanes (`dedup_topk`'s lanes form): each lane's row id from
    packed_rows, the id dedup, the final top_k; one launch on the card.

    -> (scores [q, top_k] descending, row ids [q, top_k] int32, -1 pad)."""
    q, L, win = dots.shape
    if not exact and (stage1_per_table or not stage1_width):
        kk = min(max(stage1_per_table or top_k, -(-top_k // L)), win)
        with timing.span("s1"):
            s1, lane = window_topk(dots.reshape(q * L, win), kk)
        s1, lane = s1.reshape(q, L * kk), lane.reshape(q, L * kk)
    else:
        kk = 0
        m1 = min(L * top_k, L * win)
        if stage1_width:
            m1 = min(m1, max(stage1_width, top_k))
        with timing.span("s1"):
            s1, lane = window_topk(dots.reshape(q, L * win), m1)
    with timing.span("dedup"):
        return dedup_topk(s1, lane, n_rows, top_k, aligned_starts, packed_rows, win, kk)


def _window_offsets(bucket_starts, q_buckets, per_table, salt=None):
    """Per (query, window) start and size: the JAX package's pseudo-random
    offset into oversized buckets (int32 wraparound, floor-mod), computed
    in int64 and wrapped to int32.

    bucket_starts: [T, n_buckets + 1], the CSR offsets window t reads —
    one row per table for the LSH index; the cubes pass their one row
    expanded to T.  salt: [T] window salts, arange(T) by default (the
    table index; the cubes salt by probe index, offset per cube)."""
    T = q_buckets.shape[1]
    t_idx = torch.arange(T, device=q_buckets.device)
    salt = t_idx if salt is None else salt.long()
    qb = q_buckets.long()
    start = bucket_starts[t_idx[None, :], qb].long()                    # [q, T]
    end = bucket_starts[t_idx[None, :], qb + 1].long()
    size = end - start
    mix = (qb * -1640531527) ^ (salt[None, :] * 40503)
    mix = (mix + (1 << 31)) % (1 << 32) - (1 << 31)       # low 32 bits, signed
    # jnp.abs on int32 leaves INT32_MIN negative
    amix = torch.where(mix == -(1 << 31), mix, mix.abs())
    s0 = start + torch.remainder(amix, torch.clamp(size - per_table, min=0) + 1)
    sizes = torch.clamp(end - s0, max=per_table)
    return s0.to(torch.int32), sizes.to(torch.int32)


def augment_queries(queries: torch.Tensor, aug_scale, d_aug: int) -> torch.Tensor:
    """[q, d] raw euclidean queries -> [q, d_aug] f32 rows [q, s, 0-pad]:
    their plain dot with an augmented slab row is the rank x.q - |x|^2/2
    (int8 slabs: in units of the global scale)."""
    qv = queries.float()
    q, d = qv.shape
    s = torch.as_tensor(aug_scale, dtype=torch.float32, device=qv.device)
    return torch.cat([qv, s.reshape(1, 1).expand(q, 1),
                      torch.zeros(q, d_aug - d - 1, device=qv.device)], dim=1)


def rank_to_distance(rank, ids, queries, gscale):
    """Top-k ranks -> -sqrt(max(|q|^2 - 2 rank, 0)) = -distance, -inf on
    pads; int8 ranks are dequantized with the global scale first."""
    if gscale is not None:
        rank = rank * gscale
    qv = queries.float()
    qsq = torch.sum(qv * qv, dim=1, keepdim=True)
    score = -torch.sqrt(torch.clamp(qsq - 2.0 * rank, min=0.0))
    return torch.where(ids >= 0, score, float("-inf")), ids


def packed_retrieve_pallas(
    packed: torch.Tensor,         # [L, n_pad, d] CSR-ordered corpus copies
    packed_rows: torch.Tensor,    # [L, n_pad] int32, sentinel n past the end
    bucket_starts: torch.Tensor,  # [L, n_buckets + 1]
    n_rows: int,
    queries: torch.Tensor,        # [q, d]
    q_buckets: torch.Tensor,      # [q, L]
    top_k: int,
    per_table: int,
    strict: bool = False,
    stage1_width: int = 0,
    stage1_per_table: int = 0,
    packed_scale=None,            # [L, n_pad] f32 (per-row int8 slabs)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused retrieval over the packed layout (cosine, unfiltered):
    window offsets -> K1 dots -> dedup top-k.  The name is the JAX
    function's; the dots come from the Hopper kernel on CUDA tensors.
    packed_scale: the per-row int8 pack's scales, applied by K1 (scores
    are then dequantized similarities); None for scale-free slabs.

    strict=False (production): maskless aligned-overfetch windows + the
    per-table stage 1.  strict=True: exact reference window semantics and
    an exact flat top-k, for parity."""
    with timing.span("windows"):
        s0, sizes = _window_offsets(bucket_starts, q_buckets, per_table)
        qv = queries.float()
        qv = qv / torch.clamp(torch.sqrt(torch.sum(qv * qv, dim=1, keepdim=True)), min=1e-30)
    dots, a0 = slab_window_dots(packed, s0, sizes, qv, per_table, mask=strict,
                                packed_scale=packed_scale)
    return slab_topk(dots, a0, packed_rows, n_rows, top_k, exact=strict,
                     stage1_width=stage1_width, stage1_per_table=stage1_per_table)


def euclid_window_offsets(bucket_starts, packed_detailed, q_buckets, q_detailed,
                          per_table):
    """Window starts of the euclidean tables: the query's exact-fingerprint
    run in the (bucket, fingerprint)-sorted slab when the fingerprint plane
    is given, else the salted offset of `_window_offsets`."""
    if packed_detailed is None or q_detailed is None:
        return _window_offsets(bucket_starts, q_buckets, per_table)
    from crypto_rec_tpu_torch.models.lsh.index import _fp_run_starts

    L, n_pad = packed_detailed.shape
    l_idx = torch.arange(L, device=q_buckets.device)
    qb = q_buckets.long()
    start = bucket_starts[l_idx[None, :], qb]                           # [q, L]
    end = bucket_starts[l_idx[None, :], qb + 1]
    flat_fp = packed_detailed.reshape(-1)
    base = l_idx[None, :] * n_pad
    s0 = _fp_run_starts(lambda p: flat_fp[base + p], start, end, q_detailed, n_pad)
    return s0, torch.clamp(end - s0, max=per_table).to(torch.int32)


def packed_retrieve_pallas_euclid(
    packed: torch.Tensor,         # [L, n_pad, d_aug] AUGMENTED slabs
    packed_rows: torch.Tensor,    # [L, n_pad] int32, sentinel n past the end
    packed_detailed,              # [L, n_pad] fingerprints or None
    bucket_starts: torch.Tensor,  # [L, n_buckets + 1]
    n_rows: int,
    d: int,                       # original (un-augmented) dimensionality
    queries: torch.Tensor,        # [q, d] RAW euclidean queries
    q_buckets: torch.Tensor,      # [q, L]
    q_detailed,                   # [q, L] fingerprints or None
    gscale,                       # f32 scalar (int8 slabs) or None
    aug_scale,                    # f32 scalar: the norm column's query entry
    top_k: int,
    per_table: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean retrieval over AUGMENTED slabs (pack_index augment=True):
    K1's plain dot against the augmented query [q, s, 0-pad] is the
    monotone rank x.q - |x|^2/2, so euclidean rides the same maskless
    windows and per-table stage 1 as cosine; the top_k ranks map to
    -sqrt(max(|q|^2 - 2 rank, 0)) = -distance.  Windows start at the
    query's fingerprint run when the plane is given; the lanes past it are
    the aligned-overfetch multiprobe, scored by true distance.  The name
    is the JAX function's."""
    if queries.shape[1] != d:
        raise ValueError(f"queries must be [q, {d}], got {tuple(queries.shape)}")
    with timing.span("windows"):
        s0, sizes = euclid_window_offsets(bucket_starts, packed_detailed, q_buckets,
                                          q_detailed, per_table)
        q_aug = augment_queries(queries, aug_scale, packed.shape[2])
    dots, a0 = slab_window_dots(packed, s0, sizes, q_aug, per_table, mask=False)
    rank, ids = slab_topk(dots, a0, packed_rows, n_rows, top_k, exact=False)
    return rank_to_distance(rank, ids, queries, gscale)
