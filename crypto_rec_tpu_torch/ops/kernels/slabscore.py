"""K1: slab-window dots + the dedup top-k epilogue (packed retrieval).

Replaces the TPU kernel `crypto_rec_tpu/ops/pallas/slabscore.py`.  For
each query and each of its T table windows, `slab_window_dots` dots the
f32 query with every row of the window in the CSR-ordered slab copy
(int8, bf16 or f32, upcast to f32 before the multiply).  A CUDA tensor
launches the Hopper kernel in `csrc/slabscore.cu` (or raises); a CPU tensor
runs `slab_window_dots_plain`, a gather + f32 einsum chunked over queries.

The window geometry is the JAX kernel's, computed here in plain torch so
outputs match lane for lane: each start is aligned DOWN to `ALIGN` rows
and the window widened to `win = ceil((per_table + ALIGN) / WIN_ROUND) *
WIN_ROUND` rows, clamped to end inside the slab; `head` = start - aligned.
Lane j of window (q, t) holds the dot against CSR position
aligned[q, t] + j.  mask=True sets lanes outside [head, head + size) to
-inf (exact reference windows); mask=False (production) keeps every lane —
the aligned overfetch scores real neighbouring CSR rows, a free multiprobe,
and pad-sentinel rows are dropped by id in the epilogue.

The epilogue (`slab_topk`, `_dedup_topk_pairs`) is plain torch, as the JAX
package ran it outside Pallas.  Stage 1 here is an EXACT `torch.topk` per
table window where the TPU ran `approx_max_k` (recall target 0.9): the
port's stage-1 survivors are a superset of the TPU's.  Off the TPU,
`approx_max_k` is exact, so the CPU references agree.  Cosine slabs are
pre-normalized by pack_index, so the dot IS the similarity; euclidean
slabs are augmented ([x, -|x|^2/2, 0-pad]) and dotted with [q, s, 0-pad],
so the dot is the rank x.q - |x|^2/2 (`packed_retrieve_pallas_euclid`).
int8 global-scale slabs rank raw dots; callers dequantize scores with the
stored scalar.  shared_slab=True is the hypercube form: every window reads
one slab (for the MultiCube, C cube segments laid end to end).
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels import build

ALIGN = 32         # window starts align down to this many rows
WIN_ROUND = 128    # window length rounds up to a multiple of this

# plain version: bound the gathered [chunk, T, win, d] f32 block to ~1 GB
_PLAIN_BYTES = 1 << 30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_ROW_BYTES = 2048      # the kernel keeps <= 4 16-byte chunks per lane


def window_len(per_table: int) -> int:
    return (per_table + ALIGN + WIN_ROUND - 1) // WIN_ROUND * WIN_ROUND


def _geometry(packed, starts, sizes, per_table, shared_slab):
    """-> (win, aligned [q, T], row0 [q, T] absolute flat rows, head, size)."""
    n_pad = packed.shape[1]
    T = starts.shape[1] if shared_slab else packed.shape[0]
    if shared_slab and packed.shape[0] != 1:
        raise ValueError("shared_slab expects packed [1, n_pad, d]")
    if starts.shape[1] != T or sizes.shape != starts.shape:
        raise ValueError("starts and sizes must be [q, L] for L = packed.shape[0]")
    win = window_len(per_table)
    if n_pad < win:
        raise ValueError(f"window {win} exceeds packed length {n_pad}")
    starts = starts.to(torch.int32)
    aligned = torch.clamp(
        torch.div(starts, ALIGN, rounding_mode="floor") * ALIGN, max=n_pad - win
    )
    head = starts - aligned
    size = torch.minimum(torch.clamp(sizes.to(torch.int32), max=per_table), win - head)
    # absolute row offsets into the flattened [L * n_pad, d] slab array
    l_off = (
        torch.zeros(T, dtype=torch.int32, device=starts.device) if shared_slab
        else torch.arange(T, dtype=torch.int32, device=starts.device) * n_pad
    )
    return win, aligned, aligned + l_off[None, :], head, size


def _mask(dots, head, size):
    lane = torch.arange(dots.shape[2], device=dots.device)
    valid = (lane >= head[..., None]) & (lane < (head + size)[..., None])
    return torch.where(valid, dots, float("-inf"))


def slab_window_dots_plain(
    packed: torch.Tensor,    # [L, n_pad, d] int8 / bf16 / f32 CSR slabs
    starts: torch.Tensor,    # [q, T] window starts within a table
    sizes: torch.Tensor,     # [q, T] valid rows per window
    queries: torch.Tensor,   # [q, d] f32, pre-normalized for cosine
    per_table: int,
    mask: bool = True,
    shared_slab: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: gather [q, T, win, d], upcast, f32 einsum."""
    win, aligned, row0, head, size = _geometry(
        packed, starts, sizes, per_table, shared_slab
    )
    q, T = starts.shape
    d = packed.shape[2]
    flat = packed.reshape(-1, d)
    qv = queries.float()
    lane = torch.arange(win, device=packed.device)
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
    step = max(1, _PLAIN_BYTES // (T * win * d * 4))
    for s in range(0, q, step):
        rows = row0[s:s + step].long()[:, :, None] + lane          # [c, T, win]
        cand = flat[rows].float()                                  # [c, T, win, d]
        dots[s:s + step] = torch.einsum("qd,qtwd->qtw", qv[s:s + step], cand)
    if mask:
        dots = _mask(dots, head, size)
    return dots, aligned


def slab_window_dots(
    packed: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    queries: torch.Tensor,
    per_table: int,
    mask: bool = True,
    shared_slab: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dots [q, T, win] f32, aligned window starts [q, T] int32, LOCAL
    to each table).  Arguments as `slab_window_dots_plain`.

    shared_slab=True: `packed` is ONE slab ([1, n_pad, d]) that every one
    of the starts.shape[1] windows reads (the hypercube form).

    CPU tensors take the plain version; CUDA tensors the Hopper kernel."""
    if not packed.is_cuda:
        return slab_window_dots_plain(
            packed, starts, sizes, queries, per_table, mask, shared_slab
        )
    if packed.dtype not in _DTYPE_CODE:
        raise TypeError(f"the slab kernel takes int8/bf16/f32 slabs, got {packed.dtype}")
    d = packed.shape[2]
    if d % 16:
        raise ValueError(f"the slab kernel needs d % 16 == 0, got d={d}")
    if d * packed.element_size() > _MAX_ROW_BYTES:
        raise ValueError(f"slab rows of {d * packed.element_size()} B exceed "
                         f"the kernel's {_MAX_ROW_BYTES} B")
    if queries.shape != (starts.shape[0], d):
        raise ValueError(f"queries must be [q, {d}], got {tuple(queries.shape)}")
    if starts.device != packed.device or queries.device != packed.device:
        raise ValueError("slabs, starts and queries must share one CUDA device")
    if not packed.is_contiguous() or packed.data_ptr() % 16:
        raise ValueError("the slab kernel needs a contiguous, 16-byte aligned slab")
    win, aligned, row0, head, size = _geometry(
        packed, starts, sizes, per_table, shared_slab
    )
    q, T = starts.shape
    qv = queries.float().contiguous()
    row0, head, size = row0.contiguous(), head.contiguous(), size.contiguous()
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = build.library().crt_slab_window_dots(
            packed.data_ptr(), qv.data_ptr(), row0.data_ptr(), head.data_ptr(),
            size.data_ptr(), dots.data_ptr(), q, T, win, d, int(mask),
            _DTYPE_CODE[packed.dtype], torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "slab_window_dots")
    slab_window_dots.launches += 1
    return dots, aligned


slab_window_dots.launches = 0


def _dedup_topk_pairs(
    scores: torch.Tensor,   # [q, m] with -inf pads
    ids: torch.Tensor,      # [q, m] with sentinel >= n_rows on pads
    n_rows: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-dedup (score, id) pairs by id and re-select top_k: a stable
    sort of the ids, scores gathered by the returned permutation."""
    raw_sorted, perm = torch.sort(ids, dim=1, stable=True)
    s_sorted = torch.gather(scores, 1, perm)
    dup = torch.zeros_like(raw_sorted, dtype=torch.bool)
    dup[:, 1:] = raw_sorted[:, 1:] == raw_sorted[:, :-1]
    s_sorted = torch.where(
        dup | (raw_sorted >= n_rows) | ~torch.isfinite(s_sorted),
        float("-inf"), s_sorted,
    )
    s2, pos2 = torch.topk(s_sorted, top_k, dim=1)
    ids_sorted = torch.clamp(raw_sorted, max=n_rows - 1)
    out_ids = torch.where(
        s2 > float("-inf"), torch.gather(ids_sorted, 1, pos2), -1
    )
    return s2, out_ids.to(torch.int32)


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
    lanes of each [win] row.  Rows within one window are distinct corpus
    rows, so if >= top_k lanes beat a lane in its own window, >= top_k
    distinct rows beat it globally — the union of per-window top-k's
    contains the global dedup top-k.  stage1_per_table overrides kk below
    top_k (relaxing that guarantee to kk, the top-P > 10 CF form).
    exact=True, or a stage1_width without stage1_per_table, selects the
    flat top min(L * top_k, stage1_width) over [q, T * win].  Stage 2
    gathers the survivors' row ids from packed_rows and sort-dedups to the
    final top_k.

    -> (scores [q, top_k] descending, row ids [q, top_k] int32, -1 pad)."""
    q, L, win = dots.shape
    n_pad = packed_rows.shape[1]
    flat_rows = packed_rows.reshape(-1)
    l_base = torch.arange(L, device=dots.device)[None, :] * n_pad        # [1, L]
    a0 = aligned_starts.long()
    if not exact and (stage1_per_table or not stage1_width):
        kk = min(max(stage1_per_table or top_k, -(-top_k // L)), win)
        s1, lane = torch.topk(dots.reshape(q * L, win), kk, dim=1)
        s1 = s1.reshape(q, L * kk)
        gpos = l_base[:, :, None] + torch.clamp(
            a0[:, :, None] + lane.reshape(q, L, kk), max=n_pad - 1
        )
        ids1 = flat_rows[gpos.reshape(q, L * kk)]
    else:
        flat = dots.reshape(q, L * win)
        m1 = min(L * top_k, L * win)
        if stage1_width:
            m1 = min(m1, max(stage1_width, top_k))
        s1, pos1 = torch.topk(flat, m1, dim=1)
        l_of = torch.div(pos1, win, rounding_mode="floor")
        lane = pos1 % win
        gpos = l_of * n_pad + torch.clamp(
            torch.gather(a0, 1, l_of) + lane, max=n_pad - 1
        )
        ids1 = flat_rows[gpos]
    ids1 = torch.where(s1 > float("-inf"), ids1, n_rows)
    return _dedup_topk_pairs(s1, ids1, n_rows, top_k)


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused retrieval over the packed layout (cosine, unfiltered, scale-free
    slabs): window offsets -> K1 dots -> dedup top-k.  The name is the JAX
    function's; the dots come from the Hopper kernel on CUDA tensors.

    strict=False (production): maskless aligned-overfetch windows + the
    per-table stage 1.  strict=True: exact reference window semantics and
    an exact flat top-k, for parity."""
    s0, sizes = _window_offsets(bucket_starts, q_buckets, per_table)
    qv = queries.float()
    qv = qv / torch.clamp(torch.sqrt(torch.sum(qv * qv, dim=1, keepdim=True)), min=1e-30)
    dots, a0 = slab_window_dots(packed, s0, sizes, qv, per_table, mask=strict)
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
    s0, sizes = euclid_window_offsets(bucket_starts, packed_detailed, q_buckets,
                                      q_detailed, per_table)
    q_aug = augment_queries(queries, aug_scale, packed.shape[2])
    dots, a0 = slab_window_dots(packed, s0, sizes, q_aug, per_table, mask=False)
    rank, ids = slab_topk(dots, a0, packed_rows, n_rows, top_k, exact=False)
    return rank_to_distance(rank, ids, queries, gscale)
