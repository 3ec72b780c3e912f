"""D1: the dedup top-k epilogue of the packed retrieval (K1 -> S1 -> D1).

Per row of m (score, candidate) pairs: a candidate is dropped when its id
is >= n_rows, its score is not finite, or an earlier position of the row
holds the same id (the first occurrence decides, whatever a later duplicate
scores); of the survivors the best min(top_k, m) come back, score
descending, equal scores (+0.0 and -0.0 equal) lowest id first, -inf and
-1 in empty slots.  This is the JAX package's `_dedup_topk_pairs`
(crypto_rec_tpu/ops/pallas/slabscore.py:399), which runs as XLA ops.

`dedup_topk` routes by device, as `cf_predict` does: a CUDA tensor launches
the Hopper kernel in `csrc/deduptopk.cu` (and raises where it cannot), a
CPU tensor runs `dedup_topk_plain`, the JAX function's ops in torch (a
stable id sort, a gather, `topk_desc`'s stable descending sort).  The
kernel replaces no TPU kernel: it reads each pair once and writes the top
min(top_k, m), with nothing of [q, m] in device memory.

Two operand forms, chosen by the operands passed:
- resolved: `ids` [q, m] row ids (int32 / int64).  `_dedup_topk_pairs`'s
  callers: the cubes' `_shared_slab_topk` and `_cube_retrieve_kernel`,
  `_stage_dedup` (`packed_retrieve_core`), P3's `binned_topk`, P6's
  `slab_topk_int4`.
- lanes: `ids` holds S1's lanes [q, m] of the windows `aligned_starts`
  [q, T] and `packed_rows` [T, n_pad] (`win` lanes a window); kk > 0: the
  per-table stage 1, kk lanes of each window, m = T kk; kk = 0: flat lanes
  in [0, T win).  A lane's row id is `lane_rows`' and a lane whose score
  is -inf (or NaN) a pad.  `slab_topk`'s callers: both cells' paths
  (`packed_retrieve_pallas`), `packed_retrieve_pallas_euclid`,
  `candidate_ids_scored` (fused CV, clustering), the sharded engines'
  per-shard legs.

The largest m each caller passes (the kernel takes m <= MAX_M = 8,192, one
warp a row up to 1,024, one block a row past it):
- `slab_topk` per-table: T kk, kk = min(max(stage1_per_table or top_k,
  ceil(top_k / T)), win): the CF cell 8 x 12 = 96, the batch cell 8 x 40 =
  320; `candidate_ids_scored` T ceil(budget / T) (the CV paths' budget 512:
  at most 512 + T - 1); the sharded legs T min(top_k, win);
- `slab_topk` flat: min(T top_k, T win, max(stage1_width, top_k));
- `_shared_slab_topk`: windows x min(top_k, win) (chip_smoke's euclidean
  MultiCube 72 x 10 = 720); `_cube_retrieve_kernel`: max(4 top_k, 16);
- `_stage_dedup`: T top_k (the blocked cube path: probes x min(4 top_k,
  probes top_k)); P3: nbins (128, 256); P6: L kk.
MAX_M is reached only where one of these passes 8,192, e.g. T top_k at
top_k > 1,024 and L = 8.

Counters, recorded only while a profiler records (`utils/timing`), on both
routes: "dedup.lanes" (q m, a host int) and "dedup.kept" (the candidates
that survive the id and pad drop, on the device); their ratio is the share
of stage-1 lanes that are distinct rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.topk import topk_desc
from crypto_rec_tpu_torch.utils import timing

MAX_M = 8192          # candidates a row: the shared memory of one block (csrc/deduptopk.cu)
_INT32_MAX = (1 << 31) - 1


def dedup_topk_plain(
    scores: torch.Tensor,   # [q, m] with -inf pads
    ids: torch.Tensor,      # [q, m] with sentinel >= n_rows on pads
    n_rows: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-dedup (score, id) pairs by id and re-select top_k: a stable
    sort of the ids, scores gathered by the returned permutation; equal
    scores keep the lower id first (`topk_desc`), as `lax.top_k` does."""
    raw_sorted, perm = torch.sort(ids, dim=1, stable=True)
    s_sorted = torch.gather(scores, 1, perm)
    dup = torch.zeros_like(raw_sorted, dtype=torch.bool)
    dup[:, 1:] = raw_sorted[:, 1:] == raw_sorted[:, :-1]
    s_sorted = torch.where(
        dup | (raw_sorted >= n_rows) | ~torch.isfinite(s_sorted),
        float("-inf"), s_sorted,
    )
    if timing.tracing():
        timing.count("dedup.kept", torch.isfinite(s_sorted).sum())
    s2, pos2 = topk_desc(s_sorted, top_k)
    ids_sorted = torch.clamp(raw_sorted, max=n_rows - 1)
    out_ids = torch.where(
        s2 > float("-inf"), torch.gather(ids_sorted, 1, pos2), -1
    )
    return s2, out_ids.to(torch.int32)


def lane_rows(
    pos: torch.Tensor,             # [q, m] flat lanes in [0, T * win)
    aligned_starts: torch.Tensor,  # [q, T] local CSR positions of lane 0
    packed_rows: torch.Tensor,     # [T, n_pad] int32 CSR-ordered row ids
    win: int,
) -> torch.Tensor:
    """Row ids of flat window lanes: table pos // win, CSR position
    aligned + pos % win, clamped to the slab."""
    n_pad = packed_rows.shape[1]
    pos = pos.long()
    l_of = torch.div(pos, win, rounding_mode="floor")
    gpos = l_of * n_pad + torch.clamp(
        torch.gather(aligned_starts.long(), 1, l_of) + pos % win, max=n_pad - 1
    )
    return packed_rows.reshape(-1)[gpos]


def lane_ids(scores, lanes, aligned_starts, packed_rows, win: int, kk: int, n_rows: int):
    """The lanes form's row ids, in plain torch: flat lanes (kk > 0: window
    t's lane j at t win + j), `lane_rows`, and the sentinel n_rows where
    the score is not above -inf."""
    if kk:
        q, m = lanes.shape
        T = m // kk
        l_base = torch.arange(T, device=lanes.device)[None, :, None] * win
        lanes = (l_base + lanes.reshape(q, T, kk)).reshape(q, T * kk)
    ids = lane_rows(lanes, aligned_starts, packed_rows, win)
    return torch.where(scores > float("-inf"), ids, n_rows)


def dedup_topk(
    scores: torch.Tensor,                    # [q, m] f32
    ids: torch.Tensor,                       # [q, m] row ids, or S1's lanes
    n_rows: int,
    top_k: int,
    aligned_starts: Optional[torch.Tensor] = None,   # [q, T]: the lanes form
    packed_rows: Optional[torch.Tensor] = None,      # [T, n_pad]
    win: int = 0,
    kk: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [q, min(top_k, m)] descending, row ids int32, -1 pad).

    CPU tensors take the plain version; CUDA tensors the Hopper kernel, one
    launch (none where q or min(top_k, m) is 0), bit for bit the plain
    version's answer; `check_dedup_topk` says what it takes."""
    if timing.tracing():
        timing.count("dedup.lanes", scores.numel())
    if not scores.is_cuda:
        if aligned_starts is not None:
            ids = lane_ids(scores, ids, aligned_starts, packed_rows, win, kk, n_rows)
        return dedup_topk_plain(scores, ids, n_rows, top_k)
    return _launch(scores, ids, n_rows, top_k, aligned_starts, packed_rows, win, kk)


dedup_topk.launches = 0


def check_dedup_topk(scores, ids, n_rows: int, top_k: int, aligned_starts=None,
                     packed_rows=None, win: int = 0, kk: int = 0) -> None:
    """Raise on what the card's kernel does not take, before any launch:
    scores other than float32 [q, m], ids or lanes of another shape or not
    int32 / int64, m past MAX_M, a negative top_k, n_rows outside [0,
    2^31), operands on more than one device; in the lanes form windows
    other than [q, T] starts and [T, n_pad] rows of integers, win < 1, a
    per-table kk that does not tile m (T kk != m, kk > win), or n_pad + win
    past 2^31."""
    if scores.dim() != 2 or tuple(ids.shape) != tuple(scores.shape):
        raise ValueError(f"dedup_topk takes [q, m] scores and ids of one shape; got "
                         f"{tuple(scores.shape)}, {tuple(ids.shape)}")
    if scores.dtype != torch.float32:
        raise TypeError(f"dedup_topk takes float32 scores, got {scores.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"dedup_topk takes int32 or int64 ids, got {ids.dtype}")
    q, m = scores.shape
    if m > MAX_M or q > _INT32_MAX:
        raise ValueError(f"dedup_topk takes m <= {MAX_M} candidates a row and q < 2^31; "
                         f"got [{q}, {m}]")
    if top_k < 0 or not 0 <= n_rows <= _INT32_MAX:
        raise ValueError(f"dedup_topk takes top_k >= 0 and 0 <= n_rows < 2^31; got "
                         f"top_k={top_k}, n_rows={n_rows}")
    devices = {scores.device, ids.device}
    if aligned_starts is not None:
        if aligned_starts.dim() != 2 or packed_rows is None or packed_rows.dim() != 2:
            raise ValueError("dedup_topk's lanes take [q, T] aligned starts and [T, n_pad] rows")
        T, n_pad = packed_rows.shape
        if tuple(aligned_starts.shape) != (q, T) or n_pad < 1:
            raise ValueError(f"dedup_topk: aligned starts {tuple(aligned_starts.shape)} "
                             f"against rows {tuple(packed_rows.shape)} and q = {q}")
        for t in (aligned_starts, packed_rows):
            if t.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"dedup_topk takes integer windows, got {t.dtype}")
        if win < 1 or kk < 0 or (kk and (T * kk != m or kk > win)):
            raise ValueError(f"dedup_topk: lanes of T={T} windows of win={win} with kk={kk} "
                             f"cannot make m={m}")
        if n_pad + win > _INT32_MAX:
            raise ValueError("dedup_topk adds a window's start and lane in int32")
        devices |= {aligned_starts.device, packed_rows.device}
    if len(devices) != 1:
        raise ValueError("dedup_topk's operands must live on one device")


def _launch(scores, ids, n_rows, top_k, aligned_starts, packed_rows, win, kk):
    check_dedup_topk(scores, ids, n_rows, top_k, aligned_starts, packed_rows, win, kk)
    s, i = scores.contiguous(), ids.contiguous()
    q, m = s.shape
    k = min(top_k, m)
    out_s = torch.empty(q, k, dtype=torch.float32, device=s.device)
    out_i = torch.empty(q, k, dtype=torch.int32, device=s.device)
    if q == 0 or k == 0:
        return out_s, out_i
    a = r = None
    T = n_pad = 0
    if aligned_starts is not None:
        a = aligned_starts.to(torch.int32).contiguous()
        r = packed_rows.to(torch.int32).contiguous()
        T, n_pad = r.shape
    kept = timing.device_total("dedup.kept", s.device)
    with torch.cuda.device(s.device):
        err = build.library().crt_dedup_topk(
            s.data_ptr(), i.data_ptr(), None if a is None else a.data_ptr(),
            None if r is None else r.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            None if kept is None else kept.data_ptr(), q, m, k, n_rows, i.element_size(),
            T, n_pad, win, kk, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "crt_dedup_topk")
    dedup_topk.launches += 1
    return out_s, out_i
