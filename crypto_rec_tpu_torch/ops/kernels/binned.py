"""P3: slab-window dots reduced to strided bin winners, and their retrieval.

Replaces the TPU kernel `benchmarks/experiments/probe_r3_binned.py`
(`binned_dots`).  For each query, K1's maskless dots over the flat
[T * win] lanes of its T table windows (flat lane p = t * win + lane) are
cut into `nbins` strided bins (bin = p % nbins); only each bin's largest
dot and the flat lane of the lowest row reaching it leave the kernel, so
the [q, T, win] dots and the stage-1 top-k over them never exist.
Contiguous CSR lanes fall in distinct bins, so a planted same-bucket run
survives; copies of one row from two tables may share a bin, which dedup
would have dropped anyway.

A CUDA tensor launches the tile-major Hopper kernel in `csrc/probetile.cu`
(or raises): K1's tensor-core product over tiles of the slab, each covered
slab row read once, with the schedule found on the device from the pairs
sorted by first row, and each tile's candidates combined into the query's
bins with one 64-bit atomicMax on a key that orders by dot, then by the
lowest row.  It takes int8 and bf16 slabs with d % 64 == 0 and d <= 256.
A CPU tensor runs `binned_dots_plain`, the bin-max of K1's plain dots
(any slab dtype, as the TPU probe casts to f32).  `retrieve_binned` is
plain torch: window offsets, binned dots, each bin's flat lane mapped back
to its table and CSR row, then the dedup top-k.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.kernels.deduptopk import lane_rows
from crypto_rec_tpu_torch.ops.kernels.probetile import tile_queries, tile_schedule
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _DTYPE_CODE, _check_tile_slab, _dedup_topk_pairs, _geometry, _window_offsets,
    check_row_slab, probe_tile_rows, slab_window_dots_plain, window_len,
)

_TC_CODE = {t: _DTYPE_CODE[t] for t in (torch.int8, torch.bfloat16)}


def _check_bins(T: int, win: int, nbins: int) -> None:
    if nbins <= 0 or (T * win) % nbins:
        raise ValueError(f"nbins={nbins} must divide the {T} x {win} window lanes")


def binned_dots_plain(
    packed: torch.Tensor,    # [L, n_pad, d] int8 / bf16 / f32 CSR slabs
    starts: torch.Tensor,    # [q, L] window starts within a table
    queries: torch.Tensor,   # [q, d] f32, pre-normalized
    per_table: int,
    nbins: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain P3: bin-max of K1's maskless plain dots, lowest row on ties."""
    dots, aligned = slab_window_dots_plain(packed, starts, None, queries, per_table,
                                           mask=False)
    q, T, win = dots.shape
    _check_bins(T, win, nbins)
    b = dots.reshape(q, T * win // nbins, nbins)                 # [q, rows, nbins]
    vals = b.amax(dim=1)
    rows = b.shape[1]
    ridx = torch.arange(rows, device=dots.device)[None, :, None]
    r_win = torch.where(b == vals[:, None, :], ridx, rows).amin(dim=1)
    pos = r_win * nbins + torch.arange(nbins, device=dots.device)[None, :]
    return vals, pos.to(torch.int32), aligned


def _cuda_binned(packed, starts, queries, per_table, nbins):
    """Checks and geometry of the tensor-core body -> (win, aligned, row0,
    16-byte aligned f32 queries, keys / vals / pos outputs)."""
    check_row_slab("binned_dots", packed, starts, queries, _TC_CODE)
    _check_tile_slab(packed)
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    _check_bins(T, win, nbins)
    dev = packed.device
    outs = (torch.empty(q, nbins, dtype=torch.int64, device=dev),
            torch.empty(q, nbins, dtype=torch.float32, device=dev),
            torch.empty(q, nbins, dtype=torch.int32, device=dev))
    return win, aligned, row0.contiguous(), tile_queries(queries), outs


def binned_dots(
    packed: torch.Tensor,
    starts: torch.Tensor,
    queries: torch.Tensor,
    per_table: int,
    nbins: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (vals [q, nbins] f32 bin maxima, pos [q, nbins] int32 flat lane
    in [0, L * win) of each bin's winner, aligned window starts [q, L]
    int32, local to each table).  Arguments as `binned_dots_plain`.

    CPU tensors take the plain version; CUDA tensors (int8 or bf16 slabs,
    d % 64 == 0, d <= 256) the tile-major Hopper kernel; the sort of the
    pairs runs here on the device, inside the kernel's time."""
    if not packed.is_cuda:
        return binned_dots_plain(packed, starts, queries, per_table, nbins)
    win, aligned, row0, qv, (keys, vals, pos) = _cuda_binned(
        packed, starts, queries, per_table, nbins)
    q, T = starts.shape
    d = packed.shape[2]
    if q == 0:
        return vals, pos, aligned
    rt = probe_tile_rows(d)
    n_rows = packed.shape[0] * packed.shape[1]
    with torch.cuda.device(packed.device):
        sr, order, bounds = tile_schedule(row0, n_rows, rt)
        err = build.library().crt_binned_tile_dots(
            packed.data_ptr(), qv.data_ptr(), sr.data_ptr(), order.data_ptr(),
            bounds.data_ptr(), keys.data_ptr(), vals.data_ptr(), pos.data_ptr(),
            sr.numel(), q, T, win, d, n_rows, nbins, _TC_CODE[packed.dtype], rt,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "binned_dots")
    binned_dots.launches += 1
    return vals, pos, aligned


binned_dots.launches = 0


def binned_topk(
    vals: torch.Tensor,            # [q, nbins] from binned_dots
    pos: torch.Tensor,             # [q, nbins] flat lanes
    aligned_starts: torch.Tensor,  # [q, L]
    packed_rows: torch.Tensor,     # [L, n_pad] int32 CSR-ordered row ids
    win: int,
    n_rows: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bin winners -> dedup top-k: each flat lane's row id (`lane_rows`),
    then the stable id sort-dedup of `_dedup_topk_pairs`
    (probe_r3_binned.py:136-151; its vals are finite, so the extra
    finite-score mask changes nothing).

    -> (scores [q, top_k] descending, row ids [q, top_k] int32, -1 pad)."""
    return _dedup_topk_pairs(vals, lane_rows(pos, aligned_starts, packed_rows, win),
                             n_rows, top_k)


def retrieve_binned(
    packed: torch.Tensor,         # [L, n_pad, d] CSR-ordered slabs
    packed_rows: torch.Tensor,    # [L, n_pad] int32, sentinel n past the end
    bucket_starts: torch.Tensor,  # [L, n_buckets + 1]
    n_rows: int,
    queries: torch.Tensor,        # [q, d] f32, pre-normalized
    q_buckets: torch.Tensor,      # [q, L]
    per_table: int,
    top_k: int,
    nbins: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe's binned retrieval (probe_r3_binned.py:122-151): the
    golden-ratio window offsets, binned dots, `binned_topk`."""
    s0, _ = _window_offsets(bucket_starts, q_buckets, per_table)
    vals, pos, a0 = binned_dots(packed, s0, queries, per_table, nbins)
    return binned_topk(vals, pos, a0, packed_rows, window_len(per_table), n_rows,
                       top_k)
