"""P6: slab-window dots over nibble-packed int4 slabs, and their top-k.

Replaces the TPU kernel `benchmarks/experiments/probe_r5_int4.py`
(`slab_window_dots_int4`).  `repack_int4` requantizes global-scale int8
slabs to 4 bits (round(x * 7 / 127), clipped to +-7) and packs two
ADJACENT CSR rows per byte: hi nibble = even row, lo nibble = odd row, so
a window of W CSR rows is W / 2 packed rows of d bytes.  Window starts
align down to `ALIGN4` = 64 CSR rows and the window is `window_len4`
lanes.  The dots come out in the TPU kernel's "halves" layout: lane
j < win / 2 scores CSR row aligned + 2j, lane j >= win / 2 scores row
aligned + 2 (j - win / 2) + 1; `slab_topk_int4` maps lanes back so.

A CUDA tensor launches the tile-major Hopper kernel in
`csrc/probetile.cu` (or raises): each tile of packed rows read and
unpacked once into bf16, dotted on the tensor cores against every window
that covers it, with the schedule (in packed rows) found on the device
from the pairs sorted by first row; it takes d % 64 == 0, d <= 256.  A CPU
tensor runs `slab_window_dots_int4_plain`, a gather, the nibble unpack and
two f32 einsums chunked over queries.  Stage 1 of `slab_topk_int4` is
the exact per-window `window_topk` (S1 on the card, equal dots lowest lane
first) where the TPU ran `approx_max_k`, as in K1's epilogue.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels.probetile import tile_dots, tile_queries
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _check_tile_slab, _dedup_topk_pairs, align_starts, check_row_slab, probe_tile_rows,
    window_chunks,
)
from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk

ALIGN4 = 64     # CSR-row alignment of int4 windows (32 packed rows)


def window_len4(per_table: int) -> int:
    return (per_table + ALIGN4 + 127) // 128 * 128


def repack_int4(p8: torch.Tensor) -> torch.Tensor:
    """[L, n_pad, d] int8 global-scale slabs -> [L, n_pad / 2, d] uint8
    nibble pairs (probe_r5_int4.py:194-204), one table at a time, which
    bounds the f32 temporary to one table."""
    L, n_pad, d = p8.shape
    if p8.dtype != torch.int8 or n_pad % 2:
        raise ValueError(f"repack_int4 takes int8 slabs of even length, got "
                         f"{p8.dtype} {tuple(p8.shape)}")
    out = torch.empty(L, n_pad // 2, d, dtype=torch.uint8, device=p8.device)
    for l in range(L):
        v4 = torch.clamp(torch.round(p8[l].float() * (7.0 / 127.0)), -7, 7).to(torch.int32)
        out[l] = (((v4[0::2] & 0xF) << 4) | (v4[1::2] & 0xF)).to(torch.uint8)
    return out


def _geometry4(packed4, starts, per_table):
    """-> (win, aligned [q, L] local CSR rows, row0 [q, L] absolute packed
    rows of each window's first byte row)."""
    L, n_pad2, _ = packed4.shape
    if starts.shape[1] != L:
        raise ValueError(f"starts must be [q, {L}], got {tuple(starts.shape)}")
    win = window_len4(per_table)
    if 2 * n_pad2 < win:
        raise ValueError(f"window {win} exceeds packed length {2 * n_pad2}")
    aligned = align_starts(starts, ALIGN4, 2 * n_pad2 - win)
    l_off = torch.arange(L, dtype=torch.int32, device=starts.device) * n_pad2
    return win, aligned, aligned // 2 + l_off[None, :]


def slab_window_dots_int4_plain(
    packed4: torch.Tensor,   # [L, n_pad / 2, d] uint8 nibble pairs
    starts: torch.Tensor,    # [q, L] CSR-row window starts
    queries: torch.Tensor,   # [q, d] f32, pre-normalized
    per_table: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain P6: gather the win / 2 packed rows, unpack both nibbles as
    ((v ^ 8) - 8), two f32 einsums into the halves layout."""
    win, aligned, row0 = _geometry4(packed4, starts, per_table)
    q, T = starts.shape
    win2 = win // 2
    qv = queries.float()
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed4.device)
    for s, e, cand in window_chunks(packed4, row0, win2, elem_bytes=8):
        x = cand.to(torch.int32)
        for half, v in ((slice(0, win2), x >> 4), (slice(win2, win), x & 15)):
            dots[s:e, :, half] = torch.einsum("qd,qtwd->qtw", qv[s:e],
                                              ((v ^ 8) - 8).float())
    return dots, aligned


def _cuda_int4(name, packed4, starts, queries, per_table):
    check_row_slab(name, packed4, starts, queries, (torch.uint8,))
    win, aligned, row0 = _geometry4(packed4, starts, per_table)
    q, T = starts.shape
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed4.device)
    return win, aligned, row0.contiguous(), tile_queries(queries), dots


def slab_window_dots_int4(
    packed4: torch.Tensor,
    starts: torch.Tensor,
    queries: torch.Tensor,
    per_table: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dots [q, L, win] f32 in the halves layout, aligned CSR starts
    [q, L] int32, local to each table).  Arguments as the plain version.

    CPU tensors take the plain version; CUDA tensors (d % 64 == 0, d <=
    256) the tile-major Hopper kernel; the sort of the pairs runs here on
    the device, inside the kernel's time."""
    if not packed4.is_cuda:
        return slab_window_dots_int4_plain(packed4, starts, queries, per_table)
    _check_tile_slab(packed4)
    win, aligned, row0, qv, dots = _cuda_int4("slab_window_dots_int4", packed4, starts,
                                             queries, per_table)
    if starts.shape[0] == 0:
        return dots, aligned
    d = packed4.shape[2]
    # packed rows: two bf16 rows each
    tile_dots("slab_window_dots_int4", packed4, qv, row0, dots, d,
              packed4.shape[0] * packed4.shape[1], "int4", probe_tile_rows(d) // 2)
    slab_window_dots_int4.launches += 1
    return dots, aligned


slab_window_dots_int4.launches = 0


def slab_topk_int4(
    dots: torch.Tensor,          # [q, L, win] halves layout
    aligned: torch.Tensor,       # [q, L] local CSR starts
    packed_rows: torch.Tensor,   # [L, n_pad] int32 CSR-ordered row ids
    n_rows: int,
    top_k: int,
    kk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-window stage 1 (top kk lanes, exact) + dedup, with the halves
    lane mapping (probe_r5_int4.py:159-176).

    -> (scores [q, top_k] descending, row ids [q, top_k] int32, -1 pad)."""
    q, L, win = dots.shape
    win2 = win // 2
    n_pad = packed_rows.shape[1]
    kk = min(kk or top_k, win)
    s1, lane = window_topk(dots.reshape(q * L, win), kk)
    s1 = s1.reshape(q, L * kk)
    lane = lane.reshape(q, L, kk)
    off = torch.where(lane < win2, 2 * lane, 2 * (lane - win2) + 1)
    gpos = (torch.arange(L, device=dots.device)[None, :, None] * n_pad
            + torch.clamp(aligned.long()[:, :, None] + off, max=n_pad - 1))
    ids1 = packed_rows.reshape(-1)[gpos.reshape(q, L * kk)]
    ids1 = torch.where(s1 > float("-inf"), ids1, n_rows)
    return _dedup_topk_pairs(s1, ids1, n_rows, top_k)
