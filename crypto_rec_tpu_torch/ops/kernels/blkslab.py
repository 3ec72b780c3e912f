"""P5: slab-window dots over block-transposed slabs.

Replaces the TPU kernel `benchmarks/experiments/probe_r4_blk.py`
(`blk_window_dots`).  `to_blk` stores each table's slab as
[n_pad / 128, d, 128] blocks (block b, row k, lane j = element k of CSR
row 128 b + j), so a window of whole blocks stays contiguous.  Window
starts align down to 128 rows and the window is `blk_window_len` lanes
(nblk = win / 128 blocks); lane j of the output is the dot against CSR
row aligned + j, the row layout's lane order.

A CUDA tensor launches the tile-major Hopper kernel in
`csrc/probetile.cu` (or raises): one 128-row block (half a block at
d = 256) a tile, staged once as bf16 and dotted on the tensor cores
against every window that covers it, the query in three bf16 terms, the
schedule found on the device from the pairs sorted by first row; int8 and
bf16 slabs with d % 64 == 0 and d <= 256.  A CPU tensor runs
`blk_window_dots_plain`, a block gather and an f32 einsum over the block
rows, chunked over queries.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels.probetile import tile_dots, tile_queries
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _PLAIN_BYTES, _check_tile_slab, align_starts, probe_tile_rows,
)

B = 128          # CSR rows per block
_DTYPES = (torch.bfloat16, torch.int8)


def blk_window_len(per_table: int) -> int:
    return (per_table + B + 127) // 128 * 128


def to_blk(packed: torch.Tensor) -> torch.Tensor:
    """[L, n_pad, d] row slabs -> [L, n_pad / 128, d, 128] blocked slabs
    (probe_r4_blk.py:174-177)."""
    L, n_pad, d = packed.shape
    if n_pad % B:
        raise ValueError(f"to_blk needs n_pad % {B} == 0, got {n_pad}")
    return packed.reshape(L, n_pad // B, B, d).transpose(2, 3).contiguous()


def _geometry_blk(packed_blk, starts, per_table):
    """-> (win, aligned [q, L] local CSR rows, blk0 [q, L] absolute index
    of each window's first block in the flattened [L * n_pad / 128] axis)."""
    L, npb, _, b = packed_blk.shape
    if b != B or starts.shape[1] != L:
        raise ValueError(f"expected blocked slabs [L, npb, d, {B}] and starts [q, L], "
                         f"got {tuple(packed_blk.shape)} and {tuple(starts.shape)}")
    win = blk_window_len(per_table)
    if npb * B < win:
        raise ValueError(f"window {win} exceeds packed length {npb * B}")
    aligned = align_starts(starts, B, npb * B - win)
    l_off = torch.arange(L, dtype=torch.int32, device=starts.device) * npb
    return win, aligned, aligned // B + l_off[None, :]


def blk_window_dots_plain(
    packed_blk: torch.Tensor,   # [L, n_pad / 128, d, 128] int8 / bf16
    starts: torch.Tensor,       # [q, L] CSR-row window starts
    queries: torch.Tensor,      # [q, d] f32, pre-normalized
    per_table: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain P5: gather each window's blocks, f32 einsum over the d rows."""
    win, aligned, blk0 = _geometry_blk(packed_blk, starts, per_table)
    q, T = starts.shape
    d = packed_blk.shape[2]
    nblk = win // B
    flat = packed_blk.reshape(-1, d, B)
    qv = queries.float()
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed_blk.device)
    step = max(1, _PLAIN_BYTES // (T * win * d * 4))
    idx = torch.arange(nblk, device=packed_blk.device)
    for s in range(0, q, step):
        cand = flat[blk0[s:s + step].long()[:, :, None] + idx].float()   # [c, T, nblk, d, B]
        dots[s:s + step] = torch.einsum("qd,qtbdr->qtbr", qv[s:s + step],
                                        cand).reshape(-1, T, win)
    return dots, aligned


def _check_blk(name, packed_blk, starts, queries):
    if packed_blk.dtype not in _DTYPES:
        raise TypeError(f"{name} takes int8/bf16 slabs, got {packed_blk.dtype}")
    d = packed_blk.shape[2]
    if queries.shape != (starts.shape[0], d):
        raise ValueError(f"queries must be [q, {d}], got {tuple(queries.shape)}")
    if starts.device != packed_blk.device or queries.device != packed_blk.device:
        raise ValueError(f"{name}: slabs, starts and queries must share one CUDA device")
    if not packed_blk.is_contiguous() or packed_blk.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned slab")


def _cuda_blk(packed_blk, starts, queries, per_table):
    """Checks and geometry of the tensor-core body -> (aligned, row0 [q, L]
    absolute first CSR rows blk0 * 128, 16-byte aligned f32 queries, dots
    [q, L, win])."""
    _check_blk("blk_window_dots", packed_blk, starts, queries)
    _check_tile_slab(packed_blk)
    win, aligned, blk0 = _geometry_blk(packed_blk, starts, per_table)
    q, T = starts.shape
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed_blk.device)
    return aligned, blk0 * B, tile_queries(queries), dots


def blk_window_dots(
    packed_blk: torch.Tensor,
    starts: torch.Tensor,
    queries: torch.Tensor,
    per_table: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dots [q, L, win] f32, aligned CSR starts [q, L] int32, local to
    each table).  Arguments as the plain version.

    CPU tensors take the plain version; CUDA tensors (int8 or bf16 slabs,
    d % 64 == 0, d <= 256) the tile-major Hopper kernel; the sort of the
    pairs runs here on the device, inside the kernel's time."""
    if not packed_blk.is_cuda:
        return blk_window_dots_plain(packed_blk, starts, queries, per_table)
    aligned, row0, qv, dots = _cuda_blk(packed_blk, starts, queries, per_table)
    if starts.shape[0] == 0:
        return dots, aligned
    L, npb, d, _ = packed_blk.shape
    kind = "blk_int8" if packed_blk.dtype == torch.int8 else "blk_bf16"
    tile_dots("blk_window_dots", packed_blk, qv, row0, dots, d, L * npb * B, kind,
              probe_tile_rows(d))
    blk_window_dots.launches += 1
    return dots, aligned


blk_window_dots.launches = 0
