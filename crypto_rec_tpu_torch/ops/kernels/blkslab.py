"""P5: slab-window dots over block-transposed slabs.

Replaces the TPU kernel `benchmarks/experiments/probe_r4_blk.py`
(`blk_window_dots`).  `to_blk` stores each table's slab as
[n_pad / 128, d, 128] blocks (block b, row k, lane j = element k of CSR
row 128 b + j), so a window of whole blocks stays contiguous.  Window
starts align down to 128 rows and the window is `blk_window_len` lanes
(nblk = win / 128 blocks); lane j of the output is the dot against CSR
row aligned + j, the row layout's lane order.

A CUDA tensor launches the Hopper kernel in `csrc/blkslab.cu` (or
raises); a CPU tensor runs `blk_window_dots_plain`, a block gather and an
f32 einsum over the block rows, chunked over queries.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.kernels.slabscore import _PLAIN_BYTES, align_starts

B = 128          # CSR rows per block
_DTYPE_CODE = {torch.bfloat16: 1, torch.int8: 2}
_MAX_THREADS = 1024


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


def blk_window_dots(
    packed_blk: torch.Tensor,
    starts: torch.Tensor,
    queries: torch.Tensor,
    per_table: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (dots [q, L, win] f32, aligned CSR starts [q, L] int32, local to
    each table).  Arguments as the plain version.

    CPU tensors take the plain version; CUDA tensors the Hopper kernel."""
    if not packed_blk.is_cuda:
        return blk_window_dots_plain(packed_blk, starts, queries, per_table)
    if packed_blk.dtype not in _DTYPE_CODE:
        raise TypeError(f"blk_window_dots takes int8/bf16 slabs, got {packed_blk.dtype}")
    d = packed_blk.shape[2]
    if queries.shape != (starts.shape[0], d):
        raise ValueError(f"queries must be [q, {d}], got {tuple(queries.shape)}")
    if starts.device != packed_blk.device or queries.device != packed_blk.device:
        raise ValueError("blk_window_dots: slabs, starts and queries must share one "
                         "CUDA device")
    if not packed_blk.is_contiguous() or packed_blk.data_ptr() % 16:
        raise ValueError("blk_window_dots needs a contiguous, 16-byte aligned slab")
    win, aligned, blk0 = _geometry_blk(packed_blk, starts, per_table)
    nblk = win // B
    threads = nblk * B // (4 // packed_blk.element_size())
    if threads > _MAX_THREADS:
        raise ValueError(f"a {win}-lane window needs {threads} threads a block, over "
                         f"the kernel's {_MAX_THREADS}")
    q, T = starts.shape
    qv = queries.float().contiguous()
    blk0 = blk0.contiguous()
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed_blk.device)
    with torch.cuda.device(packed_blk.device):
        err = build.library().crt_blk_window_dots(
            packed_blk.data_ptr(), qv.data_ptr(), blk0.data_ptr(), dots.data_ptr(),
            q, T, nblk, d, _DTYPE_CODE[packed_blk.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "blk_window_dots")
    blk_window_dots.launches += 1
    return dots, aligned


blk_window_dots.launches = 0
