"""The least time an NVIDIA H100 SXM could take for a piece of work.

A frozen copy of the port's bound arithmetic (its `ops/kernels/bounds.py`),
kept with the benchmark so that no change to the program can move a
roofline's denominator.  A call's bound is the larger of two times: the
unique bytes it must move (each input byte read once, each output byte
written once) over 3.35 TB/s, and its operations over the peak rate of the
unit it uses.  Slab rows are counted once over the UNION of a call's
windows, in 32-row blocks from the windows' first rows.

Peaks (NVIDIA's data sheet, SXM part, dense, at the full 700 W): bf16
tensor cores 989 TFLOP/s (K1 on int8 and bf16 slabs), f32 FFMA 67 TFLOP/s
(K2, whose hash parity rules out TF32).  S1 does no arithmetic on a unit
with a published peak: bound by its bytes.

Every function takes shapes and windows only (never the program's state).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_TC = "bf16 tensor cores"
F32_FFMA = "f32 FFMA"
PEAK_FLOPS = {BF16_TC: 989e12, F32_FFMA: 67e12}
BLOCK_ROWS = 32


def covered_rows(row0: torch.Tensor, win: int, n_rows: int,
                 block: int = BLOCK_ROWS) -> int:
    """Slab rows in the 32-row blocks that some window [row0, row0 + win)
    meets, the last block cut at n_rows.  row0: absolute first rows in a
    flat slab of n_rows rows (any shape)."""
    r0 = row0.reshape(-1).long()
    if r0.numel() == 0:
        return 0
    n_blocks = -(-n_rows // block)
    first = torch.div(r0, block, rounding_mode="floor")
    last = torch.div(r0 + win - 1, block, rounding_mode="floor")
    edge = torch.zeros(n_blocks + 1, dtype=torch.int64, device=r0.device)
    edge.index_add_(0, first, torch.ones_like(first))
    edge.index_add_(0, last + 1, -torch.ones_like(last))
    hit = torch.cumsum(edge[:-1], 0) > 0
    rows = torch.full((n_blocks,), block, dtype=torch.int64, device=r0.device)
    rows[-1] = n_rows - (n_blocks - 1) * block
    return int(rows[hit].sum())


def bound(nbytes: float, flops: float, peak) -> dict:
    """-> {seconds, bound_by ("bytes" or "operations"), bytes, flops};
    peak None: work with no arithmetic (flops 0)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak] if peak is not None else 0.0
    return dict(seconds=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=float(nbytes), flops=float(flops))


def k1_call(row0: torch.Tensor, win: int, n_rows: int, d: int, slab_bytes: int) -> dict:
    """K1 (`slab_window_dots`) on P = row0.numel() windows of `win` lanes:
    the covered slab rows read once, f32 queries [q, d] read once (q =
    row0.shape[0]), dots [q, T, win] f32 and aligned starts [q, T] int32
    written; 2 d operations a lane on the bf16 tensor cores."""
    q, T = row0.shape
    nbytes = (covered_rows(row0, win, n_rows) * d * slab_bytes + 4.0 * q * d
              + q * T * (4.0 * win + 4.0))
    return bound(nbytes, 2.0 * q * T * win * d, BF16_TC)


def k2_call(n: int, d: int, k: int, L: int) -> dict:
    """K2 (`signproj_bucket_ids`): x [n, d] f32 and proj [d, L k] read, ids
    [n, L] int32 written; 2 n d L k operations of f32 FFMA."""
    return bound(4.0 * (n * d + d * L * k + n * L), 2.0 * n * d * L * k, F32_FFMA)


def s1_call(R: int, m: int, k: int) -> dict:
    """S1 (`window_topk`): values [R, m] f32 read once, [R, k] f32 values
    and int64 indices written; bound by its bytes."""
    return bound(4.0 * R * m + 12.0 * R * k, 0.0, None)


def retrieve_call(row0: torch.Tensor, win: int, n_rows: int, d: int, slab_bytes: int,
                  top_k: int) -> dict:
    """The least work of one retrieval request, whatever kernels do it: the
    slab rows covered by the union of its windows read once, the f32
    queries read once, the top-k (f32 score and int32 id) written once, and
    2 d operations a window lane on the bf16 tensor cores."""
    q, T = row0.shape
    nbytes = (covered_rows(row0, win, n_rows) * d * slab_bytes + 4.0 * q * d
              + 8.0 * q * top_k)
    return bound(nbytes, 2.0 * q * T * win * d, BF16_TC)
