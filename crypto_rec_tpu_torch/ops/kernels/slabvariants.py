"""P2 / P4: the slab-window loop with the probes' other scoring bodies.

Replaces the TPU kernels `benchmarks/experiments/probe_r3_split.py`
(`run_variant`) and `benchmarks/experiments/probe_r3_final.py`
(`nomask_dots`).  Their "vpu" body is K1 with mask=False
(`slabscore.slab_window_dots`); `slab_window_variant` runs the others on
K1's window geometry (32-row aligned starts, win lanes, lane j = CSR row
aligned + j):

- ``load_floor`` (P2 "zeros"): every window byte is loaded, and the
  output is the first element of table 0's window, as f32, broadcast to
  [q, L, win].  A third output is the XOR of every window's 32-bit words
  per query, which the kernel folds to keep its loads live and the plain
  version reads every window byte to reproduce.
- ``rounded_query`` (P2 "mxu_rep" / "mxu_tile", bf16 slabs): dots against
  the query rounded to bf16, f32 products and sum.
- ``i8_dot`` (P4 "mxu_i8", int8 slabs): the int8 row against an int8
  query (`quantize_queries`), an exact integer sum written as f32.

A CUDA tensor launches a Hopper kernel (or raises), each mode the
tile-major kernels of `csrc/probetile.cu` (one tile of slab rows a block,
each covered row read once, the schedule found on the device from the
pairs sorted by first row):

- rounded_query: `rounded_query_dots`, the tile's bf16 rows dotted with
  mma.sync against one bf16 term of every query whose window covers them
  (bf16 slabs, d % 64 == 0, d <= 256);
- i8_dot: `i8_dots`, the tile's int8 rows as stored against the int8
  queries on the int8 tensor cores (m16n8k32, int32 sums: bit for bit the
  plain version; int8 slabs and queries, d % 64 == 0, d <= 256);
- load_floor: `load_floor`, no product: each covered row loaded once and
  folded, each window lane written once.  Its time is the floor of the
  tile-major family's loads and output writes (int8, bf16 and f32 slabs,
  d % 16 == 0, rows of <= 2048 B).

A CPU tensor runs `slab_window_variant_plain`.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.kernels.probetile import (
    BYTE_TILE_ROWS, tile_dots, tile_queries, tile_schedule,
)
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _DTYPE_CODE, _check_tile_slab, _geometry, check_row_slab, probe_tile_rows,
    slab_window_dots_plain, window_chunks,
)

MODES = ("load_floor", "rounded_query", "i8_dot")
# the probes' mode names; their "vpu" is K1 with mask=False
PROBE_MODES = {"zeros": "load_floor", "mxu_rep": "rounded_query",
               "mxu_tile": "rounded_query", "mxu_i8": "i8_dot"}


def quantize_queries(queries: torch.Tensor) -> torch.Tensor:
    """[q, d] f32 -> int8 with one scale per row, amax / 127
    (probe_r3_final.py:212-213)."""
    qsc = torch.amax(torch.abs(queries), dim=1, keepdim=True) / 127.0
    return torch.clamp(torch.round(queries / qsc), -127, 127).to(torch.int8)


def _check_mode(packed, queries, mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {sorted(MODES)}")
    if mode == "rounded_query" and packed.dtype != torch.bfloat16:
        raise TypeError(f"rounded_query takes bf16 slabs, got {packed.dtype}")
    if mode == "i8_dot" and (packed.dtype != torch.int8 or queries.dtype != torch.int8):
        raise TypeError(f"i8_dot takes int8 slabs and int8 queries, got "
                        f"{packed.dtype} and {queries.dtype}")


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of each row of an [m, n] int32 tensor, by halving."""
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        h = x.shape[1] // 2
        x = x[:, :h] ^ x[:, h:]
    return x[:, 0]


def slab_window_variant_plain(
    packed: torch.Tensor,    # [L, n_pad, d] CSR slabs
    starts: torch.Tensor,    # [q, L] window starts within a table
    queries: torch.Tensor,   # [q, d] f32 (int8 for i8_dot)
    per_table: int,
    mode: str,
):
    """Plain version of each mode; see the module docstring."""
    _check_mode(packed, queries, mode)
    if mode == "rounded_query":
        return slab_window_dots_plain(packed, starts, None,
                                      queries.to(torch.bfloat16).float(), per_table,
                                      mask=False)
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    if mode == "i8_dot":
        qi = queries.to(torch.int32)
        out = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
        for s, e, cand in window_chunks(packed, row0, win):
            out[s:e] = (cand.to(torch.int32) * qi[s:e, None, None, :]).sum(-1).float()
        return out, aligned
    first = packed.reshape(-1, packed.shape[2])[row0[:, 0].long(), 0].float()
    out = first[:, None, None].expand(q, T, win).contiguous()
    fold = torch.empty(q, dtype=torch.int32, device=packed.device)
    for s, e, cand in window_chunks(packed, row0, win, elem_bytes=packed.element_size()):
        fold[s:e] = _xor_fold(cand.contiguous().view(torch.int32).reshape(e - s, -1))
    return out, aligned, fold


def _cuda_rounded(packed, starts, queries, per_table):
    """Checks and geometry of the tensor-core rounded_query body ->
    (aligned, row0, 16-byte aligned f32 queries, dots [q, T, win])."""
    _check_mode(packed, queries, "rounded_query")
    check_row_slab("rounded_query_dots", packed, starts, queries, (torch.bfloat16,))
    _check_tile_slab(packed)
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
    return aligned, row0, tile_queries(queries), dots


def rounded_query_dots(
    packed: torch.Tensor,    # [L, n_pad, d] bf16 CSR slabs
    starts: torch.Tensor,    # [q, L] window starts within a table
    queries: torch.Tensor,   # [q, d] f32
    per_table: int,
):
    """`slab_window_variant`'s rounded_query -> (dots [q, L, win] f32,
    aligned starts [q, L] int32, local to each table).

    CPU tensors take the plain version; CUDA tensors (bf16 slabs, d % 64 ==
    0, d <= 256) the tile-major Hopper kernel; the sort of the pairs runs
    here on the device, inside the kernel's time."""
    if not packed.is_cuda:
        return slab_window_variant_plain(packed, starts, queries, per_table,
                                         "rounded_query")
    aligned, row0, qv, dots = _cuda_rounded(packed, starts, queries, per_table)
    if starts.shape[0] == 0:
        return dots, aligned
    d = packed.shape[2]
    tile_dots("rounded_query_dots", packed, qv, row0, dots, d,
              packed.shape[0] * packed.shape[1], "rounded_query", probe_tile_rows(d))
    rounded_query_dots.launches += 1
    return dots, aligned


rounded_query_dots.launches = 0


def _cuda_i8(packed, starts, queries, per_table):
    """Checks and geometry of the tensor-core i8_dot body -> (aligned, row0,
    16-byte aligned int8 queries, dots [q, T, win])."""
    _check_mode(packed, queries, "i8_dot")
    check_row_slab("i8_dots", packed, starts, queries, (torch.int8,))
    _check_tile_slab(packed)
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    dots = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
    return aligned, row0, tile_queries(queries, torch.int8), dots


def i8_dots(
    packed: torch.Tensor,    # [L, n_pad, d] int8 CSR slabs
    starts: torch.Tensor,    # [q, L] window starts within a table
    queries: torch.Tensor,   # [q, d] int8 (`quantize_queries`)
    per_table: int,
):
    """`slab_window_variant`'s i8_dot -> (dots [q, L, win] f32, aligned
    starts [q, L] int32, local to each table).

    CPU tensors take the plain version; CUDA tensors (int8 slabs and
    queries, d % 64 == 0, d <= 256) the tile-major Hopper kernel on the
    int8 tensor cores; the sort of the pairs runs here on the device,
    inside the kernel's time."""
    if not packed.is_cuda:
        return slab_window_variant_plain(packed, starts, queries, per_table, "i8_dot")
    aligned, row0, qv, dots = _cuda_i8(packed, starts, queries, per_table)
    if starts.shape[0] == 0:
        return dots, aligned
    tile_dots("i8_dots", packed, qv, row0, dots, packed.shape[2],
              packed.shape[0] * packed.shape[1], "i8_dot", BYTE_TILE_ROWS)
    i8_dots.launches += 1
    return dots, aligned


i8_dots.launches = 0


def _cuda_floor(packed, starts, queries, per_table):
    """Checks and geometry of the tile-major load_floor -> (win, aligned,
    row0, out [q, T, win] f32, fold [q] int32, zeroed by the kernel)."""
    _check_mode(packed, queries, "load_floor")
    check_row_slab("load_floor", packed, starts, queries, _DTYPE_CODE)
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    out = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
    return win, aligned, row0, out, torch.empty(q, dtype=torch.int32, device=packed.device)


def load_floor(
    packed: torch.Tensor,    # [L, n_pad, d] int8 / bf16 / f32 CSR slabs
    starts: torch.Tensor,    # [q, L] window starts within a table
    queries: torch.Tensor,   # [q, d] (not read)
    per_table: int,
):
    """`slab_window_variant`'s load_floor -> (out [q, L, win] f32, aligned
    starts [q, L] int32, local to each table, fold [q] int32).

    CPU tensors take the plain version; CUDA tensors (d % 16 == 0, rows of
    <= 2048 B) the tile-major Hopper kernel with no product; the sort of
    the pairs runs here on the device, inside the kernel's time."""
    if not packed.is_cuda:
        return slab_window_variant_plain(packed, starts, queries, per_table, "load_floor")
    win, aligned, row0, out, fold = _cuda_floor(packed, starts, queries, per_table)
    q, T = starts.shape
    L, n_pad, d = packed.shape
    with torch.cuda.device(packed.device):
        sr, order, bounds = tile_schedule(row0, L * n_pad, BYTE_TILE_ROWS)
        err = build.library().crt_tile_load_floor(
            packed.data_ptr(), sr.data_ptr(), order.data_ptr(), bounds.data_ptr(),
            row0.data_ptr(), out.data_ptr(), fold.data_ptr(), sr.numel(), q, T, win, d,
            L * n_pad, _DTYPE_CODE[packed.dtype], BYTE_TILE_ROWS,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "load_floor")
    load_floor.launches += 1
    return out, aligned, fold


load_floor.launches = 0


def slab_window_variant(
    packed: torch.Tensor,
    starts: torch.Tensor,
    queries: torch.Tensor,
    per_table: int,
    mode: str,
):
    """-> (out [q, L, win] f32, aligned window starts [q, L] int32, local
    to each table), and for load_floor a third output, the [q] int32 XOR
    fold.  Arguments as the plain version.

    CPU tensors take the plain version; CUDA tensors the tile-major Hopper
    kernel of the mode, each counted in its wrapper: `rounded_query_dots`,
    `i8_dots`, `load_floor`."""
    if not packed.is_cuda:
        return slab_window_variant_plain(packed, starts, queries, per_table, mode)
    _check_mode(packed, queries, mode)
    kernel = {"rounded_query": rounded_query_dots, "i8_dot": i8_dots,
              "load_floor": load_floor}[mode]
    return kernel(packed, starts, queries, per_table)
