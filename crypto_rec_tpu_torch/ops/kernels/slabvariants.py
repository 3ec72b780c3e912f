"""P2 / P4: the slab-window loop with the probes' other scoring bodies.

Replaces the TPU kernels `benchmarks/experiments/probe_r3_split.py`
(`run_variant`) and `benchmarks/experiments/probe_r3_final.py`
(`nomask_dots`).  Their "vpu" body is K1 with mask=False
(`slabscore.slab_window_dots`); `slab_window_variant` runs the others on
K1's window geometry (32-row aligned starts, win lanes, lane j = CSR row
aligned + j):

- ``load_floor`` (P2 "zeros"): every window byte is loaded, and the
  output is the first element of table 0's window, as f32, broadcast to
  [q, L, win].  The time bounds K1's loop from below: the same window
  loads and [q, L, win] output writes, no arithmetic.  A third output is
  the XOR of every window's 32-bit words per query, which the kernel
  folds to keep its loads live and the plain version reads every window
  byte to reproduce.
- ``rounded_query`` (P2 "mxu_rep" / "mxu_tile", bf16 slabs): dots against
  the query rounded to bf16, f32 products and sum.
- ``i8_dot`` (P4 "mxu_i8", int8 slabs): the int8 row against an int8
  query (`quantize_queries`), an exact integer sum written as f32.

A CUDA tensor launches the Hopper kernel in `csrc/slabvariants.cu` (or
raises); a CPU tensor runs `slab_window_variant_plain`.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _DTYPE_CODE, _geometry, check_row_slab, slab_window_dots_plain, window_chunks,
)

MODES = {"load_floor": 0, "rounded_query": 1, "i8_dot": 2}
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

    CPU tensors take the plain version; CUDA tensors the Hopper kernel."""
    if not packed.is_cuda:
        return slab_window_variant_plain(packed, starts, queries, per_table, mode)
    _check_mode(packed, queries, mode)
    check_row_slab("slab_window_variant", packed, starts, queries, _DTYPE_CODE)
    win, aligned, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    q, T = starts.shape
    qv = (queries if mode == "i8_dot" else queries.float()).contiguous()
    if qv.data_ptr() % 16:
        raise ValueError("slab_window_variant needs 16-byte aligned queries")
    row0 = row0.contiguous()
    out = torch.empty(q, T, win, dtype=torch.float32, device=packed.device)
    fold = torch.zeros(q, dtype=torch.int32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = build.library().crt_slab_window_variant(
            packed.data_ptr(), qv.data_ptr(), row0.data_ptr(), out.data_ptr(),
            fold.data_ptr(), q, T, win, packed.shape[2], MODES[mode],
            _DTYPE_CODE[packed.dtype], torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "slab_window_variant")
    slab_window_variant.launches += 1
    return (out, aligned, fold) if mode == "load_floor" else (out, aligned)


slab_window_variant.launches = 0
