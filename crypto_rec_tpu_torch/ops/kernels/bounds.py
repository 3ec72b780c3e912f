"""The least time an NVIDIA H100 SXM could take for a kernel call.

A call's bound is the larger of two times: the unique bytes it must move
(each input byte read once, each output byte written once) over the card's
3.35 TB/s, and its operations over the peak rate of the unit it uses.  For
the slab kernels the unique slab bytes are the rows covered by the UNION of
the call's windows, counted on the device in 32-row blocks from the windows'
first rows: a row that many windows share counts once.

Peaks (NVIDIA's data sheet, dense, at the full 700 W): bf16 tensor cores
989 TFLOP/s (K1 on int8 and bf16 slabs, and the probe kernels P1-P3, P5,
P6 and P2's rounded_query), int8 tensor cores 1,979 TOP/s (P4's i8_dot,
int8 x int8 -> int32), f32 FFMA 67 TFLOP/s (K2, whose hash parity rules out
TF32; K1 on f32 slabs, which are not exact in bf16 and take FFMA; K1's
other rows show it as the floor of a design without tensor cores).  P2's
load_floor does no arithmetic: 0 operations, bound by its bytes alone, as
is S1, the stage-1 selection (`s1_call`), and D1, the dedup top-k
(`dedup_call`).  The CF prediction
(`cf_predict_call`) runs f32 FFMA at well under an operation a byte: bound
by its bytes.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
BF16_TC = "bf16 tensor cores"
INT8_TC = "int8 tensor cores"
F32_FFMA = "f32 FFMA"
PEAK_FLOPS = {BF16_TC: 989e12, INT8_TC: 1979e12, F32_FFMA: 67e12}
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


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes: float, flops: float, peak) -> dict:
    """-> {bound_ms, bound_by ("bytes" or "operations"), peak, bytes, flops};
    peak None: a call with no arithmetic (flops 0)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[peak] if peak is not None else 0.0
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                peak=peak, bytes=int(nbytes), flops=float(flops))


def window_call(row0: torch.Tensor, win: int, n_rows: int, row_bytes: float,
                d: int, inputs=(), outputs=(), peak=BF16_TC) -> dict:
    """Bound of a slab-window kernel call: the covered slab rows x
    row_bytes plus `inputs` (queries, ...) and `outputs` (dots, starts, ...)
    read or written once; 2 d operations for every window lane on `peak`'s
    unit (None: no arithmetic)."""
    nbytes = (covered_rows(row0, win, n_rows) * row_bytes + tensor_bytes(*inputs)
              + tensor_bytes(*outputs))
    return bound(nbytes, 2.0 * row0.numel() * win * d if peak is not None else 0.0, peak)


# the unit each `slab_window_variant` mode's operations run on
VARIANT_PEAK = {"load_floor": None, "rounded_query": BF16_TC, "i8_dot": INT8_TC}


def variant_call(packed: torch.Tensor, starts, queries, per_table: int, mode: str,
                 outputs=()) -> dict:
    """P2 / P4's bound for one `slab_window_variant` call on K1's windows:
    the covered slab rows, the queries as the mode reads them (rounded_query
    f32, i8_dot int8; load_floor reads none) and `outputs` (its results);
    operations on `VARIANT_PEAK[mode]`."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _geometry

    win, _, row0, _, _ = _geometry(packed, starts, None, per_table, False)
    d = packed.shape[2]
    return window_call(row0, win, packed.shape[0] * packed.shape[1],
                       d * packed.element_size(), d,
                       inputs=() if mode == "load_floor" else (queries,),
                       outputs=outputs, peak=VARIANT_PEAK[mode])


def k1_call(packed: torch.Tensor, starts, sizes, queries, per_table: int,
            shared_slab: bool = False, packed_scale=None) -> dict:
    """K1's bound for one `slab_window_dots` call (dots [q, T, win] f32 and
    aligned starts [q, T] int32 written): on bf16 tensor cores for int8 and
    bf16 slabs, on f32 FFMA for f32 slabs; the f32 FFMA bound also stands
    beside it as `ffma_bound_ms`.  With a per-row packed_scale each covered
    row also reads its 4-byte f32 scale."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _geometry

    win, aligned, row0, _, _ = _geometry(packed, starts, sizes, per_table, shared_slab)
    d = packed.shape[2]
    n_rows = packed.shape[0] * packed.shape[1]
    q, T = starts.shape
    out_bytes = q * T * (win * 4 + 4)
    row_bytes = d * packed.element_size() + (4 if packed_scale is not None else 0)
    nbytes = (covered_rows(row0, win, n_rows) * row_bytes
              + tensor_bytes(queries.float()) + out_bytes)
    flops = 2.0 * q * T * win * d
    res = bound(nbytes, flops, F32_FFMA if packed.dtype == torch.float32 else BF16_TC)
    res["ffma_bound_ms"] = bound(nbytes, flops, F32_FFMA)["bound_ms"]
    return res


def k2_call(n: int, d: int, k: int, L: int) -> dict:
    """K2's bound: x [n, d] f32 and proj [d, L k] read, ids [n, L] int32
    written; 2 n d L k FLOP of f32 FFMA."""
    nbytes = 4 * (n * d + d * L * k + n * L)
    return bound(nbytes, 2.0 * n * d * L * k, F32_FFMA)


def s1_call(R: int, m: int, k: int) -> dict:
    """S1's bound (`window_topk`): values [R, m] f32 read once, [R, k] f32
    values and int64 indices written.  Its comparisons run on no unit with
    a published peak: bound by its bytes."""
    return bound(4.0 * R * m + 12.0 * R * k, 0.0, None)


def cf_predict_call(q: int, P: int, c: int, n: int, id_bytes: int = 8) -> dict:
    """The CF prediction's bound (`cf_predict`): the query ratings [q, c]
    f32 and known [q, c] bool, the means [q] and [n] f32, the neighbour
    table [n, c] f32, sims [q, P] f32, ids [q, P] and valid [q, P] bool read
    once, the prediction [q, c] f32 written once; 2 q P c FLOP of f32 FFMA
    (the gathered rows are re-reads of the table)."""
    nbytes = q * c * (4 + 1 + 4) + 4 * q + n * c * 4 + 4 * n + q * P * (4 + id_bytes + 1)
    return bound(nbytes, 2.0 * q * P * c, F32_FFMA)


def dedup_call(q: int, m: int, k: int, id_bytes: int = 8, T: int = 0) -> dict:
    """D1's bound (`dedup_topk`): scores [q, m] f32 and ids or lanes [q, m]
    of id_bytes read once; in the lanes form (T windows a row) also the
    aligned starts [q, T] int32 and each lane's 4-byte row id, gathered from
    the windows' rows; scores [q, min(k, m)] f32 and ids int32 written
    once.  Its comparisons run on no unit with a published peak: bound by
    its bytes."""
    nbytes = q * m * (4 + id_bytes) + q * min(k, m) * 8
    if T:
        nbytes += q * T * 4 + q * m * 4
    return bound(nbytes, 0.0, None)
