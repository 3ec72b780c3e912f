"""The launch shared by the tile-major probe kernels (`csrc/probetile.cu`).

P2's rounded_query and load_floor (`slabvariants.rounded_query_dots`,
`slabvariants.load_floor`), P3 (`binned.binned_dots`), P4
(`slabvariants.i8_dots`), P5 (`blkslab.blk_window_dots`) and P6
(`int4slab.slab_window_dots_int4`) take one tile of slab rows a block and
find their schedule on the device: `tile_schedule` sorts the (query,
table) pairs by first slab row and allocates the [2, n_tiles] bounds that
the kernel's `tile_bounds` fills with each tile's range of sorted pairs;
`tile_dots` launches the kinds that write dots [q, T, win] (P2, P4, P5,
P6).  Nothing here runs on the CPU: the wrappers take their plain versions
there.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.kernels import build

# csrc/probetile.cu `Kind` codes of the dots-writing kinds
KINDS = {"int4": 2, "rounded_query": 3, "blk_int8": 4, "blk_bf16": 5, "i8_dot": 6}
# slab rows a tile of the kernels that stage no bf16 rows: P4's int8 rows
# as stored (8-32 KB at d = 64-256) and load_floor, which stages none
BYTE_TILE_ROWS = 128


def tile_queries(queries: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[q, d] queries as the kernels read them: contiguous `dtype` (P4:
    int8) on 16 bytes, copied only where they are not."""
    qv = queries.to(dtype).contiguous()
    return qv.clone() if qv.data_ptr() % 16 else qv


def tile_schedule(row0: torch.Tensor, n_rows: int, rt: int):
    """-> (sorted first rows [P] int32, pair ids [P] int64 in that order,
    bounds [2, ceil(n_rows / rt)] int32, for the kernel to fill).
    row0: the pairs' absolute first rows, any shape, pair id = flat index."""
    sr, order = torch.sort(row0.reshape(-1))
    return sr, order, torch.empty(2, -(-n_rows // rt), dtype=torch.int32,
                                  device=row0.device)


def tile_dots(name: str, slab: torch.Tensor, queries: torch.Tensor, row0: torch.Tensor,
              dots: torch.Tensor, d: int, n_rows: int, kind: str, rt: int) -> None:
    """Launch `kind` on a contiguous slab of n_rows rows (P6: packed rows)
    in tiles of rt, `tile_queries` [q, d] (P4: int8) and row0 [q, T]
    int32; writes dots [q, T, win].  The sort runs here, on the device,
    inside the kernel's time."""
    with torch.cuda.device(slab.device):
        sr, order, bounds = tile_schedule(row0, n_rows, rt)
        err = build.library().crt_tile_dots(
            slab.data_ptr(), queries.data_ptr(), sr.data_ptr(), order.data_ptr(),
            bounds.data_ptr(), dots.data_ptr(), sr.numel(), dots.shape[1], dots.shape[2],
            d, n_rows, KINDS[kind], rt, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, name)
