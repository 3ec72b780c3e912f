"""S1: the tie-exact stage-1 selection of K1's epilogue.

K1's dots [q, T, win] reach the dedup epilogue through one selection a
row: the top kk lanes of each table window ([q T, win]), or a flat top m1
over [q, T win].  The JAX package runs XLA's `jax.lax.approx_max_k` there
(`crypto_rec_tpu/ops/pallas/slabscore.py:486, :503`,
`models/lsh/hypercube.py:473, :674, :778`), or `lax.top_k` in its exact
mode (`slabscore.py:501`); it has no Pallas kernel for it.  Off the TPU
`approx_max_k` returns what `lax.top_k` returns: the k largest, equal
values lowest index first.  `torch.topk` promises no order among equal
values, and ties are common in these dots (duplicate corpus rows, int8
slabs folding near-duplicates together), so the port selects with
`window_topk`: on a CPU tensor `topk_desc` (a stable descending sort cut
to k, the plain version), on a CUDA tensor the Hopper kernel
`csrc/windowtopk.cu`, which returns exactly what `topk_desc` returns (NaN
first, +0.0 and -0.0 equal, ties by index), or raises.

The kernel keys each lane by 64 bits: `order_bits` of its value (stated
here in plain torch) above ~index.  It finds each row's threshold (the
k-th largest image) from a lower bound read off the lanes' maxima and one
counting pass, takes every image above it and the equal ones lowest index
first, and sorts only those.  Rows of m <= 1,024 with k <= 32 (the
per-window forms) take one warp a row, other rows one block; see the
source.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.topk import topk_desc

MAX_M = 32768      # one launch of the threshold kernel: rows of at most MAX_M lanes,
MAX_K = 1024       # k <= MAX_K; past either, two levels or the radix select


def order_bits(values: torch.Tensor) -> torch.Tensor:
    """The kernel's order-preserving image of f32 values, as int64 in
    [0, 2^32): larger value, larger image; -0.0 maps to +0.0's image and
    every NaN above +inf.  Sorting the images descending, ties by index,
    is `topk_desc`'s order."""
    v = values.float()
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, 0, u)
    img = torch.where(u >= 0x80000000, 0xFFFFFFFF - u, u | 0x80000000)
    return torch.where(torch.isnan(v), 0xFFFFFFFF, img)


def window_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """values [R, m] -> (the k largest of each row [R, k], their indices
    [R, k] int64), descending, equal values lowest index first.

    CPU tensors take `topk_desc`; CUDA tensors the Hopper kernel, which
    takes f32 rows with any 1 <= k <= m (`check_window_topk`) and raises on
    anything else: rows of m <= MAX_M with k <= MAX_K in one launch, longer
    rows in two levels (`two_level`), k > MAX_K by a radix select."""
    if not values.is_cuda:
        return topk_desc(values, k)
    return _select(values, k)


def check_window_topk(values: torch.Tensor, k: int) -> None:
    """Raise on what the card's S1 does not take: anything but f32 [R, m]
    rows with 1 <= k <= m (`lax.top_k`'s own domain), R < 2^31."""
    if values.dim() != 2:
        raise ValueError(f"window_topk takes [R, m] rows, got {tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"window_topk takes float32 rows, got {values.dtype}")
    R, m = values.shape
    if not 1 <= k <= m:
        raise ValueError(f"window_topk takes 1 <= k <= m; got k={k}, m={m}")
    if R >= 1 << 31 or -(-m // MAX_M) > 65535:
        raise ValueError("window_topk indexes rows with int32 and at most 65,535 segments")


def segment_width(m: int, k: int) -> int:
    """Entries a row of m > MAX_M lanes keeps after S1's first level: k
    from each full MAX_M-lane segment, min(k, length) from the last."""
    segs = -(-m // MAX_M)
    return (segs - 1) * k + min(k, m - (segs - 1) * MAX_M)


def _select(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """S1 on a CUDA tensor: the radix select (k > MAX_K), else one launch
    or, past MAX_M lanes, two levels (`two_level`)."""
    check_window_topk(values, k)
    v = values.contiguous()
    R, m = v.shape
    if k > MAX_K:
        p2 = 1 << (k - 1).bit_length()
        scratch = torch.empty(R, p2, dtype=torch.int64, device=v.device)
        return _counted("crt_window_topk_large", v, k, scratch.data_ptr(), R, m, k, p2)
    return two_level(v, k, lambda x, kk: _counted("crt_window_topk", x, kk), _segments)


def _segments(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """S1's first level on rows of m > MAX_M: one launch over every row's
    MAX_M-lane segments -> [R, segment_width(m, k)] winners, indices in the
    row."""
    R, m = values.shape
    w = segment_width(m, k)
    return _counted("crt_window_topk_segments", values, w, R, m, k, w)


def _counted(entry: str, values: torch.Tensor, k: int, *args) -> Tuple[torch.Tensor,
                                                                       torch.Tensor]:
    """`_launch` one of S1's entry points and count the launch: a row past
    MAX_M lanes counts one launch a level."""
    out = _launch(entry, values, k, *args)
    if values.shape[0]:
        window_topk.launches += 1
    return out


def two_level(values: torch.Tensor, k: int, select, segments) -> Tuple[torch.Tensor,
                                                                     torch.Tensor]:
    """The top k <= MAX_K of rows of any length: `select(values, k)` (one
    launch) where m <= MAX_M; else `segments(values, k)`, each MAX_M-lane
    segment's winners laid end to end ([R, segment_width(m, k)], indices
    in the row), selected again the same way, positions mapped back.
    Segments are in index order and each one's winners come out by (value
    desc, index asc), so among equal values the next level's lane order is
    the index order, and the answer is `topk_desc`'s."""
    if values.shape[1] <= MAX_M:
        return select(values, k)
    v1, i1 = segments(values, k)
    v2, pos = two_level(v1, k, select, segments)
    return v2, torch.gather(i1, 1, pos)


def _launch(entry: str, values: torch.Tensor, k: int, *args) -> Tuple[torch.Tensor, torch.Tensor]:
    """Allocate [R, k] outputs and launch one of the S1 entry points on
    contiguous f32 values: (values, out_v, out_i, *args or (R, m, k),
    stream)."""
    v = values.contiguous()
    R, m = v.shape
    out_v = torch.empty(R, k, dtype=torch.float32, device=v.device)
    out_i = torch.empty(R, k, dtype=torch.int64, device=v.device)
    if R == 0:
        return out_v, out_i
    with torch.cuda.device(v.device):
        err = getattr(build.library(), entry)(
            v.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), *(args or (R, m, k)),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, entry)
    return out_v, out_i


window_topk.launches = 0
