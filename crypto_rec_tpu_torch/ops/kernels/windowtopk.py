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
source.  `window_topk_prev` launches the previous design
(`csrc/windowtopk_prev.cu`: k serial arg-max rounds a row), kept only so a
run on the card can time it beside the kernel; no path calls it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.ops.kernels import build
from crypto_rec_tpu_torch.ops.topk import topk_desc

MAX_M = 32768      # a block row stages m f32 images in shared memory
MAX_K = 1024


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
    takes f32 rows with 1 <= k <= m, m <= MAX_M and k <= MAX_K and raises
    on anything else."""
    if not values.is_cuda:
        return topk_desc(values, k)
    return _select(values, k)


def window_topk_prev(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """S1's previous design on a CUDA tensor (the same contract as
    `window_topk`), for timing beside it; raises on a CPU tensor."""
    if not values.is_cuda:
        raise ValueError("window_topk_prev runs only on the card")
    return _launch("crt_window_topk_prev", values, k)


def _select(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `crt_window_topk` on a CUDA tensor and count the launch."""
    out = _launch("crt_window_topk", values, k)
    if values.shape[0]:
        window_topk.launches += 1
    return out


def _launch(entry: str, values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Check, allocate and launch one of the S1 entry points."""
    if values.dim() != 2:
        raise ValueError(f"window_topk takes [R, m] rows, got {tuple(values.shape)}")
    if values.dtype != torch.float32:
        raise TypeError(f"window_topk takes float32 rows, got {values.dtype}")
    R, m = values.shape
    if not 1 <= k <= m or m > MAX_M or k > MAX_K:
        raise ValueError(f"window_topk takes 1 <= k <= m, m <= {MAX_M}, k <= {MAX_K}; "
                         f"got k={k}, m={m}")
    if R >= 1 << 31:
        raise ValueError("window_topk indexes rows with int32")
    v = values.contiguous()
    out_v = torch.empty(R, k, dtype=torch.float32, device=v.device)
    out_i = torch.empty(R, k, dtype=torch.int64, device=v.device)
    if R == 0:
        return out_v, out_i
    with torch.cuda.device(v.device):
        err = getattr(build.library(), entry)(
            v.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), R, m, k,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, entry)
    return out_v, out_i


window_topk.launches = 0
