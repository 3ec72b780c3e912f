"""K2: fused sign-projection + bit-pack hash (cosine LSH bucket ids).

    acc = x @ proj (f32), bit = acc >= 0, k bits per table packed MSB-first
    (reference cosine_g_gen.hpp:62-72)

`signproj_bucket_ids` routes by device: a CUDA tensor launches the Hopper
kernel in `csrc/signproj.cu` (and raises if it cannot), a CPU tensor runs
`signproj_bucket_ids_plain`, the plain PyTorch version of the same function.
`signproj_bucket_ids_prev` is the previous design (`csrc/signproj_prev.cu`),
kept for side-by-side timing on the card.
Replaces the TPU kernel `crypto_rec_tpu/ops/pallas/signproj.py`.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.kernels import build

# rows per plain-version chunk: bounds the [chunk, L*k] f32 projection
# temporary (the JAX build streams the same chunk size through lax.map)
_CHUNK = 1 << 18
_MAX_K = 30                       # int32 bucket ids


def _check(x: torch.Tensor, proj: torch.Tensor, k: int, L: int) -> None:
    if x.dim() != 2 or proj.shape != (x.shape[1], L * k):
        raise ValueError(
            f"expected x [n, d] and proj [d, L*k]; got {tuple(x.shape)}, "
            f"{tuple(proj.shape)} with k={k}, L={L}"
        )
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k={k}: bucket ids hold at most {_MAX_K} bits")


def signproj_bucket_ids_plain(
    x: torch.Tensor, proj: torch.Tensor, k: int, L: int
) -> torch.Tensor:
    """[n, d] x [d, L*k] -> [n, L] int32 bucket ids: an f32 matmul and a
    bit pack, chunked over rows."""
    _check(x, proj, k, L)
    weights = torch.bitwise_left_shift(
        torch.ones((), dtype=torch.int32, device=x.device),
        torch.arange(k - 1, -1, -1, dtype=torch.int32, device=x.device),
    )
    out = torch.empty(x.shape[0], L, dtype=torch.int32, device=x.device)
    p = proj.float()
    for s in range(0, x.shape[0], _CHUNK):
        acc = torch.matmul(x[s:s + _CHUNK].float(), p)
        bits = (acc >= 0.0).to(torch.int32).view(-1, L, k)
        out[s:s + _CHUNK] = torch.sum(bits * weights, dim=-1, dtype=torch.int32)
    return out


def signproj_bucket_ids(
    x: torch.Tensor, proj: torch.Tensor, k: int, L: int
) -> torch.Tensor:
    """[n, d] x [d, L*k] -> [n, L] int32 bucket ids (MSB-first pack).

    CPU tensors take the plain version; CUDA tensors the Hopper kernel."""
    if not x.is_cuda:
        return signproj_bucket_ids_plain(x, proj, k, L)
    _check(x, proj, k, L)
    out = _launch("crt_signproj", x, proj, k, L)
    signproj_bucket_ids.launches += 1
    return out


signproj_bucket_ids.launches = 0


def signproj_bucket_ids_prev(
    x: torch.Tensor, proj: torch.Tensor, k: int, L: int
) -> torch.Tensor:
    """K2's previous design (`csrc/signproj_prev.cu`), kept so a run on the
    card can time it beside the streamed kernel on the same inputs; no
    path of the package calls it.  CPU tensors take the plain version."""
    if not x.is_cuda:
        return signproj_bucket_ids_plain(x, proj, k, L)
    _check(x, proj, k, L)
    return _launch("crt_signproj_prev", x, proj, k, L)


_MAX_L = 64                       # the kernel's (row group, table) units a block


def _launch(entry: str, x, proj, k: int, L: int) -> torch.Tensor:
    if x.dtype != torch.float32 or proj.dtype != torch.float32:
        raise TypeError("the signproj kernel takes float32 x and proj")
    if proj.device != x.device:
        raise ValueError("x and proj must live on the same CUDA device")
    n, d = x.shape
    if d % 4:
        raise ValueError(f"the signproj kernel needs d % 4 == 0, got d={d}")
    if L > _MAX_L:
        raise ValueError(f"the signproj kernel takes at most {_MAX_L} tables, got L={L}")
    x = x.contiguous()
    proj = proj.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the signproj kernel reads x as 16-byte aligned rows")
    out = torch.empty(n, L, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(build.library(), entry)(
            x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, k, L,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, entry)
    return out
