"""K2: fused sign-projection + bit-pack hash (cosine LSH bucket ids).

    acc = x @ proj (f32), bit = acc >= 0, k bits per table packed MSB-first
    (reference cosine_g_gen.hpp:62-72)

`signproj_bucket_ids` routes by device: a CUDA tensor launches the Hopper
kernel in `csrc/signproj.cu` (and raises if it cannot), a CPU tensor runs
`signproj_bucket_ids_plain`, the plain PyTorch version of the same function.
Replaces the TPU kernel `crypto_rec_tpu/ops/pallas/signproj.py`.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.kernels import build

# rows per plain-version chunk: bounds the [chunk, L*k] f32 projection
# temporary (the JAX build streams the same chunk size through lax.map)
_CHUNK = 1 << 18
_MAX_K = 30        # int32 bucket ids


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

    CPU tensors take the plain version; CUDA tensors the Hopper kernel, at
    any d and L and 1 <= k <= 30 (the kernel streams proj beside x and
    splits the tables into groups where one block cannot hold a slice of
    all of them)."""
    if not x.is_cuda:
        return signproj_bucket_ids_plain(x, proj, k, L)
    out = _launch(x, proj, k, L)
    signproj_bucket_ids.launches += 1
    return out


signproj_bucket_ids.launches = 0


def check_signproj(x: torch.Tensor, proj: torch.Tensor, k: int, L: int) -> None:
    """Raise on what the card's K2 does not take, before any launch: x and
    proj not [n, d] and [d, L k] float32 on one device, or k outside 1..30
    (int32 ids).  Any d and any L."""
    _check(x, proj, k, L)
    if x.dtype != torch.float32 or proj.dtype != torch.float32:
        raise TypeError("the signproj kernel takes float32 x and proj")
    if proj.device != x.device:
        raise ValueError("x and proj must live on the same CUDA device")


def _launch(x, proj, k: int, L: int) -> torch.Tensor:
    check_signproj(x, proj, k, L)
    if x.shape[1] % 4:
        # the kernel reads rows as float4: zero columns in x and zero rows
        # in proj add exact zeros to every projection
        pad = -x.shape[1] % 4
        x = torch.nn.functional.pad(x, (0, pad))
        proj = torch.nn.functional.pad(proj, (0, 0, 0, pad))
    n, d = x.shape
    x = x.contiguous()
    proj = proj.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("the signproj kernel reads x as 16-byte aligned rows")
    out = torch.empty(n, L, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = build.library().crt_signproj(
            x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, k, L,
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "crt_signproj")
    return out
