"""The Hopper kernels against their plain PyTorch versions on the card.

These supplement chip_smoke.py.  They need an NVIDIA GPU and nvcc and skip
without one.  On a machine with the card and without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from crypto_rec_tpu_torch.ops.kernels.signproj import (
    signproj_bucket_ids,
    signproj_bucket_ids_plain,
)
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    slab_window_dots,
    slab_window_dots_plain,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the Hopper kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,k,L", [(300, 32, 5, 3), (77, 16, 4, 2),
                                     (100_000, 128, 13, 8), (100_000, 128, 13, 1)])
def test_signproj_kernel_matches_plain(cuda, n, d, k, L):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, d, generator=g, device=cuda)
    proj = torch.randn(d, L * k, generator=g, device=cuda)
    before = signproj_bucket_ids.launches
    got = signproj_bucket_ids(x, proj, k, L)
    want = signproj_bucket_ids_plain(x, proj, k, L)
    torch.cuda.synchronize()
    assert signproj_bucket_ids.launches == before + 1
    # a row may differ only where a projection sits at rounding distance of 0
    acc = (x @ proj).abs() <= 1e-5 * x.norm(dim=1, keepdim=True) * proj.norm(dim=0)
    bad = (got != want).any(1)
    assert not (bad & ~acc.any(1)).any()


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask,shared", [(False, False), (True, False), (True, True)])
def test_slab_kernel_matches_plain(cuda, dtype, mask, shared):
    g = torch.Generator(device=cuda).manual_seed(1)
    T, n_pad, d, q, per_table = 8, 8192, 128, 200, 488
    if dtype == torch.int8:
        packed = torch.randint(-127, 128, (T, n_pad, d), generator=g, device=cuda)
        packed = packed.to(torch.int8)
    else:
        packed = torch.nn.functional.normalize(
            torch.randn(T, n_pad, d, generator=g, device=cuda), dim=-1).to(dtype)
    if shared:
        packed = packed[:1].contiguous()
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    sizes = torch.randint(0, 600, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, d, generator=g, device=cuda), dim=-1)
    args = (packed, starts, sizes, qv, per_table)
    got, a_got = slab_window_dots(*args, mask=mask, shared_slab=shared)
    want, a_want = slab_window_dots_plain(*args, mask=mask, shared_slab=shared)
    torch.cuda.synchronize()
    assert torch.equal(a_got, a_want)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-4 if dtype == torch.int8 else 1e-6)


def _slabs(g, shape, dtype, device):
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, device=device).to(torch.int8)
    return torch.randn(*shape, generator=g, device=device).to(dtype)


@pytest.mark.parametrize("per_table", [768, 976])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask", [False, True])
def test_slab_kernel_augmented_width(cuda, dtype, per_table, mask):
    """d = 256, the augmented euclidean row width: int8 rows are 16 chunks,
    so the kernel runs one 16-lane group per row with one chunk a lane."""
    g = torch.Generator(device=cuda).manual_seed(2)
    T, n_pad, d, q = 4, 8192, 256, 150
    packed = _slabs(g, (T, n_pad, d), dtype, cuda)
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    sizes = torch.randint(0, per_table + 200, (q, T), generator=g, device=cuda,
                          dtype=torch.int32)
    qv = torch.randn(q, d, generator=g, device=cuda)
    args = (packed, starts, sizes, qv, per_table)
    got, a_got = slab_window_dots(*args, mask=mask)
    want, a_want = slab_window_dots_plain(*args, mask=mask)
    torch.cuda.synchronize()
    assert torch.equal(a_got, a_want)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    scale = want[fin].abs().max()
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6 * float(scale))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_slab_kernel_shared_three_segment_slab(cuda, dtype):
    """The MultiCube form: one [1, 3 n_seg, 256] slab, windows given as
    absolute starts (local start + cube * n_seg), 8 windows per row."""
    g = torch.Generator(device=cuda).manual_seed(3)
    C, n_seg, d, rows, group, per_probe = 3, 4096, 256, 120, 8, 976
    packed = _slabs(g, (1, C * n_seg, d), dtype, cuda)
    local = torch.randint(0, n_seg, (rows, group), generator=g, device=cuda,
                          dtype=torch.int32)
    cube = torch.arange(group, device=cuda, dtype=torch.int32) % C
    starts = local + cube[None, :] * n_seg
    sizes = torch.randint(0, per_probe + 100, (rows, group), generator=g, device=cuda,
                          dtype=torch.int32)
    qv = torch.randn(rows, d, generator=g, device=cuda)
    args = (packed, starts, sizes, qv, per_probe)
    got, a_got = slab_window_dots(*args, mask=False, shared_slab=True)
    want, a_want = slab_window_dots_plain(*args, mask=False, shared_slab=True)
    torch.cuda.synchronize()
    assert torch.equal(a_got, a_want) and got.shape == (rows, group, 1024)
    assert int(a_got.max()) <= C * n_seg - 1024
    scale = want.abs().max()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * float(scale))
