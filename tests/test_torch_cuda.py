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
    slab_window_dots_rowwise,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (the Hopper kernels)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,k,L", [(300, 32, 5, 3), (77, 16, 4, 2),
                                     (100_000, 128, 13, 8), (100_000, 128, 13, 1),
                                     (20_000, 15, 4, 5)])
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


def test_slab_kernel_without_sizes(cuda):
    """mask=False needs no window sizes: sizes=None gives the dots of the
    call with sizes, and mask=True without them is refused."""
    g = torch.Generator(device=cuda).manual_seed(10)
    T, n_pad, d, q = 8, 8192, 128, 203
    packed = torch.randint(-127, 128, (T, n_pad, d), generator=g, device=cuda).to(torch.int8)
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.randn(q, d, generator=g, device=cuda)
    got, a_got = slab_window_dots(packed, starts, None, qv, 488, mask=False)
    want, a_want = slab_window_dots(packed, starts, starts, qv, 488, mask=False)
    torch.cuda.synchronize()
    assert torch.equal(a_got, a_want) and torch.equal(got, want)
    with pytest.raises(ValueError, match="sizes"):
        slab_window_dots(packed, starts, None, qv, 488, mask=True)


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


# ---- the tile-major K1 against the plain version and the row-wise body ----

def _three_way(args, mask, shared, atol):
    """New K1, row-wise K1 and plain on the same windows: aligned starts
    and masked lanes equal, dots within rtol 1e-5 / atol."""
    got, a_got = slab_window_dots(*args, mask=mask, shared_slab=shared)
    row, a_row = slab_window_dots_rowwise(*args, mask=mask, shared_slab=shared)
    want, a_want = slab_window_dots_plain(*args, mask=mask, shared_slab=shared)
    torch.cuda.synchronize()
    assert torch.equal(a_got, a_want) and torch.equal(a_row, a_want)
    fin = torch.isfinite(want)
    for out in (got, row):
        assert torch.equal(torch.isfinite(out), fin)
        assert torch.allclose(out[fin], want[fin], rtol=1e-5, atol=atol)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("mask", [False, True])
def test_tile_kernel_hot_tile(cuda, dtype, mask):
    """Most windows on one bucket: the hot tile's pairs spread over many
    work items."""
    g = torch.Generator(device=cuda).manual_seed(11)
    packed = _slabs(g, (1, 8192, 128), dtype, cuda)
    q, group = 600, 8
    starts = torch.randint(0, 8192, (q, group), generator=g, device=cuda, dtype=torch.int32)
    starts[:500] = 3000
    sizes = torch.randint(0, 600, (q, group), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, 128, generator=g, device=cuda), dim=-1)
    _three_way((packed, starts, sizes, qv, 488), mask, True, 1e-4)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_tile_kernel_augmented_width(cuda, dtype):
    """d_aug = 256 (32 pairs an item), raw queries, windows clamped at the
    slab's end."""
    g = torch.Generator(device=cuda).manual_seed(12)
    T, n_pad, d, q = 4, 8192, 256, 300
    packed = _slabs(g, (T, n_pad, d), dtype, cuda)
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    starts[:40] = n_pad - 5
    sizes = torch.randint(0, 900, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.randn(q, d, generator=g, device=cuda)
    want, _ = slab_window_dots_plain(packed, starts, sizes, qv, 768, mask=False)
    _three_way((packed, starts, sizes, qv, 768), True, False,
               1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_tile_kernel_shared_multicube_slab(cuda, dtype):
    """The euclidean MultiCube form: one [1, 3 n_seg, 256] slab of three
    cube segments, absolute starts, 8 windows a row."""
    g = torch.Generator(device=cuda).manual_seed(13)
    C, n_seg, d, rows, group = 3, 4096, 256, 240, 8
    packed = _slabs(g, (1, C * n_seg, d), dtype, cuda)
    local = torch.randint(0, n_seg, (rows, group), generator=g, device=cuda, dtype=torch.int32)
    starts = local + (torch.arange(group, device=cuda, dtype=torch.int32) % C)[None] * n_seg
    sizes = torch.randint(0, 1100, (rows, group), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.randn(rows, d, generator=g, device=cuda)
    want, _ = slab_window_dots_plain(packed, starts, sizes, qv, 976, mask=False,
                                     shared_slab=True)
    _three_way((packed, starts, sizes, qv, 976), False, True,
               1e-6 * float(want.abs().max()))


def test_tile_kernel_offsets_beyond_int32(cuda):
    """q T win = 66,000 x 32 x 1,024 > 2^31 dots: the last rows' windows
    (offsets past 2^31) equal the plain version's on those rows alone."""
    g = torch.Generator(device=cuda).manual_seed(14)
    packed = _slabs(g, (1, 4096, 128), torch.int8, cuda)
    q, group = 66000, 32
    starts = torch.randint(0, 4096, (q, group), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, 128, generator=g, device=cuda), dim=-1)
    got, _ = slab_window_dots(packed, starts, None, qv, 976, mask=False, shared_slab=True)
    assert got.numel() > 2**31
    tail = slice(q - 64, q)
    want, _ = slab_window_dots_plain(packed, starts[tail], None, qv[tail], 976,
                                     mask=False, shared_slab=True)
    torch.cuda.synchronize()
    assert torch.allclose(got[tail], want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("L", [1, 8])
def test_signproj_kernel_ragged_tiles(cuda, L):
    """n not a multiple of a tile (1,024 rows at L = 1, 128 at L = 8) nor
    of the grid's stride; every row's ids equal the plain version's away
    from projections at rounding distance of 0."""
    n, d, k = 1_000_003, 128, 13
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn(n, d, generator=g, device=cuda)
    proj = torch.randn(d, L * k, generator=g, device=cuda)
    got = signproj_bucket_ids(x, proj, k, L)
    want = signproj_bucket_ids_plain(x, proj, k, L)
    torch.cuda.synchronize()
    acc = (x @ proj).abs() <= 1e-5 * x.norm(dim=1, keepdim=True) * proj.norm(dim=0)
    bad = (got != want).any(1)
    assert not (bad & ~acc.any(1)).any()
    assert int(bad.sum()) <= int(acc.any(1).sum())


# ---- the probe kernels P2-P6 ----

def _probe_inputs(g, dtype, cuda, T=8, n_pad=8192, d=128, q=203):
    """Unit-row slabs (int8: global-scale quantized), starts running into
    the slab's end, unit queries; q is ragged on purpose."""
    x = torch.nn.functional.normalize(torch.randn(T, n_pad, d, generator=g, device=cuda),
                                      dim=-1)
    packed = (torch.clamp(torch.round(x / (x.abs().max() / 127)), -127, 127).to(torch.int8)
              if dtype == torch.int8 else x.to(dtype))
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, d, generator=g, device=cuda), dim=-1)
    return packed, starts, qv


@pytest.mark.parametrize("nbins", [128, 256])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_binned_kernel_matches_plain(cuda, dtype, nbins):
    from crypto_rec_tpu_torch.ops.kernels.binned import binned_dots, binned_dots_plain

    packed, starts, qv = _probe_inputs(torch.Generator(device=cuda).manual_seed(4),
                                       dtype, cuda)
    vk, pk, ak = binned_dots(packed, starts, qv, 488, nbins)
    vp, pp, ap = binned_dots_plain(packed, starts, qv, 488, nbins)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    atol = 1e-4 if dtype == torch.int8 else 1e-6
    assert torch.allclose(vk, vp, rtol=1e-5, atol=atol)
    dots, _ = slab_window_dots_plain(packed, starts, starts, qv, 488, mask=False)
    top2 = torch.topk(dots.reshape(dots.shape[0], -1, nbins), 2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > atol + 1e-5 * top2[:, 0].abs()
    assert torch.equal(pk[clear], pp[clear])


def test_binned_kernel_ties_go_to_the_lowest_row(cuda):
    """Integer-valued slabs and queries: exact dots, frequent ties, and
    every bin's winning lane equal to the plain version's."""
    from crypto_rec_tpu_torch.ops.kernels.binned import binned_dots, binned_dots_plain

    g = torch.Generator(device=cuda).manual_seed(9)
    packed = torch.randint(-2, 3, (8, 8192, 128), generator=g, device=cuda).to(torch.int8)
    qv = torch.randint(-1, 2, (203, 128), generator=g, device=cuda).float()
    starts = torch.randint(0, 8192, (203, 8), generator=g, device=cuda, dtype=torch.int32)
    vk, pk, _ = binned_dots(packed, starts, qv, 488, 128)
    vp, pp, _ = binned_dots_plain(packed, starts, qv, 488, 128)
    torch.cuda.synchronize()
    assert torch.equal(vk, vp) and torch.equal(pk, pp)


def test_int4_kernel_matches_plain(cuda):
    from crypto_rec_tpu_torch.ops.kernels.int4slab import (
        repack_int4, slab_window_dots_int4, slab_window_dots_int4_plain,
    )

    packed, starts, qv = _probe_inputs(torch.Generator(device=cuda).manual_seed(5),
                                       torch.int8, cuda)
    p4 = repack_int4(packed)
    assert p4.dtype == torch.uint8 and p4.shape[1] == packed.shape[1] // 2
    dk, ak = slab_window_dots_int4(p4, starts, qv, 488)
    dp, ap = slab_window_dots_int4_plain(p4, starts, qv, 488)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    assert torch.allclose(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode,dtype", [("load_floor", torch.int8),
                                        ("load_floor", torch.bfloat16),
                                        ("rounded_query", torch.bfloat16),
                                        ("i8_dot", torch.int8)])
def test_variant_kernel_matches_plain(cuda, mode, dtype):
    """load_floor: output and XOR fold exact; i8_dot bit for bit;
    rounded_query within rtol 1e-5."""
    from crypto_rec_tpu_torch.ops.kernels.slabvariants import (
        quantize_queries, slab_window_variant, slab_window_variant_plain,
    )

    packed, starts, qv = _probe_inputs(torch.Generator(device=cuda).manual_seed(6),
                                       dtype, cuda)
    if mode == "i8_dot":
        qv = quantize_queries(qv)
    got = slab_window_variant(packed, starts, qv, 488, mode)
    want = slab_window_variant_plain(packed, starts, qv, 488, mode)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    if mode == "rounded_query":
        assert torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(got[0], want[0])
    if mode == "load_floor":
        assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_blk_kernel_matches_plain(cuda, dtype):
    from crypto_rec_tpu_torch.ops.kernels.blkslab import (
        blk_window_dots, blk_window_dots_plain, to_blk,
    )

    packed, starts, qv = _probe_inputs(torch.Generator(device=cuda).manual_seed(7),
                                       dtype, cuda)
    blk = to_blk(packed)
    dk, ak = blk_window_dots(blk, starts, qv, 488)
    dp, ap = blk_window_dots_plain(blk, starts, qv, 488)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    assert torch.allclose(dk, dp, rtol=1e-5, atol=1e-4 if dtype == torch.int8 else 1e-6)
    # the same lanes as the row layout at 128-aligned starts
    dr, _ = slab_window_dots(packed, (starts // 128) * 128, starts, qv, 488, mask=False)
    assert torch.allclose(dk, dr, rtol=1e-5, atol=1e-4 if dtype == torch.int8 else 1e-6)


@pytest.mark.parametrize("kernel", ["binned", "int4", "variant", "blk"])
def test_probe_kernels_refuse_mixed_devices(cuda, kernel):
    """Slabs on the card with starts on the host: the wrapper raises, it
    never falls back to the plain version."""
    from crypto_rec_tpu_torch.ops.kernels import binned, blkslab, int4slab, slabvariants

    packed, starts, qv = _probe_inputs(torch.Generator(device=cuda).manual_seed(8),
                                       torch.int8, cuda, T=2, n_pad=2048, q=16)
    starts = starts.cpu()
    call = {
        "binned": lambda: binned.binned_dots(packed, starts, qv, 488),
        "int4": lambda: int4slab.slab_window_dots_int4(int4slab.repack_int4(packed),
                                                       starts, qv, 488),
        "variant": lambda: slabvariants.slab_window_variant(packed, starts, qv, 488,
                                                            "load_floor"),
        "blk": lambda: blkslab.blk_window_dots(blkslab.to_blk(packed), starts, qv, 488),
    }[kernel]
    with pytest.raises(ValueError, match="device"):
        call()
