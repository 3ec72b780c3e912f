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


# ---- the tile-major K1 against the plain version ----

def _two_way(args, mask, shared, atol):
    """The tile-major K1 and the plain version on the same windows: aligned
    starts and masked lanes equal, dots within rtol 1e-5 / atol."""
    got, a_got = slab_window_dots(*args, mask=mask, shared_slab=shared)
    want, a_want = slab_window_dots_plain(*args, mask=mask, shared_slab=shared)
    torch.cuda.synchronize()
    assert torch.equal(a_got, a_want)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=atol)


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
    _two_way((packed, starts, sizes, qv, 488), mask, True, 1e-4)


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
    _two_way((packed, starts, sizes, qv, 768), True, False,
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
    _two_way((packed, starts, sizes, qv, 976), False, True,
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


@pytest.mark.parametrize("kernel", ["binned", "int4", "variant", "rounded", "i8", "blk"])
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
        "rounded": lambda: slabvariants.slab_window_variant(packed.to(torch.bfloat16),
                                                            starts, qv, 488,
                                                            "rounded_query"),
        "i8": lambda: slabvariants.slab_window_variant(
            packed, starts, slabvariants.quantize_queries(qv), 488, "i8_dot"),
        "blk": lambda: blkslab.blk_window_dots(blkslab.to_blk(packed), starts, qv, 488),
    }[kernel]
    with pytest.raises(ValueError, match="device"):
        call()


# ---- the tensor-core P2, P3, P5 and P6 bodies (csrc/probetile.cu) ----

# name -> (T, n_pad, q, how the starts are drawn): windows that share tiles
# heavily (many queries on a few buckets), that barely do (few queries on
# a long slab), and that run into the slab's end, whose last tile is cut
# short (T n_pad is no multiple of any tile's rows, nor T n_pad / 2)
SHARING = {
    "heavy": (8, 8192, 700, "few"),
    "sparse": (8, 65536, 23, "uniform"),
    "last tile cut": (4, 8092, 300, "end"),
}


def _sharing_inputs(g, case, dtype, cuda, d=128, blocks=False):
    """blocks: n_pad cut to whole 128-row blocks (P5's layout)."""
    T, n_pad, q, how = SHARING[case]
    n_pad = n_pad // 128 * 128 if blocks else n_pad
    packed, _, qv = _probe_inputs(g, dtype, cuda, T=T, n_pad=n_pad, d=d, q=q)
    if how == "few":
        starts = torch.randint(0, 6, (q, T), generator=g, device=cuda,
                               dtype=torch.int32) * 1000
    elif how == "end":
        starts = torch.randint(n_pad - 700, n_pad, (q, T), generator=g, device=cuda,
                               dtype=torch.int32)
    else:
        starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda,
                               dtype=torch.int32)
    return packed, starts, qv


def _binned_against_plain(fn, packed, starts, qv, nbins):
    """vals within the dot tolerance, aligned starts equal, every bin's lane
    equal wherever its best and second-best dots differ by more than it."""
    from crypto_rec_tpu_torch.ops.kernels.binned import binned_dots_plain

    vk, pk, ak = fn(packed, starts, qv, 488, nbins)
    vp, pp, ap = binned_dots_plain(packed, starts, qv, 488, nbins)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    atol = 1e-4 if packed.dtype == torch.int8 else 1e-6
    torch.testing.assert_close(vk, vp, rtol=1e-5, atol=atol)
    dots, _ = slab_window_dots_plain(packed, starts, None, qv, 488, mask=False)
    top2 = torch.topk(dots.reshape(dots.shape[0], -1, nbins), 2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > atol + 1e-5 * top2[:, 0].abs()
    assert float(clear.float().mean()) > 0.9
    assert torch.equal(pk[clear], pp[clear])


@pytest.mark.parametrize("case", list(SHARING))
@pytest.mark.parametrize("dtype,nbins", [(torch.int8, 128), (torch.bfloat16, 256)])
def test_binned_designs_match_plain(cuda, dtype, nbins, case):
    from crypto_rec_tpu_torch.ops.kernels import binned

    g = torch.Generator(device=cuda).manual_seed(21)
    _binned_against_plain(binned.binned_dots, *_sharing_inputs(g, case, dtype, cuda), nbins)


@pytest.mark.parametrize("nbins", [128, 256])
def test_binned_designs_ties_go_to_the_lowest_row(cuda, nbins):
    """Integer-valued slabs and queries, heavily shared windows: exact
    dots, ties in most bins, and every winner's lane (the lowest row of a
    tie) equal to the plain version's across tiles, tables and blocks."""
    from crypto_rec_tpu_torch.ops.kernels import binned

    fn = binned.binned_dots
    g = torch.Generator(device=cuda).manual_seed(9)
    packed = torch.randint(-2, 3, (8, 8192, 128), generator=g, device=cuda).to(torch.int8)
    qv = torch.randint(-1, 2, (300, 128), generator=g, device=cuda).float()
    starts = torch.randint(0, 4, (300, 8), generator=g, device=cuda,
                           dtype=torch.int32) * 2000
    vk, pk, _ = fn(packed, starts, qv, 488, nbins)
    vp, pp, _ = binned.binned_dots_plain(packed, starts, qv, 488, nbins)
    torch.cuda.synchronize()
    assert torch.equal(vk, vp) and torch.equal(pk, pp)


@pytest.mark.parametrize("case", list(SHARING))
@pytest.mark.parametrize("d", [128, 256])
def test_int4_designs_match_plain(cuda, d, case):
    """The tile-major P6 against the plain version on every lane; windows
    starting on a 64-row boundary read the same aligned start."""
    from crypto_rec_tpu_torch.ops.kernels import int4slab

    g = torch.Generator(device=cuda).manual_seed(22)
    packed, starts, qv = _sharing_inputs(g, case, torch.int8, cuda, d=d)
    p4 = int4slab.repack_int4(packed)
    dk, ak = int4slab.slab_window_dots_int4(p4, starts, qv, 488)
    dp, ap = int4slab.slab_window_dots_int4_plain(p4, starts, qv, 488)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("case", list(SHARING))
def test_rounded_query_designs_match_plain(cuda, case, d):
    """P2 rounded_query, tile-major, against the plain version on every
    lane within the dot tolerance."""
    from crypto_rec_tpu_torch.ops.kernels import slabvariants as sv

    g = torch.Generator(device=cuda).manual_seed(23)
    packed, starts, qv = _sharing_inputs(g, case, torch.bfloat16, cuda, d=d)
    dk, ak = sv.rounded_query_dots(packed, starts, qv, 488)
    dp, ap = sv.slab_window_variant_plain(packed, starts, qv, 488, "rounded_query")
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_pad", [8192, 4097], ids=["aligned", "odd slab length"])
def test_rounded_query_kernel_exact_on_integers(cuda, n_pad):
    """Integer-valued bf16 slabs and f32 queries: every product and sum is
    exact, so the tile-major kernel equals the plain version bit for bit
    (an odd slab length takes the writer's scalar path)."""
    from crypto_rec_tpu_torch.ops.kernels import slabvariants as sv

    g = torch.Generator(device=cuda).manual_seed(24)
    packed = torch.randint(-3, 4, (3, n_pad, 128), generator=g,
                           device=cuda).to(torch.bfloat16)
    qv = torch.randint(-2, 3, (257, 128), generator=g, device=cuda).float()
    starts = torch.randint(0, n_pad, (257, 3), generator=g, device=cuda, dtype=torch.int32)
    before = sv.rounded_query_dots.launches
    dk, ak = sv.slab_window_variant(packed, starts, qv, 488, "rounded_query")
    dp, ap = sv.slab_window_variant_plain(packed, starts, qv, 488, "rounded_query")
    torch.cuda.synchronize()
    assert sv.rounded_query_dots.launches == before + 1
    assert torch.equal(ak, ap) and torch.equal(dk, dp)


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("case", list(SHARING))
def test_i8_designs_equal_plain(cuda, case, d):
    """P4 i8_dot, tile-major on the int8 tensor cores, bit for bit the
    plain version on every lane: int8 slabs over
    [-127, 127], per-row int8 queries; d = 64 and 192 take the int8
    swizzle's half-line branch."""
    from crypto_rec_tpu_torch.ops.kernels import slabvariants as sv

    g = torch.Generator(device=cuda).manual_seed(26)
    packed, starts, qv = _sharing_inputs(g, case, torch.int8, cuda, d=d)
    qi = sv.quantize_queries(qv)
    before = sv.i8_dots.launches
    dk, ak = sv.slab_window_variant(packed, starts, qi, 488, "i8_dot")
    dp, ap = sv.slab_window_variant_plain(packed, starts, qi, 488, "i8_dot")
    torch.cuda.synchronize()
    assert sv.i8_dots.launches == before + 1
    assert torch.equal(ak, ap) and torch.equal(dk, dp)


@pytest.mark.parametrize("n_pad", [8192, 4097], ids=["aligned", "odd slab length"])
def test_i8_kernel_exact_at_the_extremes(cuda, n_pad):
    """Slabs and queries drawn from {-127, 127, -3, 5, 0, 1} (no symmetry
    that a transposed fragment or swapped k halves would keep) at d = 256,
    half the queries equal to slab rows: dots up to 256 x 127 x 127, exact
    in int32 and in f32; an odd slab length takes the writer's scalar path."""
    from crypto_rec_tpu_torch.ops.kernels import slabvariants as sv

    g = torch.Generator(device=cuda).manual_seed(27)
    vals = torch.tensor([-127, 127, -3, 5, 0, 1], device=cuda, dtype=torch.int8)
    packed = vals[torch.randint(0, 6, (3, n_pad, 256), generator=g, device=cuda)]
    qi = vals[torch.randint(0, 6, (257, 256), generator=g, device=cuda)]
    starts = torch.randint(0, n_pad, (257, 3), generator=g, device=cuda, dtype=torch.int32)
    qi[::2] = packed[0, starts[::2, 0].long()]       # a query on its own window's rows
    dk, ak = sv.i8_dots(packed, starts, qi, 488)
    dp, ap = sv.slab_window_variant_plain(packed, starts, qi, 488, "i8_dot")
    torch.cuda.synchronize()
    assert torch.equal(ak, ap) and torch.equal(dk, dp)
    assert float(dp.max()) > 64 * 127 * 127


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(SHARING))
def test_load_floor_designs_equal_plain(cuda, case, d, dtype):
    """P2 load_floor, tile-major: output and XOR fold equal to the plain
    version's, which reads every window byte."""
    from crypto_rec_tpu_torch.ops.kernels import slabvariants as sv

    g = torch.Generator(device=cuda).manual_seed(28)
    packed, starts, qv = _sharing_inputs(g, case, dtype, cuda, d=d)
    before = sv.load_floor.launches
    got = sv.slab_window_variant(packed, starts, qv, 488, "load_floor")
    want = sv.slab_window_variant_plain(packed, starts, qv, 488, "load_floor")
    torch.cuda.synchronize()
    assert sv.load_floor.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(SHARING))
def test_blk_designs_match_plain(cuda, case, d, dtype):
    """P5 tile-major against the plain version on every lane; "last tile
    cut" meets the slab's last block."""
    from crypto_rec_tpu_torch.ops.kernels import blkslab

    g = torch.Generator(device=cuda).manual_seed(25)
    packed, starts, qv = _sharing_inputs(g, case, dtype, cuda, d=d, blocks=True)
    blk = blkslab.to_blk(packed)
    dk, ak = blkslab.blk_window_dots(blk, starts, qv, 488)
    dp, ap = blkslab.blk_window_dots_plain(blk, starts, qv, 488)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    torch.testing.assert_close(dk, dp, rtol=1e-5,
                               atol=1e-4 if dtype == torch.int8 else 1e-6)


@pytest.mark.parametrize("kernel,dtype,d,error", [
    ("binned", torch.float32, 128, TypeError),
    ("binned", torch.int8, 80, ValueError),
    ("int4", torch.uint8, 80, ValueError),
    ("int4", torch.uint8, 320, ValueError),
    ("rounded", torch.float32, 128, TypeError),
    ("rounded", torch.bfloat16, 320, ValueError),
    ("blk", torch.float32, 128, TypeError),
    ("blk", torch.int8, 80, ValueError),
    ("i8", torch.bfloat16, 128, TypeError),
    ("i8", torch.int8, 320, ValueError),
    ("floor", torch.uint8, 128, TypeError),
    ("floor", torch.int8, 40, ValueError),
])
def test_tile_wrappers_raise_outside_their_domain(cuda, kernel, dtype, d, error):
    """On CUDA tensors the tensor-core wrappers take int8 / bf16 (P3, P5),
    bf16 (P2), int8 (P4) or uint8 (P6) slabs with d % 64 == 0 and
    d <= 256, load_floor d % 16 == 0 rows of <= 2048 B, and raise on
    anything else before a launch; the plain versions take these inputs
    (P2's rounded_query only bf16 slabs, P4 only int8)."""
    from crypto_rec_tpu_torch.ops.kernels import binned, blkslab, int4slab, slabvariants

    g = torch.Generator(device=cuda).manual_seed(4)
    packed = torch.randint(-7, 8, (2, 1024, d), generator=g, device=cuda).to(dtype)
    starts = torch.randint(0, 1024, (6, 2), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.randn(6, d, generator=g, device=cuda)
    fn = {"binned": binned.binned_dots, "int4": int4slab.slab_window_dots_int4,
          "rounded": slabvariants.rounded_query_dots, "i8": slabvariants.i8_dots,
          "floor": slabvariants.load_floor, "blk": blkslab.blk_window_dots}[kernel]
    if kernel == "blk":
        packed = blkslab.to_blk(packed)
    if kernel == "i8":
        qv = slabvariants.quantize_queries(qv)
    before = fn.launches
    with pytest.raises(error):
        fn(packed, starts, qv, 200)
    assert fn.launches == before


def test_tile_kernel_at_the_streamed_chunk_geometry(cuda):
    """K1 on one streamed chunk's slab: int8 [4, chunk_pad, 128] built by
    build_streamed_index's host build, cosine windows of 256 (win 384),
    every window against the plain version."""
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.lsh.streamed import build_streamed_index
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets

    g = torch.Generator().manual_seed(3)
    x = torch.randn(400_000, 128, generator=g)
    sidx = build_streamed_index(torch.Generator().manual_seed(4),
                                lambda ci: x[ci * 200_000:(ci + 1) * 200_000].numpy(),
                                400_000, 128, 11, 4, 2)
    slab = sidx.slabs[0].to(cuda)
    starts = sidx.starts[0].to(cuda)
    qs = torch.nn.functional.normalize(torch.randn(3000, 128, generator=g), dim=1).to(cuda)
    qb = CosineLsh(torch.from_numpy(sidx.proj).to(cuda), 11, 4).bucket_ids(qs)
    s0, sizes = _window_offsets(starts, qb, 256)
    for mask in (False, True):
        dk, ak = slab_window_dots(slab, s0, sizes, qs, 256, mask=mask)
        dp, ap = slab_window_dots_plain(slab, s0, sizes, qs, 256, mask=mask)
        assert torch.equal(ak, ap)
        fin = torch.isfinite(dp)
        assert torch.equal(fin, torch.isfinite(dk))
        torch.testing.assert_close(dk[fin], dp[fin], rtol=1e-5, atol=1e-4)


def test_topk_ties_go_to_the_lowest_index_on_cuda(cuda):
    """ops/topk on CUDA returns equal values lowest index first, as
    lax.top_k does (the CPU test against JAX is tests/test_torch_topk.py),
    with NaN first and +0.0 and -0.0 equal: the same indices and value
    bits as on the CPU."""
    from crypto_rec_tpu_torch.ops import topk

    def bits(t):
        return t.cpu().view(torch.int32)

    g = torch.Generator().manual_seed(2)
    levels = torch.tensor([-1.0, -0.0, 0.0, 1.0, float("nan"), float("inf")])
    cases = []
    for m in (3000, 6000):
        v = levels[torch.randint(0, len(levels), (512, m), generator=g)]
        v[:256] = torch.rand(256, m, generator=g)     # rows without ties
        cases += [(v, torch.rand(512, m, generator=g) < 0.8, k) for k in (1, 20, m - 1)]
    for v, mask, k in cases:
        want = topk.topk_desc(v, k)
        got = topk.topk_desc(v.to(cuda), k)
        assert torch.equal(got[1].cpu(), want[1]) and torch.equal(bits(got[0]), bits(want[0]))
        wm = topk.masked_topk_desc(v, mask, k)
        gm = topk.masked_topk_desc(v.to(cuda), mask.to(cuda), k)
        assert torch.equal(bits(gm[0]), bits(wm[0]))
        assert all(torch.equal(a.cpu(), b) for a, b in zip(gm[1:], wm[1:]))
        assert torch.equal(topk.topn_indices(v.to(cuda), mask.to(cuda), k).cpu(),
                           topk.topn_indices(v, mask, k))


# ---- the CF engine's prediction kernel (csrc/cfpredict.cu) and its top-N ----

# The kernel sums each user's valid slots in slot order, the plain version
# contracts the gathered [q, P, c] rows in cuBLAS's order: they differ in
# summation order only.
CF_TOL = dict(rtol=1e-5, atol=1e-5)


def _cf_case(dev, q, P, c, n, id_dtype=torch.int64, seed=0):
    """cf_predict's operands on planted ratings (known density 0.56, sims
    in [-1, 1) descending, a tenth of the slots -1 pads), with three edge
    rows: user 0 has no valid neighbour, user 1 knows every coin, user 2's
    similarities are all zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nr = torch.randn(n, c, generator=g, device=dev) * 3.0
    nk = torch.rand(n, c, generator=g, device=dev) < 0.56
    nm = (nr * nk).sum(1) / nk.sum(1).clamp(min=1)
    qr = torch.randn(q, c, generator=g, device=dev) * 3.0
    qk = torch.rand(q, c, generator=g, device=dev) < 0.56
    qm = (qr * qk).sum(1) / qk.sum(1).clamp(min=1)
    sims = torch.sort(torch.rand(q, P, generator=g, device=dev) * 2 - 1, dim=1,
                      descending=True)[0]
    ids = torch.randint(0, n, (q, P), generator=g, device=dev)
    ids = torch.where(torch.rand(q, P, generator=g, device=dev) < 0.1, -1, ids)
    ids[0] = -1
    qk[1] = True
    sims[2] = 0.0
    valid = ids >= 0
    idx = (torch.clamp(ids, min=0) * valid).to(id_dtype)
    return [qr, qk, qm, nr, nm, sims, idx, valid]


def _cf_edge_rows(got, args):
    """The edge rows of `_cf_case` predict exactly: the user's mean where no
    neighbour holds weight, the ratings where every coin is known."""
    qr, qk, qm = args[:3]
    for u in (0, 2):
        assert torch.equal(got[u], torch.where(qk[u], qr[u], qm[u]))
    assert torch.equal(got[1], qr[1])


@pytest.mark.parametrize("q,P,c,n,id_dtype", [
    (73_421, 20, 100, 73_421, torch.int64),      # the CF cell's shape
    (5000, 1, 100, 4000, torch.int64),
    (5000, 33, 100, 4000, torch.int32),
    (300, 2000, 100, 4000, torch.int64),         # clustering's P = every member
    (5000, 20, 15, 4000, torch.int64),           # the program's 15 coins: scalar columns
    (5000, 20, 101, 4000, torch.int32),          # rows that are not float4 units
    (2000, 20, 300, 3000, torch.int64),          # three column chunks
])
def test_cf_predict_kernel_matches_plain(cuda, q, P, c, n, id_dtype):
    """The kernel against the plain version on the same card tensors, at
    the CF cell's shape and past each of its limits (P of 1, 33 and 2,000
    slots, c of 15, 101 and 300 coins, int32 ids); a run repeats bit for
    bit."""
    from crypto_rec_tpu_torch.ops.kernels.cfpredict import cf_predict, cf_predict_plain

    args = _cf_case(cuda, q, P, c, n, id_dtype, seed=q + P + c)
    before = cf_predict.launches
    got = cf_predict(*args)
    want = cf_predict_plain(*args)
    torch.cuda.synchronize()
    assert cf_predict.launches == before + 1
    torch.testing.assert_close(got, want, **CF_TOL)
    _cf_edge_rows(got, args)
    assert torch.equal(got, cf_predict(*args))


@pytest.mark.parametrize("c", [100, 16])
def test_cf_predict_kernel_on_unaligned_tables(cuda, c):
    """Rating tables one float off a 16-byte boundary (views into a larger
    buffer) take the scalar columns and predict what the plain version
    does."""
    from crypto_rec_tpu_torch.ops.kernels.cfpredict import cf_predict, cf_predict_plain

    args = _cf_case(cuda, 3000, 20, c, 2000, seed=c)
    for i in (0, 3):                                 # query and neighbour ratings
        buf = torch.empty(args[i].numel() + 1, device=cuda)
        view = buf[1:].view(args[i].shape)
        view.copy_(args[i])
        assert view.data_ptr() % 16
        args[i] = view
    got = cf_predict(*args)
    torch.testing.assert_close(got, cf_predict_plain(*args), **CF_TOL)
    _cf_edge_rows(got, args)


def test_cf_predict_kernel_poisons_an_out_of_range_id(cuda):
    """A valid slot whose id lies outside [0, n) is never read: that user's
    unknown coins come out NaN, known coins keep their ratings, and the
    other users predict as before; the card's checks raise on operands the
    kernel does not take."""
    from crypto_rec_tpu_torch.ops.kernels.cfpredict import cf_predict

    args = _cf_case(cuda, 500, 20, 100, 400, seed=5)
    want = cf_predict(*args)
    for bad in (400, -3):
        a = list(args)
        a[6], a[7] = args[6].clone(), args[7].clone()
        a[6][7, 3], a[7][7, 3] = bad, True
        got = cf_predict(*a)
        qr, qk = args[0], args[1]
        assert torch.equal(got[7][qk[7]], qr[7][qk[7]]) and torch.isnan(got[7][~qk[7]]).all()
        rest = torch.arange(500, device=cuda) != 7
        assert torch.equal(got[rest], want[rest])
    with pytest.raises(TypeError):
        cf_predict(*[t.double() if i == 3 else t for i, t in enumerate(args)])
    with pytest.raises(ValueError):
        cf_predict(*[t.cpu() if i == 5 else t for i, t in enumerate(args)])


def _stable_topn(scores, mask, n):
    """ops/topk.topn_indices as it selected before S1: the stable sort."""
    from crypto_rec_tpu_torch.ops import topk

    vals, idx = topk._topk_padded(torch.where(mask, scores, topk.NEG_INF), n)
    return torch.where(vals > topk.NEG_INF, idx, -1)


@pytest.mark.parametrize("q,c,n", [(73_421, 100, 5), (5000, 15, 20), (4000, 100, 1),
                                   (3000, 1500, 40)])
def test_topn_indices_on_cuda_equals_the_stable_sort(cuda, q, c, n):
    """The card's top-N (S1) returns exactly the stable sort's indices on
    the same predictions: planted ties (scores on a few levels, NaN, +-0),
    users who know every coin (-1 throughout), n > c (-1 pads)."""
    from crypto_rec_tpu_torch.ops import topk
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk

    g = torch.Generator(device=cuda).manual_seed(q + c)
    levels = torch.tensor([-1.0, -0.0, 0.0, 0.5, 1.0, 2.0, float("nan")], device=cuda)
    scores = levels[torch.randint(0, len(levels), (q, c), generator=g, device=cuda)]
    scores[q // 2:] = torch.randn(q - q // 2, c, generator=g, device=cuda)
    mask = torch.rand(q, c, generator=g, device=cuda) < 0.44
    mask[::7] = False                                # users who know every coin
    before = window_topk.launches
    got = topk.topn_indices(scores, mask, n)
    assert window_topk.launches == before + 1
    assert torch.equal(got, _stable_topn(scores, mask, n))
    assert (got[::7] == -1).all()
    assert torch.equal(got.cpu(), topk.topn_indices(scores.cpu(), mask.cpu(), n))


def test_recommend_topk_retrieved_at_the_jester_shape(cuda):
    """The CF engine at the CF cell's shape (73,421 users, 100 coins,
    P = 20 with -1 pads, top-5): one prediction kernel and one S1 launch;
    the predictions hold to the plain version's and the top-N equals the
    stable sort's on the same predictions."""
    from crypto_rec_tpu_torch.models.rec import engine
    from crypto_rec_tpu_torch.ops.kernels.cfpredict import cf_predict, cf_predict_plain
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk

    q = 73_421
    args = _cf_case(cuda, q, 20, 100, q, seed=21)
    qr, qk, qm, nr, nm, sims, idx, valid = args
    users = engine.RatingSet(ratings=nr, known=torch.rand_like(nr) < 0.56, mean=nm)
    queries = engine.RatingSet(ratings=qr, known=qk, mean=qm)
    ids = torch.where(valid, idx, -1)
    k0, s0 = cf_predict.launches, window_topk.launches
    rec = engine.recommend_topk_retrieved(queries, users, sims, ids, 5)
    torch.cuda.synchronize()
    assert cf_predict.launches == k0 + 1 and window_topk.launches == s0 + 1
    torch.testing.assert_close(rec.predicted, cf_predict_plain(*args), **CF_TOL)
    assert torch.equal(rec.top_n, _stable_topn(rec.predicted, ~qk, 5))
    assert torch.equal(rec.has_neighbors, valid.any(1))


def test_streamed_pass_overlaps_copy_and_compute(cuda):
    """One streamed pass with prefetch: the copy stream's chunk copies run
    while the compute stream retrieves (overlap_ms > 0, CUDA events), and
    the ids equal a pass without prefetch; K1 and K2 launch."""
    from crypto_rec_tpu_torch.models.lsh.streamed import (
        build_streamed_index, streamed_retrieve_topk,
    )

    g = torch.Generator().manual_seed(5)
    x = torch.randn(2_000_000, 128, generator=g)
    cr = 500_000
    sidx = build_streamed_index(torch.Generator().manual_seed(6),
                                lambda ci: x[ci * cr:(ci + 1) * cr].numpy(),
                                2_000_000, 128, 12, 4, 4)
    qs = x[:4096].to(cuda)
    streamed_retrieve_topk(sidx, qs, top_k=10, per_table=256)          # warm
    k1, k2 = slab_window_dots.launches, signproj_bucket_ids.launches
    stats = {}
    a = streamed_retrieve_topk(sidx, qs, top_k=10, per_table=256, stats=stats)
    assert slab_window_dots.launches - k1 == 4 and signproj_bucket_ids.launches - k2 == 1
    b = streamed_retrieve_topk(sidx, qs, top_k=10, per_table=256, prefetch=False)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], b[0])
    assert stats["overlap_ms"] > 0 and stats["copy_ms"] > 0, stats
    assert (a[1][:, 0].cpu() == torch.arange(4096)).float().mean() > 0.99


def test_sharded_recommend_scored_on_the_card_matches_cpu(cuda):
    """sharded_recommend_scored at mp = 4 logical shards on the card
    against the same call on CPU tensors (one int8 index, built on the CPU
    and copied over): K1 launches once a shard; neighbour ids equal away
    from ties, sims within 1e-5, predictions within 1e-4."""
    import dataclasses

    from crypto_rec_tpu_torch.parallel.mesh import make_mesh
    from crypto_rec_tpu_torch.parallel.sharded_index import (
        build_sharded_index, pack_sharded_index, shard_corpus, sharded_recommend_scored,
    )

    from _torch_parity import assert_topk_match

    g = torch.Generator().manual_seed(8)
    n, c, q = 4 * 4096, 128, 96
    x = torch.randn(n, c, generator=g)
    mean = x.mean(1)
    qr = x[:q] + 0.01 * torch.randn(q, c, generator=g)
    qk = torch.rand(q, c, generator=g) < 0.6
    qm = (qr * qk).sum(1) / qk.sum(1).clamp(min=1)
    cpu_mesh, card_mesh = (make_mesh((1, 4), device=d) for d in ("cpu", cuda))
    pc = shard_corpus(cpu_mesh, x)
    idx = build_sharded_index(cpu_mesh, torch.Generator().manual_seed(9), pc, "cosine", 7, 4)
    idx = pack_sharded_index(cpu_mesh, idx, pc, dtype=torch.int8, pad=1024)
    moved = {f.name: getattr(idx, f.name).to(cuda) for f in dataclasses.fields(idx)
             if isinstance(getattr(idx, f.name), torch.Tensor)}
    fam = dataclasses.replace(idx.family, proj=idx.family.proj.to(cuda))
    card_idx = dataclasses.replace(idx, family=fam, **moved)
    args = (qr, qk, qm)
    kw = dict(top_p=12, top_n=5, per_table=128)
    want = sharded_recommend_scored(cpu_mesh, idx, *args, pc, shard_corpus(cpu_mesh, mean),
                                    **kw)
    before = slab_window_dots.launches
    got = sharded_recommend_scored(card_mesh, card_idx, *(a.to(cuda) for a in args),
                                   shard_corpus(card_mesh, x), shard_corpus(card_mesh, mean),
                                   **kw)
    torch.cuda.synchronize()
    assert slab_window_dots.launches == before + 4
    assert_topk_match(want[3], want[4], got[3].cpu(), got[4].cpu(), rtol=1e-5, atol=1e-5)
    assert torch.allclose(got[0].cpu(), want[0], atol=1e-4)
    assert torch.equal(got[2].cpu(), want[2])
    for k in ("scanned_total", "window_dropped_total"):
        assert int(got[5][k]) == int(want[5][k])


def _row_scales(g, T, n_pad, n_real, device):
    """[T, n_pad] positive f32 per-row scales, 1 on the pad rows."""
    s = (0.5 + 1.5 * torch.rand(T, n_pad, generator=g, device=device)) / 127.0
    s[:, n_real:] = 1.0
    return s


@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask", [False, True])
def test_slab_kernel_per_row_scale_matches_plain(cuda, dtype, d, mask):
    """K1 with packed_scale: every stored lane times its slab row's scale,
    masked lanes -inf, within K1's tolerance of the plain version (which
    multiplies the gathered scale windows), one launch; windows sharing
    tiles heavily and running into the slab's end."""
    g = torch.Generator(device=cuda).manual_seed(d)
    T, n_pad, q, per_table = 4, 8092, 300, 488
    packed = _slabs(g, (T, n_pad, d), dtype, cuda)
    if dtype != torch.int8:
        packed = torch.nn.functional.normalize(packed.float(), dim=-1).to(dtype)
    scale = _row_scales(g, T, n_pad, n_pad - 200, cuda)
    starts = torch.cat([
        torch.randint(0, 4, (q // 2, T), generator=g, device=cuda, dtype=torch.int32) * 900,
        torch.randint(n_pad - 700, n_pad, (q - q // 2, T), generator=g, device=cuda,
                      dtype=torch.int32)])
    sizes = torch.randint(0, 600, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, d, generator=g, device=cuda), dim=-1)
    args = (packed, starts, sizes, qv, per_table)
    before = slab_window_dots.launches
    got, a_got = slab_window_dots(*args, mask=mask, packed_scale=scale)
    want, a_want = slab_window_dots_plain(*args, mask=mask, packed_scale=scale)
    torch.cuda.synchronize()
    assert slab_window_dots.launches == before + 1
    assert torch.equal(a_got, a_want)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    # K1's tolerance on the unscaled dots, times the largest scale
    atol = (1e-4 if dtype == torch.int8 else 1e-6) * float(scale.max())
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=atol)
    unscaled, _ = slab_window_dots(*args, mask=mask)
    assert not torch.allclose(got[fin], unscaled[fin])


def test_per_row_retrieval_on_the_card(cuda):
    """packed_retrieve_pallas with a per-row int8 pack: the card (K1 with the
    scale, counted) against the same call on CPU tensors (the plain
    version), strict and production; scale checks raise on the card."""
    from _torch_parity import assert_topk_match
    from crypto_rec_tpu_torch.models.lsh.index import build_index, pack_index, query_hashes
    from crypto_rec_tpu_torch.ops.kernels.slabscore import packed_retrieve_pallas

    g = torch.Generator().manual_seed(12)
    x = torch.randn(20000, 128, generator=g)
    qs = x[:256] + 0.05 * torch.randn(256, 128, generator=g)
    idx = pack_index(build_index(torch.Generator().manual_seed(2), x, "cosine", 8, 4), x,
                     dtype=torch.int8, scale_mode="row")
    assert idx.packed_scale is not None
    qb, _ = query_hashes(idx, qs)
    cpu_args = (idx.packed, idx.packed_rows, idx.bucket_starts, idx.n_rows, qs, qb, 10, 200)
    card_args = tuple(a.to(cuda) if isinstance(a, torch.Tensor) else a for a in cpu_args)
    for strict in (True, False):
        want = packed_retrieve_pallas(*cpu_args, strict=strict, packed_scale=idx.packed_scale)
        before = slab_window_dots.launches
        got = packed_retrieve_pallas(*card_args, strict=strict,
                                     packed_scale=idx.packed_scale.to(cuda))
        torch.cuda.synchronize()
        assert slab_window_dots.launches == before + 1
        assert_topk_match(want[0], want[1], got[0].cpu(), got[1].cpu(), rtol=1e-5, atol=1e-5)
    packed = card_args[0]
    starts = torch.zeros(4, 3, dtype=torch.int32, device=cuda)
    q4 = torch.zeros(4, 128, device=cuda)
    with pytest.raises(ValueError, match="shared_slab"):
        slab_window_dots(packed[:1].contiguous(), starts, starts, q4, 200, shared_slab=True,
                         packed_scale=idx.packed_scale[:1].to(cuda))
    with pytest.raises(ValueError, match="packed_scale"):
        slab_window_dots(packed, torch.zeros(4, 4, dtype=torch.int32, device=cuda), None,
                         q4, 200, mask=False, packed_scale=idx.packed_scale)   # on the CPU


def _tied_rows(R, m, g, device):
    """[R, m] f32 rows of exact ties: integers -4..4 with each 0 signed at
    random, +-inf, NaN and -inf lanes; every fourth row in {-1, -0.0, 0.0},
    every fourth row 95% -inf; the other rows' lanes mostly distinct."""
    v = torch.randint(-4, 5, (R, m), generator=g).float()
    u = torch.randint(0, 1000, (R, m), generator=g)
    r = torch.arange(R)[:, None] % 4
    v = torch.where(r == 3, -(u % 2).float(), v)
    v = torch.where(r == 1, torch.randn(R, m, generator=g), v)
    v = torch.where((v == 0) & (torch.rand(R, m, generator=g) < 0.5), -0.0, v)
    v = torch.where((r == 2) & (u < 950), float("-inf"), v)
    v = torch.where(u < 2, float("nan"), v)
    v = torch.where((u >= 2) & (u < 4), float("inf"), v)
    return torch.where((u >= 4) & (u < 40), float("-inf"), v).to(device)


# every PER of the warp rows (m <= 1,024, k <= 32) and both sides of each
# branch: warp rows to block rows at m 1,024 / 1,025 and k 32 / 33, second
# maxima in the warp bound from k 21, every block geometry's m boundary
S1_SHAPES = [(37, 5), (128, 12), (256, 32), (300, 3), (488, 12), (640, 12), (640, 20),
             (768, 20), (900, 10), (1024, 32), (1024, 1), (100, 100), (1, 1), (640, 86),
             (2048, 40), (5120, 80), (8192, 256), (16384, 40), (32768, 1024), (33, 33),
             (1025, 12), (1025, 32), (640, 21), (640, 32), (640, 33), (1024, 33),
             (2049, 40), (4096, 40), (4097, 40), (6144, 80), (6145, 80), (8193, 40),
             (16385, 40), (32768, 40)]


@pytest.mark.parametrize("m,k", S1_SHAPES)
def test_window_topk_kernel_equals_plain(cuda, m, k):
    """S1 against topk_desc bit for bit (values and indices) on tied rows,
    on the card and against the CPU; one launch counted."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    R = max(1, min(3000, (1 << 22) // m))
    v = _tied_rows(R, m, torch.Generator().manual_seed(m * 7 + k), cuda)
    before = window_topk.launches
    got = window_topk(v, k)
    torch.cuda.synchronize()
    assert window_topk.launches == before + 1
    assert got[0].shape == (R, k) and got[1].dtype == torch.int64
    for want in (topk_desc(v, k), topk_desc(v.cpu(), k)):
        assert torch.equal(got[1].cpu(), want[1].cpu())
        assert torch.equal(got[0].cpu().view(torch.int32), want[0].cpu().view(torch.int32))


@pytest.mark.parametrize("fill", [float("nan"), float("-inf"), -0.0, 2.5])
@pytest.mark.parametrize("m,k", [(640, 12), (1024, 32), (640, 80), (16384, 40),
                                 (32768, 1024)])
def test_window_topk_kernel_on_constant_rows(cuda, fill, m, k):
    """All-NaN, all--inf and all-equal rows (one row in four broken by a
    single larger value): the first k indices, values as stored."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    R = 64
    v = torch.full((R, m), fill, device=cuda)
    v[::4, m // 2] = float("inf") if fill != fill else float("nan")
    got = window_topk(v, k)
    want = topk_desc(v.cpu(), k)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.int32), want[0].view(torch.int32))


@pytest.mark.parametrize("m,k,cap", [(640, 12, 64), (1024, 32, 64), (5120, 40, 128),
                                     (640, 80, 160)])
@pytest.mark.parametrize("side", [-1, 0, 1])
def test_window_topk_kernel_at_the_candidate_cap(cuda, m, k, cap, side):
    """cap - 1, cap and cap + 1 images equal at the threshold, 0 .. k - 1
    above it: each side of the kernel's candidate cap (sort path against
    tie path) returns topk_desc's answer."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    g = torch.Generator().manual_seed(m + k + side)
    R = 96
    v = -torch.randint(1, 50, (R, m), generator=g).float()
    for r in range(R):
        at = torch.randperm(m, generator=g)[:cap + side]
        v[r, at] = 7.0
        v[r, at[:r % k]] = 9.0
    got = window_topk(v.to(cuda), k)
    want = topk_desc(v, k)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu(), want[0])


def test_window_topk_kernel_refuses_what_it_does_not_take(cuda):
    """S1 raises where lax.top_k does (k outside 1..m) and on what is not
    f32 [R, m]; rows past MAX_M lanes and k past MAX_K, which it refused
    before, now return topk_desc's answer."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import MAX_K, MAX_M, window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    v = torch.zeros(4, 64, device=cuda)
    for bad, err in [((v, 65), ValueError), ((v, 0), ValueError),
                     ((v.double(), 3), TypeError), ((v[None], 3), ValueError)]:
        with pytest.raises(err):
            window_topk(*bad)
    for wide, k in [(torch.zeros(2, MAX_M + 1, device=cuda), 3),
                    (torch.zeros(2, MAX_K + 1, device=cuda), MAX_K + 1)]:
        got = window_topk(wide, k)
        assert torch.equal(got[1], topk_desc(wide, k)[1])
    before = window_topk.launches
    e = window_topk(torch.zeros(0, 64, device=cuda), 5)
    assert e[0].shape == (0, 5) and window_topk.launches == before
    strided = torch.arange(64 * 8, dtype=torch.float32, device=cuda).reshape(64, 8).t()
    got = window_topk(strided, 3)       # not contiguous: the wrapper copies
    assert torch.equal(got[1].cpu(), torch.full((8, 3), 63).cpu() - torch.arange(3))


@pytest.mark.parametrize("strict", [True, False])
def test_stage1_sites_launch_s1(cuda, strict):
    """slab_topk on card dots selects through S1 (one launch) and returns
    what it returns on the CPU, ids exactly, on integer dots."""
    from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_topk
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk

    g = torch.Generator().manual_seed(4)
    q, L, win, n_pad = 512, 8, 640, 20000
    dots = torch.randint(-3, 4, (q, L, win), generator=g).float()
    a0 = torch.randint(0, n_pad - win, (q, L), generator=g, dtype=torch.int32)
    rows = torch.stack([torch.randperm(n_pad, generator=g) for _ in range(L)]).int()
    want = slab_topk(dots, a0, rows, n_pad, 20, exact=strict, stage1_per_table=12)
    before = window_topk.launches
    got = slab_topk(dots.to(cuda), a0.to(cuda), rows.to(cuda), n_pad, 20, exact=strict,
                    stage1_per_table=12)
    torch.cuda.synchronize()
    assert window_topk.launches == before + 1
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


# ---- the shape envelope: K1 past d = 256, K2 past its shared memory, S1
# past m = 32,768 and k = 1,024 ----

WIDE_K1 = [(torch.int8, 384), (torch.int8, 1024), (torch.int8, 1536), (torch.int8, 80),
           (torch.int8, 100), (torch.bfloat16, 392), (torch.bfloat16, 1536),
           (torch.bfloat16, 100), (torch.float32, 15), (torch.float32, 100),
           (torch.float32, 384), (torch.float32, 1000)]


@pytest.mark.parametrize("mask,shared", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("dtype,d", WIDE_K1)
def test_slab_kernel_wide_rows_match_plain(cuda, dtype, d, mask, shared):
    """The tensor-core body at the widths past d = 256 or off a multiple of
    64 (int8 and bf16; d = 100 in 4-element pieces) and the FFMA body (f32)
    against the plain version on every window, rtol 1e-5 / atol 1e-6 of
    the largest |dot|; one launch."""
    g = torch.Generator(device=cuda).manual_seed(d)
    T, n_pad, q, per_table = 4, 4096, 160, 488
    packed = _slabs(g, (T, n_pad, d), dtype, cuda)
    if shared:
        packed = packed[:1].contiguous()
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    starts[:20] = n_pad - 3
    starts[20:60] = 1000
    sizes = torch.randint(0, 600, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.randn(q, d, generator=g, device=cuda)
    args = (packed, starts, sizes, qv, per_table)
    before = slab_window_dots.launches
    got, a_got = slab_window_dots(*args, mask=mask, shared_slab=shared)
    want, a_want = slab_window_dots_plain(*args, mask=mask, shared_slab=shared)
    torch.cuda.synchronize()
    assert slab_window_dots.launches == before + 1
    assert torch.equal(a_got, a_want)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    scale = float(want[fin].abs().max())
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6 * scale)


def test_slab_kernel_wide_rows_per_row_scale(cuda):
    """packed_scale on int8 rows of d = 768 (the tensor-core body's epilogue
    after twelve d-chunks)."""
    g = torch.Generator(device=cuda).manual_seed(768)
    T, n_pad, q, d = 2, 4096, 100, 768
    packed = _slabs(g, (T, n_pad, d), torch.int8, cuda)
    scale = _row_scales(g, T, n_pad, n_pad - 100, cuda)
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    sizes = torch.randint(0, 600, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, d, generator=g, device=cuda), dim=-1)
    args = (packed, starts, sizes, qv, 488)
    got, _ = slab_window_dots(*args, mask=True, packed_scale=scale)
    want, _ = slab_window_dots_plain(*args, mask=True, packed_scale=scale)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-4 * float(scale.max()))


# ---- K1's tensor-core body on rows that are not whole 16-byte chunks ----

UNALIGNED_K1 = [(torch.int8, 15), (torch.int8, 36), (torch.int8, 100), (torch.int8, 200),
                (torch.int8, 300), (torch.bfloat16, 100), (torch.bfloat16, 300),
                (torch.bfloat16, 15)]


@pytest.mark.parametrize("variant", ["plain", "scale", "shared", "offset"])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("dtype,d", UNALIGNED_K1)
def test_slab_kernel_unaligned_rows_match_plain(cuda, dtype, d, mask, variant):
    """The tensor-core body on rows that are not whole 16-byte chunks (int8
    d % 16 != 0, bf16 d % 8 != 0) against the plain version on every
    window, rtol 1e-5 / atol 1e-6 of the largest |dot|: int8 read by
    4-byte words (d % 4 == 0), bf16 and the other int8 rows (d = 15, or a
    slab that starts one element past an aligned address) by words shifted
    into place; with a per-row
    scale or one shared slab; the last tile cut by the slab's end (T n_pad
    = 16 mod 256); the row after the last query NaN, which no dot may
    read.  One launch."""
    from crypto_rec_tpu_torch.ops.kernels import slabscore as S

    g = torch.Generator(device=cuda).manual_seed(d + 3)
    T, n_pad, q, per_table = 4, 4100, 160, 488
    T = 1 if variant == "shared" else T
    packed = _slabs(g, (T, n_pad, d), dtype, cuda)
    if variant == "offset":
        flat = torch.empty(packed.numel() + 1, dtype=dtype, device=cuda)
        flat[1:] = packed.reshape(-1)
        packed = flat[1:].view(T, n_pad, d)
        assert packed.is_contiguous() and packed.data_ptr() % (4 * packed.element_size())
    scale = _row_scales(g, T, n_pad, n_pad - 100, cuda) if variant == "scale" else None
    nt = 4
    starts = torch.randint(0, n_pad, (q, nt), generator=g, device=cuda, dtype=torch.int32)
    starts[:20] = n_pad - 3
    starts[20:60] = 1000
    sizes = torch.randint(0, 600, (q, nt), generator=g, device=cuda, dtype=torch.int32)
    qbuf = torch.randn(q + 1, d, generator=g, device=cuda)
    qbuf[q] = float("nan")
    qv = qbuf[:q]
    args = (packed, starts, sizes, qv, per_table)
    kw = dict(mask=mask, shared_slab=variant == "shared", packed_scale=scale)
    assert S.tile_shape(dtype, d) == S.TC_SHAPE and not S.rows_aligned(dtype, d)
    before = slab_window_dots.launches
    got, a_got = slab_window_dots(*args, **kw)
    want, a_want = slab_window_dots_plain(*args, **kw)
    torch.cuda.synchronize()
    assert slab_window_dots.launches == before + 1
    assert torch.equal(a_got, a_want)
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    assert not torch.isnan(got).any()
    top = float(want[fin].abs().max())
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6 * top)


def test_slab_kernel_at_the_jester_geometry(cuda):
    """int8 d = 100 at the CF cell's geometry (L = 8 tables of 73,421 users
    and a 4,096-row pad, window 287, unit queries as the cosine path gives
    them), q = 8,192, mask off: within rtol 1e-5 / atol 1e-6 of the largest
    |dot| of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(73421)
    T, n_pad, d, q, per_table = 8, 73_421 + 4096, 100, 8192, 287
    packed = _slabs(g, (T, n_pad, d), torch.int8, cuda)
    starts = torch.randint(0, 73_421, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.nn.functional.normalize(torch.randn(q, d, generator=g, device=cuda), dim=1)
    got, a_got = slab_window_dots(packed, starts, None, qv, per_table, mask=False)
    want, a_want = slab_window_dots_plain(packed, starts, None, qv, per_table, mask=False)
    assert torch.equal(a_got, a_want)
    top = float(want.abs().max())
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * top)


def test_slab_kernel_raises_only_where_jax_or_the_cpu_path_raises(cuda):
    """On the card K1 raises, before any launch, on a window longer than
    the slab and on a scale with shared_slab (as the JAX function does)
    and on mask=True without sizes (as the CPU path does)."""
    packed = torch.zeros(2, 300, 384, dtype=torch.int8, device=cuda)
    starts = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    q = torch.zeros(3, 384, device=cuda)
    before = slab_window_dots.launches
    with pytest.raises(ValueError, match="exceeds"):
        slab_window_dots(packed, starts, starts, q, 400)
    with pytest.raises(ValueError, match="shared_slab"):
        slab_window_dots(packed[:1].contiguous(), starts, starts, q, 100, mask=False,
                         shared_slab=True, packed_scale=torch.ones(1, 300, device=cuda))
    with pytest.raises(ValueError, match="sizes"):
        slab_window_dots(packed, starts, None, q, 100, mask=True)
    assert slab_window_dots.launches == before


@pytest.mark.parametrize("n,d,k,L", [(20_000, 1536, 13, 8), (20_000, 768, 13, 16),
                                     (8_000, 384, 30, 64), (9_000, 128, 13, 80),
                                     (3_000, 960, 1, 200), (50_000, 1536, 13, 1),
                                     (30_000, 1024, 30, 2)])
def test_signproj_kernel_wide_matches_plain(cuda, n, d, k, L):
    """K2 past what the resident projection fit: proj streamed beside x,
    tables in groups on grid.y (L = 64 at k = 30, L = 80, L = 200); ids
    equal to the plain version's away from projections within rounding
    distance of 0; one launch."""
    g = torch.Generator(device=cuda).manual_seed(n + d + L)
    x = torch.randn(n, d, generator=g, device=cuda)
    proj = torch.randn(d, L * k, generator=g, device=cuda)
    before = signproj_bucket_ids.launches
    got = signproj_bucket_ids(x, proj, k, L)
    want = signproj_bucket_ids_plain(x, proj, k, L)
    torch.cuda.synchronize()
    assert signproj_bucket_ids.launches == before + 1
    acc = (x @ proj).abs() <= 1e-5 * x.norm(dim=1, keepdim=True) * proj.norm(dim=0)
    near = acc.view(n, L, k).any(-1)
    assert not ((got != want) & ~near).any()


@pytest.mark.parametrize("m,k", [(40960, 40), (131072, 40), (65537, 1024), (32769, 1),
                                 (40960, 33), (8192, 2048), (2049, 2049), (40960, 1500),
                                 (1025, 1025), (5000, 4096), (131072, 2048)])
def test_window_topk_past_one_launch_equals_plain(cuda, m, k):
    """Rows past MAX_M lanes (two levels) and k past MAX_K (the radix
    select) on tied rows: topk_desc's answer bit for bit, on the card and
    against the CPU; one count a launch (a level of two levels or more, or
    the radix select's one)."""
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import (
        MAX_K, MAX_M, segment_width, window_topk,
    )
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    levels, w = 1, m
    while k <= MAX_K and w > MAX_M:
        levels, w = levels + 1, segment_width(w, k)
    R = max(2, min(256, (1 << 24) // m))
    v = _tied_rows(R, m, torch.Generator().manual_seed(m + k), cuda)
    before = window_topk.launches
    got = window_topk(v, k)
    torch.cuda.synchronize()
    assert window_topk.launches == before + levels
    for want in (topk_desc(v, k), topk_desc(v.cpu(), k)):
        assert torch.equal(got[1].cpu(), want[1].cpu())
        assert torch.equal(got[0].cpu().view(torch.int32), want[0].cpu().view(torch.int32))


@pytest.mark.parametrize("fill", [float("nan"), float("-inf"), -0.0, 2.5])
@pytest.mark.parametrize("m,k", [(40960, 40), (8192, 2048)])
def test_window_topk_past_one_launch_on_constant_rows(cuda, fill, m, k):
    from crypto_rec_tpu_torch.ops.kernels.windowtopk import window_topk
    from crypto_rec_tpu_torch.ops.topk import topk_desc

    v = torch.full((16, m), fill, device=cuda)
    v[::4, m // 2] = float("inf") if fill != fill else float("nan")
    got = window_topk(v, k)
    want = topk_desc(v.cpu(), k)
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[0].cpu().view(torch.int32), want[0].view(torch.int32))


# ---- against the previous build (CRT_PREV_TREE: a checkout of the parent
# commit, e.g. unpacked by `git archive`): at the shapes the previous kernels
# took, the dots and ids are theirs bit for bit ----

_PREV = {}


@pytest.fixture
def prev_lib(cuda):
    """The previous tree's kernels, built by tools/chip_probes/prev_build_ab.py."""
    import importlib.util
    import os
    from pathlib import Path

    root = os.environ.get("CRT_PREV_TREE")
    if not root:
        pytest.skip("set CRT_PREV_TREE to a checkout of the previous commit")
    if "lib" not in _PREV:
        path = Path(__file__).resolve().parents[1] / "tools" / "chip_probes" / "prev_build_ab.py"
        spec = importlib.util.spec_from_file_location("prev_build_ab", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _PREV["lib"] = mod.prev_library(root)
        _PREV["slabscore"] = mod.prev_slabscore(root)
    return _PREV["lib"]


@pytest.fixture
def prev_slabscore(prev_lib):
    """The previous tree's K1 wrapper module: the work list its kernel takes."""
    return _PREV["slabscore"]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("dtype,d", [(torch.int8, 64), (torch.int8, 128), (torch.int8, 192),
                                     (torch.int8, 256), (torch.bfloat16, 128),
                                     (torch.bfloat16, 256), (torch.float32, 16),
                                     (torch.float32, 128), (torch.float32, 256),
                                     (torch.float32, 100), (torch.int8, 1536),
                                     (torch.float32, 384)])
def test_slab_kernel_equals_previous_build(prev_lib, prev_slabscore, dtype, d, mask, scaled):
    """K1 on rows of whole 16-byte chunks and on f32 rows (bodies the
    previous build had too): each build on the work list its own tree cuts
    gives the same dots, bit for bit."""
    from crypto_rec_tpu_torch.ops.kernels import slabscore as S

    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(d + 7)
    T, n_pad, q, per_table = 4, 8192, 300, 488
    packed = _slabs(g, (T, n_pad, d), dtype, cuda)
    starts = torch.randint(0, n_pad, (q, T), generator=g, device=cuda, dtype=torch.int32)
    starts[:80] = 2000
    sizes = torch.randint(0, 600, (q, T), generator=g, device=cuda, dtype=torch.int32)
    qv = torch.randn(q, d, generator=g, device=cuda)
    scale = _row_scales(g, T, n_pad, n_pad - 100, cuda) if scaled else None
    win, _, row0, head, size = S.card_geometry(packed, starts, sizes, qv, per_table, mask,
                                               False, scale)
    new = torch.empty(q, T, win, device=cuda)
    old = torch.full_like(new, float("nan"))
    S.tile_launch(packed, qv, S.tile_plan(packed, row0, head, size, win), new, mask, scale)
    meta, item_tile, item_lo, item_cnt = prev_slabscore.tile_plan(packed, row0, head, size,
                                                                  win)
    rt, m = prev_slabscore.tile_shape(packed.dtype, d)
    err = prev_lib.crt_slab_tile_dots(
        packed.data_ptr(), qv.data_ptr(), None if scale is None else scale.data_ptr(),
        meta.data_ptr(), item_tile.data_ptr(), item_lo.data_ptr(), item_cnt.data_ptr(),
        old.data_ptr(), item_tile.numel(), meta.shape[1], T, win, d, T * n_pad, int(mask),
        S._DTYPE_CODE[dtype], rt, m, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(new.view(torch.int32), old.view(torch.int32))


@pytest.mark.parametrize("n,d,k,L", [(100_000, 128, 13, 8), (100_000, 128, 13, 1),
                                     (20_000, 16, 4, 5), (300, 32, 5, 3),
                                     (50_000, 256, 13, 8), (50_000, 128, 30, 2),
                                     (50_000, 64, 7, 16), (40_000, 128, 10, 6)])
def test_signproj_kernel_equals_previous_build(prev_lib, n, d, k, L):
    """K2 at shapes the previous build took: the same ids, bit for bit."""
    cuda = torch.device("cuda")
    g = torch.Generator(device=cuda).manual_seed(n + k)
    x = torch.randn(n, d, generator=g, device=cuda)
    proj = torch.randn(d, L * k, generator=g, device=cuda)
    new = signproj_bucket_ids(x, proj, k, L)
    old = torch.empty_like(new)
    err = prev_lib.crt_signproj(x.data_ptr(), proj.data_ptr(), old.data_ptr(), n, d, k, L,
                                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(new, old)


def _traced_paths(cuda, d=128):
    """An int8 cosine index of 100,000 rows on the card and its two served
    paths (CF: retrieve_topk_pallas + recommend_topk_retrieved; retrieval:
    retrieve_topk with the exact rerank) as one request of 4,096 rows."""
    from crypto_rec_tpu_torch.models.lsh import index as lsh_index
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
    from crypto_rec_tpu_torch.models.rec import engine

    g = torch.Generator(device=cuda).manual_seed(17)
    n, k, L = 100_000, 9, 8
    x = torch.randn(n, d, generator=g, device=cuda)
    proj = torch.randn(d, L * k, generator=g, device=cuda)
    idx = lsh_index.build_index(None, x, "cosine", k, L, family=CosineLsh(proj, k, L))
    idx = lsh_index.pack_index(idx, x, dtype=torch.int8, pad=4096)
    users = engine.RatingSet(ratings=x, known=x > 0.5, mean=x.mean(1))
    rows = torch.randperm(n, generator=g, device=cuda)[:4096]

    def request():
        q = x[rows]
        s, nb = lsh_index.retrieve_topk_pallas(idx, q, x, top_k=20, per_table=390,
                                               int8_rerank=False, stage1_per_table=12)
        qs = engine.RatingSet(ratings=q, known=users.known[rows], mean=users.mean[rows])
        rec = engine.recommend_topk_retrieved(qs, users, s, nb, 5)
        return (s, nb, rec.top_n, *lsh_index.retrieve_topk(idx, q, x, 10, per_table=390))

    return request


def _cuda_profile():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def test_tracing_records_stream_ms(cuda):
    """Traced, every span of both paths has a device-stream time, K1's
    stream ms are at least the device time of its kernel in the same calls,
    and the outputs equal the untraced ones; both K1 calls are tensor-core
    launches ("k1.tc_calls"); "cf.neighbors" counts the CF request's
    neighbours, and the prediction kernel ran."""
    from crypto_rec_tpu_torch.utils import timing

    request = _traced_paths(cuda)
    off = request()
    torch.cuda.synchronize()
    timing.reset()
    with _cuda_profile() as prof:
        on = request()
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    snap = timing.snapshot()
    spans = snap["spans"]
    for path in ("retrieve", "retrieve/hash", "retrieve/windows", "retrieve/k1.plan",
                 "retrieve/k1", "retrieve/s1", "retrieve/dedup", "retrieve/rerank",
                 "cf", "cf/cf.predict", "cf/cf.topn"):
        assert spans[path]["stream_ms"] > 0, path
    assert spans["retrieve"]["stream_ms"] > spans["retrieve/k1"]["stream_ms"]
    assert snap["launches"]["slab_window_dots"] == 2 and snap["launches"]["window_topk"] >= 2
    k1_device_ms = sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
                       if e.device_type() == torch.autograd.DeviceType.CUDA
                       and "tile_dots" in e.name()) / 1e6
    assert k1_device_ms > 0
    # CUDA events resolve to about half a microsecond at each end
    assert spans["retrieve/k1"]["stream_ms"] >= k1_device_ms - 2 * 2e-3
    lanes, rows = snap["counters"]["k1.lanes"], snap["counters"]["k1.window_rows"]
    assert lanes == 2 * 4096 * 8 * 512 and 0 < rows <= lanes
    assert snap["counters"]["k1.tc_calls"] == 2
    # the CF prediction ran as its kernel, over the slots that hold a neighbour
    assert snap["counters"]["cf.neighbors"] == int((on[1] >= 0).sum())
    assert any("predict_rows" in e.name() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA)


@pytest.mark.parametrize("d", [100, 15])
def test_tracing_counts_tensor_core_launches(cuda, d):
    """At the recommender's 100 items and its 15 coins (int8 rows that are
    not 16-byte aligned) every K1 launch of the served paths is a
    tensor-core one ("k1.tc_calls" equals K1's launches), no FFMA kernel
    runs, and untraced the counter records nothing."""
    from crypto_rec_tpu_torch.utils import timing

    request = _traced_paths(cuda, d)
    timing.reset()
    request()
    torch.cuda.synchronize()
    assert timing.snapshot()["counters"] == {}
    with _cuda_profile() as prof:
        request()
        torch.cuda.synchronize()
    snap = timing.snapshot()
    assert snap["counters"]["k1.tc_calls"] == snap["launches"]["slab_window_dots"] >= 1
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert any("tile_dots_mma" in n for n in names)
    assert not any("tile_dots_ffma" in n for n in names)


def test_tracing_adds_no_synchronise(cuda):
    """A traced request makes no more synchronising calls than an untraced
    one (torch's sync debug mode warns at each)."""
    import warnings

    from crypto_rec_tpu_torch.utils import timing

    request = _traced_paths(cuda)
    request()
    torch.cuda.synchronize()

    def syncs():
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                request()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sum("synchroniz" in str(x.message) for x in w)

    untraced = syncs()
    timing.reset()
    with _cuda_profile():
        traced = syncs()
    assert timing.snapshot()["spans"]["retrieve"]["calls"] == 2
    assert traced <= untraced
