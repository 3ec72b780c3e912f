"""The benchmark's frozen bound arithmetic."""

import pytest
import torch

from portbench import bounds


def test_k2_bound_at_the_cf_point_from_shapes_alone():
    # 2 n d L k / 67 TFLOP/s at [2,000,000 x 128], L = 8, k = 13: 0.795 ms
    b = bounds.k2_call(2_000_000, 128, 13, 8)
    assert b["bound_by"] == "operations"
    assert b["seconds"] * 1e3 == pytest.approx(2 * 2e6 * 128 * 104 / 67e12 * 1e3)
    assert round(b["seconds"] * 1e3, 3) == 0.795


def test_covered_rows_counts_shared_blocks_once():
    row0 = torch.tensor([[0, 16], [640, 2000]])
    # [0, 64) and [16, 80) -> blocks 0..2 (96 rows); [640, 704) -> 2 blocks;
    # [2000, 2064) -> blocks 62..64, the last cut at n_rows = 2050
    assert bounds.covered_rows(row0, 64, 2050) == 96 + 64 + 64 + 2


def test_k1_and_s1_bounds_are_the_ports():
    from crypto_rec_tpu_torch.ops.kernels import bounds as port
    from crypto_rec_tpu_torch.ops.kernels.slabscore import _geometry

    g = torch.Generator().manual_seed(3)
    packed = torch.zeros(4, 8192, 128, dtype=torch.int8)
    starts = torch.randint(0, 7000, (64, 4), generator=g)
    queries = torch.randn(64, 128, generator=g)
    want = port.k1_call(packed, starts, None, queries, 488)
    win, _, row0, _, _ = _geometry(packed, starts, None, 488, False)
    got = bounds.k1_call(row0, win, 4 * 8192, 128, 1)
    assert got["bytes"] == want["bytes"] and got["flops"] == want["flops"]
    assert got["seconds"] * 1e3 == pytest.approx(want["bound_ms"])
    assert bounds.s1_call(64 * 4, 640, 12)["seconds"] * 1e3 == pytest.approx(
        port.s1_call(64 * 4, 640, 12)["bound_ms"])


def test_retrieve_bound_counts_the_least_work():
    row0 = torch.tensor([[0, 1024]])
    b = bounds.retrieve_call(row0, 640, 10_000, 128, 1, 20)
    assert b["bytes"] == (640 + 640) * 128 + 4 * 128 + 8 * 20
    assert b["flops"] == 2 * 2 * 640 * 128
