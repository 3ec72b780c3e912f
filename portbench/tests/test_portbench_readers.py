"""Each metric reader on synthetic runs and profiler events."""

import json

import numpy as np
import pytest
import torch

from portbench import bounds, harness

REPO = harness.Path(__file__).resolve().parents[2]
SHAPE = dict(d=128, L=2, k=13, n=1000, win=640, n_pad=5120, slab_bytes=1, kk=12, top_k=20)
MS = 1_000_000     # ns


def reader(name):
    return harness.metric_reader(REPO, name)


def row0_of(ids):
    return torch.tensor([[0, 5120]] * len(ids))


def record(trace=True):
    # three requests of 100, 200 and 300 rows at 10 ms each, 2 ms apart
    reqs = [(0.000, 0.001, 0.010, 100), (0.012, 0.013, 0.022, 200), (0.024, 0.025, 0.034, 300)]
    rec = harness.Record(setup_s=12.5, window_s=0.034, requests=reqs, build_s=[0.1, 0.3])
    if trace:
        dev = [("void tile_dots_mma<256>(Args)", 1 * MS, 5 * MS),
               ("void s1::warp_rows<8>(float const*)", 4 * MS, 6 * MS),
               ("Memcpy HtoD (Pageable -> Device)", 8 * MS, 9 * MS)]
        host = [("aten::index", 5 * MS, 9 * MS), ("cudaLaunchKernel", 6 * MS, 7 * MS)]
        spans = [(0.0, 0.001, 0.004, 0.0045, 0.006, 100), (1.0, 1.002, 1.006, 1.007, 1.010, 300)]
        build = [("void k2::signproj_kernel<13, 1, false>(float const*)", 0, 2 * MS)]
        rec.trace = harness.Trace((0, 10 * MS), dev, host, [np.arange(4)], spans,
                                  [np.arange(100), np.arange(300)], build, SHAPE, row0_of)
    return rec


def test_end_to_end_readers():
    rec = record(trace=False)
    assert reader("users_per_s").read(rec) == pytest.approx(600 / 0.034)
    assert reader("queries_per_s").read(rec) == pytest.approx(600 / 0.034)
    assert reader("request_p95_ms").read(rec) == pytest.approx(10.0)
    assert reader("index_build_s").read(rec) == pytest.approx(0.2)
    assert reader("setup_s").read(rec) == 12.5


def test_per_layer_readers_on_synthetic_events():
    rec = record()
    # busy: [1, 6) and [8, 9) of [0, 10) ms
    for name in ("device_idle_pct.cf", "device_idle_pct.ann"):
        assert reader(name).read(rec) == pytest.approx(40.0)
    for name in ("host_enqueue_ms.cf", "host_enqueue_ms.ann"):
        assert reader(name).read(rec) == pytest.approx(1e3 * (0.0015 + 0.003) / 2)
    assert reader("cf_us_per_user").read(rec) == pytest.approx(1e6 * (0.002 + 0.004) / 400)
    k1 = bounds.k1_call(row0_of(range(4)), 640, 2 * 5120, 128, 1)["seconds"]
    for name in ("k1_roofline.cf", "k1_roofline.ann"):
        assert reader(name).read(rec) == pytest.approx(100 * k1 / 0.004)
    s1 = bounds.s1_call(8, 640, 12)["seconds"]
    for name in ("s1_roofline.cf", "s1_roofline.ann"):
        assert reader(name).read(rec) == pytest.approx(100 * s1 / 0.002)
    least = sum(bounds.retrieve_call(row0_of(range(q)), 640, 2 * 5120, 128, 1, 20)["seconds"]
                for q in (100, 300))
    for name in ("retrieve_roofline.cf", "retrieve_roofline.ann"):
        assert reader(name).read(rec) == pytest.approx(100 * least / (0.004 + 0.006))
    k2 = bounds.k2_call(1000, 128, 13, 2)["seconds"]
    assert reader("k2_roofline.build").read(rec) == pytest.approx(100 * k2 / 0.002)


def test_a_reader_with_nothing_to_read_returns_nothing():
    rec = record(trace=False)
    for name in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]:
        assert reader(name["name"]).read(rec) is None
    rec = record()
    rec.trace.device = [d for d in rec.trace.device if "tile_dots" not in d[0]]
    assert reader("k1_roofline.cf").read(rec) is None


def test_breakdown_names_ops_and_gaps():
    b = harness.breakdown(record().trace)
    assert [k for k, _ in b["device_ops"]] == ["tile_dots_mma", "s1::warp_rows", "Memcpy HtoD"]
    assert b["device_ops"][0][1] == pytest.approx(0.004)
    gaps = dict(b["idle_gaps"])
    # [0, 1) no host op; [6, 8) mid 7: aten::index; [9, 10) mid 9.5: no host op
    assert gaps == pytest.approx({"no host op": 0.002, "aten::index": 0.002})
    assert harness.union_ns([(0, 5), (3, 8), (10, 12)], 1, 11) == 8


def test_every_metric_has_its_reader():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reader(m["name"]).read), m["name"]


def test_a_reader_is_found_by_its_name_then_its_base_name(tmp_path):
    metrics = tmp_path / "portbench" / "metrics"
    metrics.mkdir(parents=True)
    (metrics / "k1_roofline.py").write_text("def read(rec):\n    return 1.0\n")
    (metrics / "k1_roofline.skewed.py").write_text("def read(rec):\n    return 2.0\n")
    assert harness.metric_reader(tmp_path, "k1_roofline.ann").read(None) == 1.0
    assert harness.metric_reader(tmp_path, "k1_roofline.ann.x").read(None) == 1.0
    assert harness.metric_reader(tmp_path, "k1_roofline.skewed").read(None) == 2.0
    with pytest.raises(FileNotFoundError):
        harness.metric_reader(tmp_path, "s1_roofline.ann")
