"""The readers of the program's own spans and counters: on a synthetic
run with a filled registry, without a trace, and on both cells traced on
the CPU."""

import numpy as np
import pytest

from crypto_rec_tpu_torch.utils import timing
from portbench import harness

REPO = harness.Path(__file__).resolve().parents[2]
MS = 1_000_000     # ns
SPAN_METRICS = ("retrieve_stream_ms.cf", "retrieve_stream_ms.ann", "glue_stream_ms.cf",
                "glue_stream_ms.ann", "cf_stream_us_per_user", "retrieve_idle_ms.cf",
                "retrieve_idle_ms.ann", "cf_idle_ms", "k1_lane_use.cf", "k1_lane_use.ann",
                "pack_stream_ms.build")


def reader(name):
    return harness.metric_reader(REPO, name)


class _Event:
    """A stand-in for a CUDA event: a time in ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def _record(path, ms0, ms1):
    r = timing._Record()
    r.path, r.top, r.device = path, 0, None
    r.t0, r.t1 = int(ms0 * MS), int(ms1 * MS)
    r.ev0, r.ev1 = _Event(ms0), _Event(ms1)
    return r


@pytest.fixture
def registry():
    """Two requests' spans (retrieve 6 ms, of which k1 3 and s1 1; cf 2 ms)
    and a build's pack of 40 ms, with K1's counters."""
    timing.reset()
    t = timing.TRACER
    for base in (0.0, 10.0):
        t.records += [_record("retrieve/k1", base + 1, base + 4),
                      _record("retrieve/s1", base + 4, base + 5),
                      _record("retrieve", base, base + 6),
                      _record("cf", base + 6, base + 8)]
    t.records.append(_record("pack", 100.0, 140.0))
    t.counters.update({"k1.lanes": 4096, "k1.window_rows": 1024})
    yield t
    timing.reset()


def record(trace=True):
    rec = harness.Record(setup_s=1.0, window_s=0.02, requests=[], build_s=[0.1])
    if trace:
        # device busy [1, 3) and [5, 12) of [0, 20) ms; host retrieve [0, 6), cf [6, 9),
        # [10, 16), [16, 19): gaps [0, 1) mid 0.5 retrieve, [3, 5) mid 4 retrieve,
        # [12, 20) mid 16 cf
        dev = [("void tile_dots_ffma<32>(Args)", 1 * MS, 3 * MS),
               ("at::native::elementwise_kernel", 5 * MS, 12 * MS)]
        host = [("retrieve", 0, 6 * MS), ("cf", 6 * MS, 9 * MS),
                ("retrieve", 10 * MS, 16 * MS), ("cf", 16 * MS, 19 * MS),
                ("aten::index", 2 * MS, 5 * MS)]
        rec.trace = harness.Trace((0, 20 * MS), dev, host, [np.arange(100), np.arange(300)],
                                  [], [], [], {}, None)
    return rec


def test_span_readers_on_a_filled_registry(registry):
    rec = record()
    for cell in ("cf", "ann"):
        assert reader(f"retrieve_stream_ms.{cell}").read(rec) == pytest.approx(6.0)
        assert reader(f"glue_stream_ms.{cell}").read(rec) == pytest.approx(2.0)
        assert reader(f"retrieve_idle_ms.{cell}").read(rec) == pytest.approx(1.5)
        assert reader(f"k1_lane_use.{cell}").read(rec) == pytest.approx(25.0)
    assert reader("cf_stream_us_per_user").read(rec) == pytest.approx(1e3 * 4.0 / 400)
    assert reader("cf_idle_ms").read(rec) == pytest.approx(4.0)
    assert reader("pack_stream_ms.build").read(rec) == pytest.approx(40.0)


def test_span_readers_return_nothing_without_a_trace(registry):
    for name in SPAN_METRICS:
        assert reader(name).read(record(trace=False)) is None, name


def test_span_readers_return_nothing_without_the_program_spans():
    """An empty registry (a program without spans, or a run that recorded
    none) and a trace without the host ranges read nothing."""
    timing.reset()
    rec = record()
    rec.trace.host = [h for h in rec.trace.host if h[0] not in ("retrieve", "cf")]
    for name in SPAN_METRICS:
        assert reader(name).read(rec) is None, name


def test_span_readers_of_an_older_program(registry, monkeypatch):
    """A program with no `snapshot` in its timing module reads nothing."""
    monkeypatch.delattr(timing, "snapshot")
    rec = record()
    rec.trace.host = []
    for name in SPAN_METRICS:
        assert reader(name).read(rec) is None, name


@pytest.mark.parametrize("workload", ["cf-jester-73k-100.bulk", "ann-dbpedia-1m-1536.batch"])
def test_both_cells_traced_on_the_cpu(tiny_root, workload):
    """Traced on the CPU, K1's lane use reads a number in (0, 100]; the CPU
    has no CUDA events and no device ops, so the stream and idle readers
    read nothing, and fail on nothing."""
    timing.reset()
    out = harness.run_cell(tiny_root, workload, 4_000_000_017, 0.3, True,
                           harness.torch.device("cpu"), 0.0)
    timing.reset()
    # recall at this tiny size is no measure; every other number holds
    assert all(c["value"] <= c["limit"] for k, c in out["checks"].items()
               if k != "recall_at_10")
    metrics = out["metrics"]
    cell = workload.split("-")[0]
    assert 0 < metrics[f"k1_lane_use.{cell}"]["value"] <= 100
    for name in SPAN_METRICS:
        if not name.startswith("k1_lane_use"):
            assert name not in metrics, name
