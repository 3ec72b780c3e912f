"""The port's spans and counters (`crypto_rec_tpu_torch/utils/timing.py`).

Spans and counters record only while a torch.profiler records: off, a
request enters no `record_function` and records no event; on, the stage
names appear in the profiler's events, each inside its parent's range,
and the outputs are the same bit for bit.
"""

import json

import pytest
import torch

from crypto_rec_tpu_torch import main as port_main
from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset
from crypto_rec_tpu_torch.models.lsh import index as lsh_index
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.rec import engine
from crypto_rec_tpu_torch.utils import timing
from crypto_rec_tpu_torch.utils.timing import PhaseTimer

N, D, K, L, PER_TABLE = 3000, 128, 5, 4, 64
RETRIEVAL = {"retrieve", "hash", "windows", "k1", "s1", "dedup", "rerank"}
STAGES = RETRIEVAL | {"build", "csr", "pack", "cf", "cf.predict", "cf.topn"}


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def corpus():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(N, D, generator=g)
    return x, torch.randn(D, L * K, generator=g)


def build(x, proj, dtype=torch.int8):
    idx = lsh_index.build_index(None, x, "cosine", K, L, family=CosineLsh(proj, K, L))
    return lsh_index.pack_index(idx, x, dtype=dtype, pad=512)


def requests(x, proj):
    """The benchmark's two served paths: an index build, retrieve_topk, and
    retrieve_topk_pallas followed by recommend_topk_retrieved."""
    idx = build(x, proj)
    q = x[:96]
    s, nb = lsh_index.retrieve_topk(idx, q, x, 10, per_table=PER_TABLE)
    s2, nb2 = lsh_index.retrieve_topk_pallas(idx, q, x, top_k=20, per_table=PER_TABLE,
                                            int8_rerank=False, stage1_per_table=12)
    users = engine.RatingSet(ratings=x, known=x > 0.5, mean=x.mean(1))
    qs = engine.RatingSet(ratings=q, known=q > 0.5, mean=q.mean(1))
    rec = engine.recommend_topk_retrieved(qs, users, s2, nb2, 5)
    return s, nb, s2, nb2, rec.predicted, rec.top_n, rec.sims


def _refuse(*a, **k):
    raise AssertionError("entered while no profiler records")


def test_off_records_nothing_and_enters_no_record_function(corpus, monkeypatch):
    timing.reset()
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    assert not timing.tracing()
    requests(*corpus)
    with timing.span("x"):
        timing.count("n", 3)
        timing.count("t", torch.tensor(4))
    snap = timing.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {} and snap["top_level"] == 0


def test_on_spans_nest_inside_their_parents(corpus):
    timing.reset()
    with _profile() as prof:
        requests(*corpus)
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in STAGES]
    assert {e[0] for e in events} == STAGES
    snap = timing.snapshot()
    # each recorded span lies inside its parent's range (same host clock)
    tops = {"retrieve": [e for e in events if e[0] == "retrieve"],
            "cf": [e for e in events if e[0] == "cf"],
            "build": [e for e in events if e[0] == "build"]}
    for path in snap["spans"]:
        parts = path.split("/")
        if len(parts) < 2:
            continue
        for name, s, e in (ev for ev in events if ev[0] == parts[-1]):
            if any(ps <= s and e <= pe for _, ps, pe in tops[parts[0]]):
                break
        else:
            pytest.fail(f"{path}: no range inside a {parts[0]} range")
    # retrieve_topk calls retrieve_topk_pallas: the inner "retrieve" is
    # not recorded again, so two calls make two ranges
    assert len(tops["retrieve"]) == 2 and snap["spans"]["retrieve"]["calls"] == 2
    assert snap["spans"]["retrieve/rerank"]["calls"] == 1
    assert set(snap["spans"]) >= {"build/hash", "build/csr", "pack", "retrieve/hash",
                                  "retrieve/windows", "retrieve/k1", "retrieve/s1",
                                  "retrieve/dedup", "cf/cf.predict", "cf/cf.topn"}
    assert snap["top_level"] == 5          # build, pack, two retrievals, cf
    for e in snap["spans"].values():
        assert e["calls"] >= 1 and e["host_ms"] > 0 and e["stream_ms"] is None
    # the lanes K1 scored in the two calls, and those in the query's window
    win = 128
    assert snap["counters"]["k1.lanes"] == 2 * 96 * L * win
    assert 0 < snap["counters"]["k1.window_rows"] <= 2 * 96 * L * PER_TABLE


def test_k1_counts_its_tensor_core_launches(monkeypatch):
    """`tile_launch` counts "k1.tc_calls" once a launch of the tensor-core
    body (int8 and bf16 slabs at any d, the rows of 100 items included)
    and not for the FFMA body (f32), only while a profiler records.  The
    library and the stream are stubbed: the count needs no card."""
    import contextlib
    import types

    from crypto_rec_tpu_torch.ops.kernels import slabscore

    launched = []
    lib = types.SimpleNamespace(crt_slab_tile_dots=lambda *a: launched.append(a[-3:-1]) or 0)
    monkeypatch.setattr(slabscore.build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def launch(dtype, d):
        packed = torch.zeros(2, 512, d, dtype=dtype)
        starts = torch.zeros(4, 2, dtype=torch.int32)
        qv = torch.zeros(4, d)
        win, _, row0, head, size = slabscore.card_geometry(packed, starts, None, qv, 100,
                                                           False, False)
        plan = slabscore.tile_plan(packed, row0, head, size, win)
        slabscore.tile_launch(packed, qv, plan, torch.empty(4, 2, win), False)

    cases = [(torch.int8, 100), (torch.bfloat16, 100), (torch.int8, 128), (torch.float32, 100)]
    timing.reset()
    for c in cases:
        launch(*c)
    assert timing.snapshot()["counters"] == {}
    with _profile():
        for c in cases:
            launch(*c)
    assert timing.snapshot()["counters"] == {"k1.tc_calls": 3}
    # each launch took the body its count says: (rt, m) as the kernel checks them
    assert launched == [(256, 32)] * 3 + [(32, 32)] + [(256, 32)] * 3 + [(32, 32)]


def test_counters_sum_ints_and_tensors():
    timing.reset()
    with _profile():
        timing.count("a", 2)
        timing.count("a", torch.tensor(5, dtype=torch.int64))
        timing.count("a", 1)
        timing.count("b", torch.tensor(3))
    assert timing.snapshot()["counters"] == {"a": 8, "b": 3}


def test_same_name_reentry_records_once():
    timing.reset()
    with _profile() as prof:
        with timing.span("outer"):
            with timing.span("outer"):
                with timing.span("inner"):
                    pass
    snap = timing.snapshot()
    assert {p: e["calls"] for p, e in snap["spans"].items()} == {"outer": 1, "outer/inner": 1}
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("outer") == 1 and names.count("inner") == 1


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16, torch.float32])
def test_outputs_equal_with_tracing_on_and_off(corpus, dtype):
    x, proj = corpus
    idx = build(x, proj, dtype)
    q = x[100:164]

    def run():
        a = lsh_index.retrieve_topk(idx, q, x, 10, per_table=PER_TABLE)
        b = lsh_index.retrieve_topk_pallas(idx, q, x, top_k=20, per_table=PER_TABLE,
                                           stage1_per_table=12)
        users = engine.RatingSet(ratings=x, known=x > 0.5, mean=x.mean(1))
        qs = engine.RatingSet(ratings=q, known=q > 0.5, mean=q.mean(1))
        r = engine.recommend_topk_retrieved(qs, users, *b, 5)
        return (*a, *b, r.predicted, r.top_n, r.sims, r.neighbor_idx, r.has_neighbors)

    off = run()
    with _profile():
        on = run()
    assert all(torch.equal(u, v) for u, v in zip(off, on))


def test_phase_timer_phases_time_and_are_spans():
    timing.reset()
    t = PhaseTimer(torch.device("cpu"))
    with t.phase("untraced"):
        torch.ones(8) + 1
    with _profile() as prof:
        with t.phase("traced"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.phases["untraced"] > 0 and t.phases["traced"] > 0
    assert "traced" in {e.name() for e in prof.profiler.kineto_results.events()}
    assert list(timing.snapshot()["spans"]) == ["traced"]


def test_main_profile_writes_spans(tmp_path, capsys):
    """main --profile DIR writes the snapshot beside the trace: each phase a
    top-level span."""
    timing.reset()
    tweets, conf = write_synthetic_dataset(str(tmp_path), seed=5)
    prof_dir = tmp_path / "prof"
    assert port_main.main(["-d", tweets, "-o", str(tmp_path / "out.txt"), "-c", conf,
                           "--device", "cpu", "--profile", str(prof_dir)]) == 0
    phases = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["phase_ms"]
    snap = json.loads((prof_dir / "spans.json").read_text())
    assert (prof_dir / "trace.json").exists()
    assert set(phases) <= set(snap["spans"])
    assert all(snap["spans"][p]["calls"] == 1 for p in phases)
    assert set(snap) == {"spans", "counters", "launches", "top_level"}
