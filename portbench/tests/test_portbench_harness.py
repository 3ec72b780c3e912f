"""Whole runs on the CPU at a tiny size, past the look for a card: sound,
with faults planted in the timed path, with the control in the program's
place, and with a mix and a metric added as new files."""

import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.traffic import Traffic, request_size

CPU = torch.device("cpu")
SEED = 2**31 + 4321
CF, ANN = "cf-jester-73k-100.bulk", "ann-dbpedia-1m-1536.batch"
CELLS = (CF, ANN)


def run(root, workload, trace=False):
    return harness.run_cell(root, workload, SEED, 0.3, trace, CPU, 0.0)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(tiny_root, workload, trace):
    out = run(tiny_root, workload, trace)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = harness.cell_of(tiny_root, bench, workload)
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    checks = out["checks"]
    # recall at this tiny size is no measure; every other number holds
    assert all(c["value"] <= c["limit"] for k, c in checks.items() if k != "recall_at_10")
    assert list(out)[-1] == "checks" and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) <= names
    if not trace:
        assert set(out["metrics"]) == names


def _altered_ids(fn):
    def wrapped(*args, **kwargs):
        s, ids = fn(*args, **kwargs)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % 6000       # each answer's best row replaced
        return s, ids
    return wrapped


@pytest.mark.parametrize("workload,fn", [(CF, "retrieve_topk_pallas"), (ANN, "retrieve_topk")])
def test_an_answer_altered_where_it_is_produced_fails(tiny_root, monkeypatch, workload, fn):
    from crypto_rec_tpu_torch.models.lsh import index as lsh_index

    monkeypatch.setattr(lsh_index, fn, _altered_ids(getattr(lsh_index, fn)))
    out = run(tiny_root, workload)
    assert out["correct"] is False
    assert out["checks"]["score_err"]["value"] > out["checks"]["score_err"]["limit"]


def test_a_corpus_bucket_id_altered_where_it_is_produced_fails(tiny_root, monkeypatch):
    """One corpus row's ids moved to another bucket in every table (its
    first hyperplane's bit flipped): the reference hashes the row itself, so
    the program's state is judged against ids of its own making."""
    from crypto_rec_tpu_torch.models.lsh import index as lsh_index

    real = lsh_index.pack_index

    def altered(idx, *args, **kwargs):
        out = real(idx, *args, **kwargs)
        k = 5                                             # conftest's TINY
        out.bucket_ids[7] = out.bucket_ids[7] ^ (1 << (k - 1))
        return out

    monkeypatch.setattr(lsh_index, "pack_index", altered)
    out = run(tiny_root, CF)
    assert out["correct"] is False
    assert out["checks"]["hash_margin"]["value"] > out["checks"]["hash_margin"]["limit"]


def test_a_coin_altered_where_it_is_produced_fails(tiny_root, monkeypatch):
    from crypto_rec_tpu_torch.models.rec import engine

    real = engine.recommend_topk_retrieved

    def altered(*args, **kwargs):
        rec = real(*args, **kwargs)
        rec.top_n = torch.flip(rec.top_n, dims=[1])      # the worst of the five first
        return rec

    monkeypatch.setattr(engine, "recommend_topk_retrieved", altered)
    out = run(tiny_root, CF)
    assert out["correct"] is False
    assert out["checks"]["cf_err"]["value"] > out["checks"]["cf_err"]["limit"]


def test_half_the_batch_left_out_fails(tiny_root, monkeypatch):
    """Only the first half of each request retrieved; the rest answered
    with no neighbours."""
    from crypto_rec_tpu_torch.models.lsh import index as lsh_index

    real = lsh_index.retrieve_topk_pallas

    def half(index, queries, *args, **kwargs):
        h = queries.shape[0] // 2
        s, ids = real(index, queries[:h], *args, **kwargs)
        pad_s = torch.full((queries.shape[0] - h, s.shape[1]), float("-inf"))
        return torch.cat([s, pad_s]), torch.cat([ids, torch.full(pad_s.shape, -1,
                                                                  dtype=ids.dtype)])

    monkeypatch.setattr(lsh_index, "retrieve_topk_pallas", half)
    out = run(tiny_root, CF)
    assert out["correct"] is False
    assert out["checks"]["rank_gap"]["value"] > out["checks"]["rank_gap"]["limit"]


def test_a_lost_table_fails(tiny_root, monkeypatch):
    """The retrieval's state left as it was built for one table less: the
    windows of the last table are never read."""
    from crypto_rec_tpu_torch.ops.kernels import slabscore

    real = slabscore.slab_window_dots

    def lost(packed, starts, sizes, queries, per_table, **kw):
        dots, a0 = real(packed, starts, sizes, queries, per_table, **kw)
        dots[:, -1] = float("-inf")
        return dots, a0

    monkeypatch.setattr(slabscore, "slab_window_dots", lost)
    out = run(tiny_root, CF)
    assert out["correct"] is False
    assert out["checks"]["rank_gap"]["value"] > out["checks"]["rank_gap"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_every_inexact_number(tiny_root, workload):
    """The reference in the program's place, its products in TF32: each
    number with a limit between the program's readings and the control's
    reads above it."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    cell = harness.cell_of(tiny_root, bench, workload)
    mod = harness.load_module(tiny_root / "portbench" / "paths" / "cosine_lsh.py", "p")
    path = mod.Path(cell.config, SEED, CPU)
    path.prepare()
    path.use(path.build())
    sample = harness.Reservoir(4, SEED)
    traffic = Traffic(cell.mix, path.pool, SEED)
    harness.window(path, traffic, 0.2, sample, CPU)
    state, ans = path.control(sample.items, SEED)
    got = path.numbers(state, ans)
    limits = cell.config["checks"]
    for name in ("hash_margin", "score_err", "rank_gap") + (("cf_err",) if path.cf else ()):
        assert got[name] > limits[name], name


def test_a_new_mix_and_metric_are_new_files(tiny_root):
    """A later change adds a cell with its own mix and a per-layer metric
    with its own reader, editing no file that is there."""
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*") if p.is_file()}
    mix = {"loop": "closed", "size": {"kind": "fixed", "value": 32}, "trace_requests": 2,
           "judge_requests": 2}
    (tiny_root / "portbench" / "mixes" / "tiny_burst.json").write_text(json.dumps(mix))
    (tiny_root / "portbench" / "metrics" / "requests_traced.py").write_text(
        "def read(rec):\n    return None if rec.trace is None else len(rec.trace.requests)\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cf-jester-73k-100.tiny_burst",
                               "config": "cf-jester-73k-100",
                               "traffic": "tiny_burst", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "users_per_s",
                               "workloads": ["cf-jester-73k-100.tiny_burst"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run(tiny_root, "cf-jester-73k-100.tiny_burst", trace=True)
    assert out["metrics"]["requests_traced"]["value"] == 2
    assert all(p.read_bytes() == b for p, b in before.items())


def test_traffic_sends_the_same_work_for_every_seed():
    """Every request of a seed is a fresh draw of distinct pool rows, the
    same sequence again for the same seed; a fixed size cuts each draw."""
    for size, n in (({"kind": "pool"}, 512), ({"kind": "fixed", "value": 100}, 100)):
        mix = {"loop": "closed", "size": size}
        assert request_size(size, 512) == n
        for seed in (1, 2**31 + 5):
            it = iter(Traffic(mix, 512, seed))
            a, b = next(it), next(it)
            assert len(a) == len(b) == n and len(np.unique(a)) == n
            assert not np.array_equal(a, b)
            assert np.array_equal(a, next(iter(Traffic(mix, 512, seed))))
    with pytest.raises(ValueError):
        request_size({"kind": "fixed", "value": 513}, 512)
