"""The benchmark harness: one cell, one seed, one run.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration's file, its mix in `mixes/<traffic>.json`, the code that
drives its path in `paths/<path>.py` (named by the configuration), and a
reader for each metric in `metrics/<metric>.py`, or, where that file is
not there, the reader of the name with its last `.suffix` cut off
(`k1_roofline.ann` is read by `metrics/k1_roofline.py`).  A new
configuration, mix or metric is a new file; no file here changes for it.

A run: set-up (the kernel library, data and weights from the seed, the
index built and timed, every request size of the mix warmed up), then a
closed-loop window of `seconds` (or, with trace, a profiled stretch and a
stretch of synchronised spans), then the check: the program's state and a
seeded sample of the window's answers against the plain reference.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.traffic import Traffic

BENCH_DIR = "portbench"
TOP_ENTRIES = 10            # entries of each breakdown list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the file at `path` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def cell_of(root: Path, bench: dict, workload: str) -> Cell:
    """The cell `workload` of BENCHMARK.json with its configuration, mix
    and the metrics it reports."""
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if not cells:
        raise ValueError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(workload, int(w["chips"]), load_json(root / conf["file"]),
                load_json(root / BENCH_DIR / "mixes" / f"{w['traffic']}.json"), e2e, layer)


class Reservoir:
    """A uniform sample of k items of a stream, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = np.random.default_rng([seed, 3])

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self._rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item


@dataclasses.dataclass
class Trace:
    """What a `--trace 1` run read, for the per-layer readers."""

    span_ns: tuple                 # (first send, last return) of the traced stretch
    device: List[tuple]            # (name, start_ns, end_ns) of every device op in it
    host: List[tuple]              # (name, start_ns, end_ns) of the host ops in it
    requests: List[np.ndarray]     # the traced stretch's requests (pool rows)
    spans: List[tuple]             # (t0, t1, t2, t3, t4, rows) of the spans stretch
    span_requests: List[np.ndarray]
    build_device: List[tuple]      # device ops of one traced index build
    shape: dict                    # the path's shapes, for the bounds
    windows: Callable              # pool rows -> [q, T] first rows of their windows


@dataclasses.dataclass
class Record:
    """One run, as the metric readers see it."""

    setup_s: float
    window_s: float
    requests: List[tuple]          # (t_send, t_enqueued, t_done, rows)
    build_s: List[float]
    trace: Optional[Trace] = None


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(path, traffic: Traffic, seconds: float, sample: Reservoir, device) -> tuple:
    """The closed loop: send, wait for the synchronised return, send the
    next.  The next request is drawn while the device works.  -> (requests,
    window seconds)."""
    stream = iter(traffic)
    nxt = next(stream)
    reqs = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        ids = nxt
        t0 = time.perf_counter()
        out = path.serve(ids)
        t1 = time.perf_counter()
        nxt = next(stream)
        sync(device)
        t2 = time.perf_counter()
        reqs.append((t0, t1, t2, len(ids)))
        sample.offer(out)
        if t2 >= deadline:
            return reqs, t2 - t_start


def _events(prof) -> tuple:
    """-> (device ops, host ops) of a profile, (name, start_ns, end_ns)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():      # the device's copy of a host range
                dev.append(item)
        else:
            host.append(item)
    return dev, host


def _profile(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def traced_build(path, device) -> tuple:
    """One index build under the profiler -> (its device ops, the index)."""
    with _profile(device) as prof:
        index = path.build()
        sync(device)
    return _events(prof)[0], index


def traced_stretch(path, traffic: Traffic, seconds: float, n_max: int, sample: Reservoir,
                   device) -> tuple:
    """Up to n_max requests (or `seconds`) of the window's loop under the
    profiler, each inside a "request" annotation -> (span, device ops, host
    ops, requests)."""
    stream = iter(traffic)
    nxt = next(stream)
    sent = []
    deadline = time.perf_counter() + seconds
    with _profile(device) as prof:
        while len(sent) < n_max:
            ids = nxt
            with torch.profiler.record_function("request"):
                out = path.serve(ids)
                nxt = next(stream)
                sync(device)
            sent.append(ids)
            sample.offer(out)
            if time.perf_counter() >= deadline:
                break
    dev, host = _events(prof)
    marks = [h for h in host if h[0] == "request"]
    span = (min(m[1] for m in marks), max(m[2] for m in marks))
    host = [h for h in host if h[0] != "request"]
    return span, dev, host, sent


def span_stretch(path, traffic: Traffic, seconds: float, n_max: int, sample: Reservoir,
                 device) -> tuple:
    """Requests with a synchronise between the layers: (t0 send, t1 the
    retrieval's calls returned, t2 synchronised, t3 the rest's calls
    returned, t4 synchronised, rows) each."""
    spans, sent = [], []
    deadline = time.perf_counter() + seconds
    for ids in traffic:
        marks = []

        def mark():
            marks.append(time.perf_counter())
            sync(device)
            marks.append(time.perf_counter())

        t0 = time.perf_counter()
        out = path.serve(ids, mark=mark)
        t3 = time.perf_counter()
        sync(device)
        t4 = time.perf_counter()
        spans.append((t0, marks[0], marks[1], t3, t4, len(ids)))
        sent.append(ids)
        sample.offer(out)
        if len(spans) >= n_max or t4 >= deadline:
            return spans, sent


def union_ns(intervals: List[tuple], lo: int, hi: int) -> int:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def short_name(name: str) -> str:
    """A device op's name without its return type, template and arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0] or [len(name)])
    return name[:cut].strip()


def breakdown(tr: Trace) -> dict:
    """The device ops that took most time, and the idle time of the device
    inside the traced span summed by what the host was doing halfway
    through each gap (the innermost host op around that instant)."""
    lo, hi = tr.span_ns
    by_op: Dict[str, float] = {}
    for name, s, e in tr.device:
        k = short_name(name)
        by_op[k] = by_op.get(k, 0.0) + max(0, min(e, hi) - max(s, lo)) / 1e9
    host = sorted(tr.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps: Dict[str, float] = {}
    t = lo
    for s, e in sorted((d[1], d[2]) for d in tr.device) + [(hi, hi)]:
        if s > t and t < hi:
            g_end = min(s, hi)
            mid = (t + g_end) // 2
            i = bisect.bisect_right(starts, mid)
            around = [h for h in host[max(0, i - 256):i] if h[2] > mid]
            label = min(around, key=lambda h: h[2] - h[1])[0] if around else "no host op"
            gaps[label] = gaps.get(label, 0.0) + (g_end - t) / 1e9
        t = max(t, e)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP_ENTRIES]]
    return {"device_ops": top({k: v for k, v in by_op.items() if v > 0}),
            "idle_gaps": top(gaps)}


def metric_reader(root: Path, name: str):
    """The reader of metric `name`: `metrics/<name>.py`, else that of the
    name with its last `.suffix` cut off, and so on."""
    base = name
    while True:
        f = root / BENCH_DIR / "metrics" / f"{base}.py"
        if f.is_file() or "." not in base:
            return load_module(f, "portbench_metric_" + base.replace(".", "_"))
        base = base.rsplit(".", 1)[0]


@dataclasses.dataclass
class SetUp:
    """A cell made ready for its window."""

    cell: Cell
    path: object
    traffic: Traffic
    build_s: List[float]           # the timed rebuilds' seconds
    build_device: Optional[list]   # device ops of the traced build (trace only)


def set_up(root: Path, workload: str, seed: int, trace: bool, device: torch.device,
           timed_builds: bool = True) -> SetUp:
    """The kernel library, the inputs from the seed, the index built (and,
    with timed_builds, rebuilt `build_reps` times, each timed; with trace,
    once more under the profiler) and every request size of the mix warmed
    up."""
    cell = cell_of(root, load_json(root / "BENCHMARK.json"), workload)
    cfg = cell.config
    mod = load_module(root / BENCH_DIR / "paths" / f"{cfg['path']}.py",
                      f"portbench_path_{cfg['path']}")
    path = mod.Path(cfg, seed, device)
    path.prepare()
    index = path.build()                   # the first build warms every kernel up
    sync(device)
    build_s = []
    for _ in range(int(cfg["build_reps"]) if timed_builds else 0):
        index = None                       # one index at a time on the card
        t0 = time.perf_counter()
        index = path.build()
        sync(device)
        build_s.append(time.perf_counter() - t0)
    build_device = None
    if trace:
        index = None
        build_device, index = traced_build(path, device)
    path.use(index)
    del index
    traffic = Traffic(cell.mix, path.pool, seed)
    for ids in traffic.warm_up(seed):
        path.serve(ids)
    sync(device)
    return SetUp(cell, path, traffic, build_s, build_device)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    """Run one cell once -> the result (correct, attempted, failed, metrics,
    device, breakdown?, checks)."""
    su = set_up(root, workload, seed, trace, device)
    cell, path, traffic, build_s = su.cell, su.path, su.traffic, su.build_s
    mix = cell.mix
    setup_s = time.perf_counter() - t_start
    sample = Reservoir(int(mix["judge_requests"]), seed)
    if trace:
        n_tr = int(mix["trace_requests"])
        span, dev, host, traced = traced_stretch(path, traffic, seconds, n_tr, sample,
                                                 device)
        spans, span_reqs = span_stretch(path, traffic, seconds, n_tr, sample, device)
        reqs, window_s = [], span[1] / 1e9 - span[0] / 1e9
    else:
        reqs, window_s = window(path, traffic, seconds, sample, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    state = path.state()
    path.release()
    checks = path.judge(state, sample.items, seed)
    rec = Record(setup_s=setup_s, window_s=window_s, requests=reqs, build_s=build_s)
    if trace:
        rec.trace = Trace(span, dev, host, traced, spans, span_reqs, su.build_device,
                          path.shape(), path.windows)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(root, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(rec.trace.requests) + len(rec.trace.spans) if trace else len(reqs)
    out = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": attempted,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        lo, hi = rec.trace.span_ns
        out["device"]["busy_s"] = union_ns([(d[1], d[2]) for d in dev], lo, hi) / 1e9
        out["device"]["window_s"] = (hi - lo) / 1e9
        out["breakdown"] = breakdown(rec.trace)
    else:
        lat = sorted((r[2] - r[0]) * 1e3 for r in reqs)
        enq = sorted((r[1] - r[0]) * 1e3 for r in reqs)
        out["latency_ms"] = {"median": lat[len(lat) // 2], "n": len(lat), "max": lat[-1],
                             "enqueue_median": enq[len(enq) // 2]}
    out["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return out


def percentile(values: List[float], p: float) -> float:
    """The nearest-rank p-th percentile (the smallest value at or above
    which lie at least p% of the values)."""
    v = sorted(values)
    return v[max(0, math.ceil(p / 100.0 * len(v)) - 1)]
