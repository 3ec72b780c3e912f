"""Phase timing, and the spans and counters inside the library.

The reference writes per-phase wall-clock ms into the results file
(reference main.cpp:152,172-173).  PyTorch returns before the device
finishes, so on a CUDA device a phase ends with `torch.cuda.synchronize()`
before the clock is read: a phase's time is the time its work took, not
the time it took to enqueue.  A phase may also write a torch.profiler
trace (the counterpart of the JAX package's jax.profiler trace).

Spans and counters (`span`, `count`, `snapshot`) mark the stages of the
library's calls: hash, windows, K1's work list and launch, S1, dedup,
rerank, the CF scoring, the index build.  They record only while a
torch.profiler records (`tracing()`, torch's own flag): off, a span is one
flag read and a counter nothing.  On, a span is a `record_function` range
on the profiler's clock and, on a CUDA device, two events on the current
stream, whose difference is the span's device-stream time: the stage's
kernels plus the time the stream waited for the host inside it.  Nothing
synchronises before `snapshot()`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def tracing() -> bool:
    """Whether a torch.profiler records now (what turns spans on)."""
    return _autograd_profiler._is_profiler_enabled


def _launch_counts() -> Dict[str, int]:
    """The kernel wrappers' own launch counters (K1, S1, D1, K2)."""
    from crypto_rec_tpu_torch.ops.kernels import deduptopk, signproj, slabscore, windowtopk

    return {"slab_window_dots": slabscore.slab_window_dots.launches,
            "window_topk": windowtopk.window_topk.launches,
            "dedup_topk": deduptopk.dedup_topk.launches,
            "signproj_bucket_ids": signproj.signproj_bucket_ids.launches}


class _Record:
    """A closed span: its path (its name under its parents'), the id of its
    top-level span, host start and end (ns), and the device and stream
    events where CUDA is in use."""

    __slots__ = ("path", "top", "t0", "t1", "device", "ev0", "ev1")


class _Span:
    """One open span: a record_function range, host clock and, where CUDA
    is in use, a pair of stream events."""

    __slots__ = ("tracer", "name", "rec", "rf", "launches")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name, self.rec = tracer, name, None

    def __enter__(self):
        stack = self.tracer.stack
        if any(s.name == self.name for s in stack):
            return self                      # re-entry of an open span: records nothing
        r = self.rec = _Record()
        parent = stack[-1].rec if stack else None
        r.path = self.name if parent is None else f"{parent.path}/{self.name}"
        if parent is None:
            r.top, self.tracer.tops = self.tracer.tops, self.tracer.tops + 1
        else:
            r.top = parent.top
        self.launches = _launch_counts() if parent is None else None
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        r.device = r.ev0 = r.ev1 = None
        if torch.cuda.is_initialized():
            r.device = torch.cuda.current_device()
            r.ev0 = torch.cuda.Event(enable_timing=True)
            r.ev0.record()
        stack.append(self)
        r.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        r = self.rec
        if r is None:
            return False
        r.t1 = time.perf_counter_ns()
        if r.ev0 is not None:
            r.ev1 = torch.cuda.Event(enable_timing=True)
            r.ev1.record()
        self.tracer.stack.pop()
        self.rf.__exit__(*exc)
        self.tracer._close(r, self.launches)
        return False


_OFF = contextlib.nullcontext()


class Tracer:
    """The spans and counters of one process, kept in memory until
    `snapshot()` reads them (`reset()` empties them).  Spans nest on one
    stack: the library opens them from one thread."""

    def __init__(self) -> None:
        self.stack: List[_Span] = []
        self.reset()

    def reset(self) -> None:
        """Forget every closed span and counter."""
        self.records: List[_Record] = []
        self.counters: Dict[str, object] = {}
        self.launches: Dict[str, int] = {}
        self.tops = 0

    def _close(self, rec: _Record, launches_before: Optional[dict]) -> None:
        self.records.append(rec)
        if launches_before is not None:
            for k, v in _launch_counts().items():
                self.launches[k] = self.launches.get(k, 0) + v - launches_before[k]

    def span(self, name: str):
        """A context manager: while tracing, a span named `name` (nested
        under the innermost open span, whose top-level id it carries); a
        span of the name of one already open records nothing.  Off, a
        shared null context."""
        if not _autograd_profiler._is_profiler_enabled:
            return _OFF
        return _Span(self, name)

    def count(self, name: str, value) -> None:
        """While tracing, add `value` (a Python int, or a 0-d tensor that
        stays on its device until the snapshot) to counter `name`."""
        if not _autograd_profiler._is_profiler_enabled:
            return
        self.counters[name] = self.counters.get(name, 0) + value

    def device_total(self, name: str, device) -> Optional[torch.Tensor]:
        """While tracing, counter `name` as a 0-d int64 tensor on `device`
        for a kernel to add into (made from what the counter held, zero at
        first; no synchronise); off, None."""
        if not _autograd_profiler._is_profiler_enabled:
            return None
        v = self.counters.get(name, 0)
        if isinstance(v, torch.Tensor) and v.dim() == 0 and v.dtype == torch.int64 \
                and v.device == torch.device(device):
            return v
        t = torch.zeros((), dtype=torch.int64, device=device)
        if isinstance(v, torch.Tensor) or v:
            t += v
        self.counters[name] = t
        return t

    def snapshot(self) -> dict:
        """One synchronise of the devices the spans ran on, then:
        spans: {path: {calls, host_ms, stream_ms}}, a path being the span's
        name under its parents' ("retrieve/k1"); stream_ms None where no
        CUDA events were recorded.  counters: {name: total}.  launches:
        {wrapper: the `.launches` it added inside top-level spans}.
        top_level: the top-level spans opened."""
        for dev in sorted({r.device for r in self.records if r.device is not None}):
            torch.cuda.synchronize(dev)
        spans: Dict[str, dict] = {}
        for r in self.records:
            e = spans.setdefault(r.path, {"calls": 0, "host_ms": 0.0, "stream_ms": None})
            e["calls"] += 1
            e["host_ms"] += (r.t1 - r.t0) / 1e6
            if r.ev1 is not None:
                e["stream_ms"] = (e["stream_ms"] or 0.0) + r.ev0.elapsed_time(r.ev1)
        return {"spans": spans,
                "counters": {k: int(v) for k, v in self.counters.items()},
                "launches": dict(self.launches),
                "top_level": self.tops}


TRACER = Tracer()
span = TRACER.span
count = TRACER.count
device_total = TRACER.device_total
snapshot = TRACER.snapshot
reset = TRACER.reset


class PhaseTimer:
    """Accumulated wall seconds per named phase.  `device`: the device the
    phases' work runs on; a CUDA device is synchronized at each phase's
    end."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, trace_dir: Optional[str] = None):
        """Time the block; under torch.profiler it is also a span named
        `name` (`span`), which `main --profile` writes to spans.json.
        trace_dir: profile the block (CPU, and CUDA activity on a CUDA
        device) and write its Chrome trace into that directory as
        `<name>.trace.json`."""
        prof = contextlib.nullcontext()
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
        start = time.perf_counter()
        with prof:
            with span(name):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        self.phases[name] = self.phases.get(name, 0.0) + (time.perf_counter() - start)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.trace.json"))

    def ms(self, name: str) -> int:
        return int(self.phases.get(name, 0.0) * 1000)

    def qps(self, name: str, n_queries: int) -> float:
        """n_queries over the phase's accumulated seconds (inf before it
        has taken any time)."""
        dt = self.phases.get(name, 0.0)
        return n_queries / dt if dt > 0 else float("inf")
