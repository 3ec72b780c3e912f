"""What the readers of the program's own spans and counters share.

The port records spans and counters while a torch.profiler records
(`crypto_rec_tpu_torch/utils/timing.py`): in a `--trace 1` run, the traced
index build and the profiled stretch of requests.  Their host ranges reach
the trace's host events on the device ops' clock (`rec.trace.host`); their
device-stream times and counters come from the program's `snapshot()` in
this process.  A program without them (an older checkout) gives None here,
and so does each reader.
"""

from __future__ import annotations

import bisect
from typing import Optional

from portbench.harness import Record


def program_snapshot() -> Optional[dict]:
    """The program's spans and counters so far, or None where it has none."""
    try:
        from crypto_rec_tpu_torch.utils import timing
    except ImportError:
        return None
    snap = getattr(timing, "snapshot", None)
    return snap() if snap is not None else None


def _traced_snapshot(rec: Record) -> Optional[dict]:
    return None if rec.trace is None else program_snapshot()


def stream_ms(snap: Optional[dict], name: str, within: Optional[str] = None) -> Optional[float]:
    """Summed device-stream ms of the spans named `name` (the last part of
    a span's path), those under a span named `within` only where given;
    None where there is none or one was not timed on the device."""
    if snap is None:
        return None
    found = [e["stream_ms"] for p, e in snap.get("spans", {}).items()
             if p.split("/")[-1] == name and (within is None or within in p.split("/")[:-1])]
    if not found or any(v is None for v in found):
        return None
    return sum(found)


def per_request_stream_ms(rec: Record, name: str) -> Optional[float]:
    """Device-stream ms of the spans named `name` a traced request."""
    ms = stream_ms(_traced_snapshot(rec), name)
    return None if ms is None or not rec.trace.requests else ms / len(rec.trace.requests)


def glue_ms(rec: Record) -> Optional[float]:
    """Device-stream ms a traced request of `retrieve` less its `k1` and
    `s1` children: the torch ops around the two kernels."""
    snap = _traced_snapshot(rec)
    whole = stream_ms(snap, "retrieve")
    if whole is None or not rec.trace.requests:
        return None
    kernels = [stream_ms(snap, k, within="retrieve") for k in ("k1", "s1")]
    return (whole - sum(v for v in kernels if v is not None)) / len(rec.trace.requests)


def per_row_stream_us(rec: Record, name: str) -> Optional[float]:
    """Device-stream us of the spans named `name` a row of the traced
    requests."""
    ms = stream_ms(_traced_snapshot(rec), name)
    rows = sum(len(r) for r in rec.trace.requests) if rec.trace is not None else 0
    return None if ms is None or not rows else 1e3 * ms / rows


def per_call_stream_ms(rec: Record, name: str) -> Optional[float]:
    """Device-stream ms of one call of the top-level span `name`."""
    snap = _traced_snapshot(rec)
    e = None if snap is None else snap.get("spans", {}).get(name)
    if e is None or e["stream_ms"] is None or not e["calls"]:
        return None
    return e["stream_ms"] / e["calls"]


def idle_inside_ms(rec: Record, name: str) -> Optional[float]:
    """Device-idle ms a traced request whose gap's midpoint lies inside a
    host range of the span `name`: the gaps between the device ops of the
    traced stretch, as `harness.breakdown` cuts them, against the host's
    ranges on the same clock."""
    tr = rec.trace
    if tr is None or not tr.device or not tr.requests:
        return None
    ranges = sorted((h[1], h[2]) for h in tr.host if h[0] == name)
    if not ranges:
        return None
    starts = [r[0] for r in ranges]
    lo, hi = tr.span_ns
    total, t = 0, lo
    for s, e in sorted((d[1], d[2]) for d in tr.device) + [(hi, hi)]:
        if s > t and t < hi:
            g_end = min(s, hi)
            mid = (t + g_end) // 2
            i = bisect.bisect_right(starts, mid) - 1
            if i >= 0 and ranges[i][1] > mid:
                total += g_end - t
        t = max(t, e)
    return total / 1e6 / len(tr.requests)


def counter_share_pct(rec: Record, part: str, whole: str) -> Optional[float]:
    """100 x counter `part` over counter `whole`."""
    snap = _traced_snapshot(rec)
    c = {} if snap is None else snap.get("counters", {})
    if not c.get(whole) or part not in c:
        return None
    return 100.0 * c[part] / c[whole]
