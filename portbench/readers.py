"""What the metric readers share: each `metrics/<name>.py` states its
metric with one of these and returns None where its run has nothing for it
to read (a per-layer metric outside a traced run, a kernel that did not
run)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from portbench import bounds
from portbench.harness import Record, percentile, union_ns

K1_KERNELS = ("tile_dots",)
S1_KERNELS = ("block_rows", "warp_rows", "radix_rows")
K2_KERNELS = ("signproj_kernel",)


def rows_per_s(rec: Record) -> Optional[float]:
    """Rows answered in the window over its seconds."""
    if not rec.requests:
        return None
    return sum(r[3] for r in rec.requests) / rec.window_s


def request_p95_ms(rec: Record) -> Optional[float]:
    """95th percentile of every request's send-to-synchronised-return time."""
    if not rec.requests:
        return None
    return percentile([(r[2] - r[0]) * 1e3 for r in rec.requests], 95.0)


def mean_build_s(rec: Record) -> Optional[float]:
    return sum(rec.build_s) / len(rec.build_s) if rec.build_s else None


def device_idle_pct(rec: Record) -> Optional[float]:
    """100 x (1 - union of device ops / the traced span of requests)."""
    tr = rec.trace
    if tr is None or not tr.device:
        return None
    lo, hi = tr.span_ns
    return 100.0 * (1.0 - union_ns([(d[1], d[2]) for d in tr.device], lo, hi) / (hi - lo))


def device_s(events: Sequence[tuple], names: Sequence[str]) -> float:
    """Summed device seconds of the ops whose names hold one of `names`."""
    return sum(e[2] - e[1] for e in events if any(n in e[0] for n in names)) / 1e9


def traced_share_pct(rec: Record, names: Sequence[str],
                     work: Callable[[dict, object], float]) -> Optional[float]:
    """100 x the least seconds of the traced requests' work (`work(shape,
    row0)` a request, row0 the reference's windows) over the device seconds
    of the kernels named."""
    tr = rec.trace
    if tr is None:
        return None
    t = device_s(tr.device, names)
    if t <= 0:
        return None
    least = sum(work(tr.shape, tr.windows(ids)) for ids in tr.requests)
    return 100.0 * least / t


def k1_seconds(s: dict, row0) -> float:
    return bounds.k1_call(row0, s["win"], s["L"] * s["n_pad"], s["d"],
                          s["slab_bytes"])["seconds"]


def s1_seconds(s: dict, row0) -> float:
    return bounds.s1_call(row0.numel(), s["win"], s["kk"])["seconds"]


def retrieve_bound_pct(rec: Record) -> Optional[float]:
    """100 x the least seconds of each spanned request's retrieval work
    over its synchronised retrieval span (send to synchronised return)."""
    tr = rec.trace
    if tr is None or not tr.spans:
        return None
    s = tr.shape
    least = sum(bounds.retrieve_call(tr.windows(ids), s["win"], s["L"] * s["n_pad"], s["d"],
                                     s["slab_bytes"], s["top_k"])["seconds"]
                for ids in tr.span_requests)
    return 100.0 * least / sum(sp[2] - sp[0] for sp in tr.spans)


def host_enqueue_ms(rec: Record) -> Optional[float]:
    """Mean host milliseconds a request spends in the library's calls
    before it synchronises (retrieval, then the rest)."""
    tr = rec.trace
    if tr is None or not tr.spans:
        return None
    return 1e3 * sum((sp[1] - sp[0]) + (sp[3] - sp[2]) for sp in tr.spans) / len(tr.spans)


def after_retrieval_us_per_row(rec: Record) -> Optional[float]:
    """Microseconds a row of the synchronised span after the retrieval."""
    tr = rec.trace
    if tr is None or not tr.spans:
        return None
    return 1e6 * sum(sp[4] - sp[2] for sp in tr.spans) / sum(sp[5] for sp in tr.spans)


def k2_build_pct(rec: Record) -> Optional[float]:
    """100 x K2's least seconds for the corpus over its device seconds in a
    traced index build."""
    tr = rec.trace
    if tr is None or not tr.build_device:
        return None
    t = device_s(tr.build_device, K2_KERNELS)
    if t <= 0:
        return None
    s = tr.shape
    return 100.0 * bounds.k2_call(s["n"], s["d"], s["k"], s["L"])["seconds"] / t
