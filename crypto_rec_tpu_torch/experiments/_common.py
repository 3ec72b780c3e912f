"""Shared set-up, timing and printing of the probe entry points.

The probes' operating point is `bench.py`'s 2M point: N = 2,000,000 rows of
d = 128, cosine LSH k = 13, L = 8, window 488 (win 640), top-10.  Each
probe builds its corpus from a seed on the card, hashes it through K2,
packs int8 and/or bf16 slabs and derives every query's window starts with
the golden-ratio offsets (`_window_offsets`); the `run_*` functions take
the result as a `ProbeIndex`.

Times are CUDA-event medians.  On tensors off the card nothing is timed:
`timed` returns None and the report says "not measured".
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
from typing import Callable, Dict, List, Optional

import torch

from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus
from crypto_rec_tpu_torch.models.lsh.index import build_index, query_hashes
from crypto_rec_tpu_torch.ops.kernels.slabscore import _window_offsets
from crypto_rec_tpu_torch.ops.oracle import recall_at_k

N, D, Q, TOP_K = 2_000_000, 128, 8192, 10
K, L, PER_TABLE = 13, 8, 488


@dataclasses.dataclass
class ProbeIndex:
    """One packed cosine index and a query batch's windows."""

    packed: torch.Tensor          # [L, n_pad, d] int8 / bf16 CSR slabs
    packed_rows: torch.Tensor     # [L, n_pad] int32 CSR row ids
    bucket_starts: torch.Tensor   # [L, n_buckets + 1]
    n_rows: int
    qv: torch.Tensor              # [q, d] f32 normalized queries
    q_buckets: torch.Tensor       # [q, L]
    s0: torch.Tensor              # [q, L] window starts
    sizes: torch.Tensor           # [q, L] valid rows per window
    per_table: int
    true_idx: Optional[torch.Tensor] = None   # [q, top_k] planted truth


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure the Hopper kernels and need an "
                           "NVIDIA GPU")


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def timed(fn: Callable, device: torch.device, reps: int = 5):
    """-> (median CUDA-event ms of `reps` warm runs of fn, fn's last
    output).  Off the card fn runs once and the time is None."""
    if device.type != "cuda":
        return None, fn()
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        del out
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), out


def timed_alternating(fns: Dict[str, Callable], device: torch.device,
                      rounds: int = 31) -> Dict[str, Optional[List[float]]]:
    """-> {name: CUDA-event ms of each round}: one warm run of each fn,
    then `rounds` rounds that run every fn once in turn, so drift on the
    card falls on all of them alike.  Off the card each fn runs once and
    the times are None."""
    if device.type != "cuda":
        for fn in fns.values():
            fn()
        return {name: None for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            del out
            times[name].append(a.elapsed_time(b))
    return times


def spread(xs: Optional[List[float]]) -> str:
    """'median (min-max)' of a list of numbers, or 'not measured'."""
    if xs is None:
        return "not measured"
    return f"{statistics.median(xs):.3f} ({min(xs):.3f}-{max(xs):.3f})"


def rate(ms: Optional[float], q: int) -> str:
    """'x ms  y q/s', or 'not measured' when there is no time."""
    if ms is None:
        return "not measured"
    return f"{ms:.3f} ms  {q / ms * 1e3:,.0f} q/s"


def fmt_recall(r: Optional[float]) -> str:
    return "not measured" if r is None else f"{r:.4f}"


def gbps(nbytes: float, ms: Optional[float]) -> Optional[float]:
    return None if ms is None else nbytes / ms / 1e6


def recall(ids: torch.Tensor, p: ProbeIndex) -> Optional[float]:
    return None if p.true_idx is None else recall_at_k(ids, p.true_idx)


def make_corpus(kind: str, n: int, q: int, seed: int, device, d: int = D):
    """-> (corpus [n, d], queries [q, d], planted truth [q, TOP_K] or
    None).  kind "planted": `planted_clustered_corpus`; "normal": N(0, 1)
    rows and queries (timing only, no recall)."""
    g = torch.Generator(device=device).manual_seed(seed)
    if kind == "planted":
        return planted_clustered_corpus(g, n, d, q, TOP_K)
    if kind != "normal":
        raise ValueError(f"unknown corpus {kind!r}")
    return (torch.randn(n, d, generator=g, device=device),
            torch.randn(q, d, generator=g, device=device), None)


def build_cosine(corpus: torch.Tensor, seed: int):
    """The probes' cosine index, k = K, L tables (K2 on the card)."""
    return build_index(torch.Generator().manual_seed(seed), corpus, "cosine", K, L)


def probe_index(pidx, queries: torch.Tensor, true_idx=None) -> ProbeIndex:
    """A packed index (`pack_index`) and `queries`: hashed as given (as
    the probes hash them), normalized, and given their PER_TABLE windows."""
    qv = torch.nn.functional.normalize(queries.float(), dim=1)
    qb, _ = query_hashes(pidx, queries)
    s0, sizes = _window_offsets(pidx.bucket_starts, qb, PER_TABLE)
    return ProbeIndex(packed=pidx.packed, packed_rows=pidx.packed_rows,
                      bucket_starts=pidx.bucket_starts, n_rows=pidx.n_rows, qv=qv,
                      q_buckets=qb, s0=s0, sizes=sizes, per_table=PER_TABLE,
                      true_idx=true_idx)


def start(argv, doc: str, q: int = Q):
    """Common probe start: arguments (--n rows, --q queries, --seed), the
    card check, the card's line."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--n", type=int, default=N, help="corpus rows")
    ap.add_argument("--q", type=int, default=q, help="queries")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    require_cuda()
    print(card(), flush=True)
    return args, torch.device("cuda")
