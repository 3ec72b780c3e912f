"""Streamed serving: an index LARGER than device memory, on one card.

The corpus is partitioned into R contiguous row-range chunks.  Each chunk
carries its OWN CSR bucket tables and global-scale int8 slabs, built on
the HOST in numpy (bucket ids bit-identical to `_host_bucket_ids`, the
JAX package's build); a query batch is served by streaming one chunk's
slabs host -> device at a time, running the fused retrieval per chunk and
merging the per-chunk top-k on the device.

Transfer/compute overlap: the chunks live in pinned host memory (pinned
once, at build), and chunk i+1's copy is issued on a side CUDA stream
before chunk i's retrieval is consumed.  The compute stream waits on an
event recorded after the copy, and the copied tensors are recorded on the
compute stream, so the caching allocator cannot hand a chunk's memory
back while K1 still reads it.  The host synchronizes once per chunk,
which keeps at most two chunks (the current one and the prefetched one)
in flight: the JAX package's bound, without which its build reached
130 GB of host memory.

Reference analog: none — the reference is a single-process in-memory
program; this is the package's own scale axis.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh
from crypto_rec_tpu_torch.models.lsh.index import packed_retrieve_core
from crypto_rec_tpu_torch.ops.kernels.slabscore import packed_retrieve_pallas
from crypto_rec_tpu_torch.ops.topk import topk_desc


@dataclasses.dataclass
class StreamedLshIndex:
    """Host-resident chunked index (cosine, global-scale int8 slabs)."""

    metric: str
    k: int
    L: int
    n_rows: int
    n_buckets: int
    chunk_rows: int              # rows per chunk (last chunk padded)
    chunk_pad: int               # slab rows per chunk (aligned)
    gscale: float                # one global dequant scalar
    proj: np.ndarray             # [d, L*k] hash family (host copy)
    slabs: List[torch.Tensor]    # per chunk: [L, chunk_pad, d] int8 (CPU)
    rows: List[torch.Tensor]     # per chunk: [L, chunk_pad] int32 local ids
    starts: List[torch.Tensor]   # per chunk: [L, n_buckets + 1] int32

    @property
    def n_chunks(self) -> int:
        return len(self.slabs)

    def host_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for ts in (self.slabs, self.rows, self.starts) for t in ts)


def _host_bucket_ids(x: np.ndarray, proj: np.ndarray, k: int, L: int) -> np.ndarray:
    """Cosine bucket ids on the HOST: sign bits packed MSB-first per table
    (the numpy mirror of CosineLsh.bucket_ids)."""
    bits = (x.astype(np.float32) @ proj >= 0.0).astype(np.int64)
    bits = bits.reshape(x.shape[0], L, k)
    weights = 1 << np.arange(k - 1, -1, -1, dtype=np.int64)
    return (bits * weights).sum(-1).astype(np.int32)


def build_streamed_index(
    generator: Optional[torch.Generator],
    chunk_source: Callable[[int], np.ndarray],
    n_rows: int,
    dim: int,
    k: int,
    L: int,
    n_chunks: int,
    align: int = 512,
    pad: int = 1024,
    proj: Optional[np.ndarray] = None,
) -> StreamedLshIndex:
    """Build the chunked index on the host.

    chunk_source(ci) returns the f32 rows of chunk ci ([chunk_rows, dim];
    the LAST chunk may be shorter — its pad rows join no bucket).  Hashing
    is a numpy matmul against the hyperplanes `proj` ([dim, L k], drawn from
    `generator` when not handed over); CSR is a stable argsort + bincount;
    slabs are normalized global-scale int8 with the fixed scale 1/127 (a
    normalized row's components are <= 1).  Where CUDA is available each
    chunk's tensors are page-locked once, so every pass copies them at the
    pinned rate."""
    if proj is None:
        proj = CosineLsh.create(generator, dim, k, L, torch.device("cpu")).proj.numpy()
    proj = np.asarray(proj, dtype=np.float32)
    pin = torch.cuda.is_available()
    chunk_rows = -(-n_rows // n_chunks)
    # pad past the window reach (packed_retrieve_core needs pad >=
    # per_table + 2 blocks), aligned to the block grid as pack_index pads
    chunk_pad = chunk_rows + (-(chunk_rows + pad) % align + pad)
    n_buckets = 1 << k
    gscale = 1.0 / 127.0

    def host(a):
        t = torch.from_numpy(a)
        return t.pin_memory() if pin else t

    slabs, rows_l, starts_l = [], [], []
    for ci in range(n_chunks):
        x = np.asarray(chunk_source(ci), dtype=np.float32)
        nc = x.shape[0]
        if nc < chunk_rows and ci != n_chunks - 1:
            raise ValueError("only the last chunk may be short")
        b = _host_bucket_ids(x, proj, k, L)                      # [nc, L]
        norms = np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-30)
        xq = np.clip(np.round((x / norms) / gscale), -127, 127).astype(np.int8)
        slab = np.zeros((L, chunk_pad, dim), np.int8)
        rows = np.full((L, chunk_pad), chunk_rows, np.int32)    # sentinel
        starts = np.zeros((L, n_buckets + 1), np.int32)
        for l in range(L):
            order = np.argsort(b[:, l], kind="stable").astype(np.int32)
            slab[l, :nc] = xq[order]
            rows[l, :nc] = order
            starts[l, 1:] = np.cumsum(np.bincount(b[:, l], minlength=n_buckets))
        slabs.append(host(slab))
        rows_l.append(host(rows))
        starts_l.append(host(starts))
        del x, xq, b, slab
    return StreamedLshIndex(
        metric="cosine", k=k, L=L, n_rows=n_rows, n_buckets=n_buckets,
        chunk_rows=chunk_rows, chunk_pad=chunk_pad, gscale=gscale, proj=proj,
        slabs=slabs, rows=rows_l, starts=starts_l,
    )


def chunk_retrieve(slab, rows, starts, chunk_rows, queries, q_buckets, top_k,
                   per_table, stage1_width=0):
    """One chunk's cosine retrieval -> (raw int8 dot scores, local ids):
    K1 through `packed_retrieve_pallas` (production windows) when d % 128
    == 0, else the blocked `packed_retrieve_core`, as the JAX package
    chooses (streamed.py:165-183)."""
    if queries.shape[1] % 128 == 0:
        return packed_retrieve_pallas(slab, rows, starts, chunk_rows, queries, q_buckets,
                                      top_k, per_table, stage1_width=stage1_width)
    return packed_retrieve_core(slab, rows, None, None, starts, chunk_rows, "cosine",
                                queries, q_buckets, None, top_k, per_table)


def merge_topk(best_v, best_i, v, ids, offset: int, top_k: int):
    """Fold one chunk's top-k (local ids shifted by `offset`) into the
    running top-k; equal scores keep the earlier position."""
    cat_v = torch.cat([best_v, v], dim=1)
    cat_i = torch.cat([best_i, torch.where(ids >= 0, ids + offset, -1).to(best_i.dtype)],
                      dim=1)
    nv, pos = topk_desc(cat_v, top_k)
    return nv, torch.gather(cat_i, 1, pos)


def streamed_retrieve_topk(
    index: StreamedLshIndex,
    queries: torch.Tensor,       # [q, d] on the serving device
    top_k: int,
    per_table: int = 256,
    stage1_width: int = 0,
    stats: Optional[dict] = None,
    prefetch: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serve one query batch against the streamed index on queries' device.

    -> (scores [q, top_k] descending cosine sims, GLOBAL row ids, -1 pad).

    K2 hashes the queries once; per chunk the slab, rows and starts are
    copied to the device (on CUDA: on a side stream, the next chunk's copy
    issued before this chunk's retrieval when `prefetch`), the chunk is
    retrieved (`chunk_retrieve`), its ids shifted by the chunk's row
    offset and merged into the running top-k.  `stats` receives wall_s,
    chunks, bytes_streamed, stream_gb_per_s and qps; on CUDA also copy_ms,
    the copy stream's busy time, and overlap_ms, the time chunk copies ran
    while a chunk was retrieved (CUDA events)."""
    dev = queries.device
    cuda = dev.type == "cuda"
    q = queries.shape[0]
    fam = CosineLsh(proj=torch.from_numpy(index.proj).to(dev), k=index.k, L=index.L)
    q_buckets = fam.bucket_ids(queries)
    compute = torch.cuda.current_stream(dev) if cuda else None
    copy = torch.cuda.Stream(dev) if cuda else None
    timing = cuda and stats is not None

    def event():
        return torch.cuda.Event(enable_timing=timing)

    def upload(ci):
        host = (index.slabs[ci], index.rows[ci], index.starts[ci])
        if not cuda:
            return host, None, None
        with torch.cuda.stream(copy):
            t0 = event()
            t0.record(copy)
            dev_t = tuple(h.to(dev, non_blocking=True) for h in host)
            done = event()
            done.record(copy)
        return dev_t, t0, done

    best_v = torch.full((q, top_k), float("-inf"), device=dev)
    best_i = torch.full((q, top_k), -1, dtype=torch.int32, device=dev)
    spans = []                                 # (copy start, copy end, compute start, end)
    t0 = time.perf_counter()
    cur = upload(0)
    for ci in range(index.n_chunks):
        last = ci + 1 == index.n_chunks
        nxt = upload(ci + 1) if prefetch and not last else None
        tensors, c0, c1 = cur
        if cuda:
            compute.wait_event(c1)
            for t in tensors:
                t.record_stream(compute)
            k0 = event()
            k0.record(compute)
        v, ids = chunk_retrieve(*tensors, index.chunk_rows, queries, q_buckets, top_k,
                                per_table, stage1_width)
        best_v, best_i = merge_topk(best_v, best_i, v, ids, ci * index.chunk_rows, top_k)
        if cuda:
            k1 = event()
            k1.record(compute)
            spans.append((c0, c1, k0, k1))
            # bound the pipeline: the host waits for this chunk, so at most
            # this chunk and the prefetched one are in flight
            compute.synchronize()
        del tensors, v, ids
        cur = nxt if prefetch or last else upload(ci + 1)
    wall = time.perf_counter() - t0
    if stats is not None:
        nbytes = index.host_bytes()
        stats.update(wall_s=wall, chunks=index.n_chunks, bytes_streamed=nbytes,
                     stream_gb_per_s=nbytes / wall / 1e9, qps=q / wall)
        if timing:
            stats["copy_ms"] = sum(c0.elapsed_time(c1) for c0, c1, _, _ in spans)
            # copy of chunk i+1 against the retrieval of chunk i
            stats["overlap_ms"] = sum(
                max(0.0, min(spans[0][0].elapsed_time(b[1]), spans[0][0].elapsed_time(a[3]))
                    - max(spans[0][0].elapsed_time(b[0]), spans[0][0].elapsed_time(a[2])))
                for a, b in zip(spans, spans[1:]))
    return best_v * index.gscale, best_i
