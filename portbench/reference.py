"""The plain reference of the benchmark's paths: cosine LSH retrieval over
int8 slab windows, its exact rerank, and mean-centred collaborative
filtering, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
works from the benchmark's own inputs (corpus, queries, ratings,
projection).  Its arithmetic is float64, but for the int8 slab format,
which is specified in float32 (below) and is reproduced exactly.

The semantics, from the reference recommender (lib/lsh_cube.hpp,
lib/crypto_rec.hpp) as the JAX package and its port lay them out:

- hash: L tables of k random hyperplanes; bit = (r . x >= 0), the first
  hyperplane the highest bit of the bucket id;
- tables: rows sorted by bucket id, stable (equal ids keep row order),
  with CSR offsets; each table is padded to n_pad rows (a multiple of 512
  past n + pad) with zero rows whose id is the sentinel n;
- the slab format: row / norm, norm = sqrt of the float64 sum of squares
  rounded to float32, the division in float32; one global scale g =
  max(amax|row| / norm) / 127 (float32); int8 = round half to even of
  (row / norm) / g in float32, clamped to +-127;
- windows: per (query, table) a start inside the query's bucket at the
  pseudo-random offset of the JAX package, aligned down to 32 rows and
  widened to win = ceil((per_table + 32) / 128) * 128 lanes, clamped to end
  inside the slab; every lane is scored (no mask);
- stage 1: the best kk lanes of each window (equal values lowest lane
  first); stage 2: distinct real rows, best top_k (equal values lowest id
  first);
- CF: scores are the int8 dots times g; the prediction of an unknown coin
  is the user's mean plus sum_i s_i (R_ij - mean_i) / sum_i |s_i| over the
  valid neighbours (the mean where that sum is 0), known coins keep their
  rating, and the top-N are the best unknown coins, lowest index first;
- retrieval: the best top_core by int8 dot, rescored by exact cosine,
  best top_k (equal scores the earlier candidate).

A selection near a tie: where a window's kk-th and (kk+1)-th dots lie
within rounding of each other, a program computing in float32 may keep
either lane, and the rows it then returns may differ from float64's by
more than rounding.  So the judge's selections take a `slack` (in g-scaled
dots): they keep only what every selection within the slack keeps, which
gives the answer that any sound selection matches or beats rank by rank.

`precision="tf32"` is the control: every float32 operand of a product
rounded to TF32 (10 mantissa bits) first, the step below the float32 with
TF32 off that the configurations state.
"""

from __future__ import annotations

import dataclasses
import math

import torch

ALIGN = 32
WIN_ROUND = 128
F64 = torch.float64


def planted_corpus(generator: torch.Generator, n: int, d: int, n_queries: int,
                   top_k: int, n_centers: int = 0, cluster_noise: float = 0.3,
                   planted_noise: float = 0.15, n_chunks: int = 32):
    """The benchmark's data recipe (a frozen copy of the port's planted
    clustered corpus), on `generator.device`: centres N(0, 1) x 2, queries
    a random centre + cluster_noise N(0, 1); rows [0, n_queries top_k) are
    each query's planted neighbours (query + planted_noise N(0, 1)), the
    rest cluster points.  -> (corpus [n, d], queries [n_queries, d],
    truth [n_queries, top_k] int64)."""
    dev = generator.device
    if n_centers <= 0:
        n_centers = max(1024, n // 128)
    g = generator
    centers = torch.randn(n_centers, d, generator=g, device=dev) * 2.0
    qc = torch.randint(0, n_centers, (n_queries,), generator=g, device=dev)
    queries = centers[qc] + cluster_noise * torch.randn(n_queries, d, generator=g,
                                                        device=dev)
    n_planted = n_queries * top_k
    corpus = torch.empty(n, d, dtype=torch.float32, device=dev)
    chunk = -(-n // n_chunks)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        rows = centers[torch.randint(0, n_centers, (e - s,), generator=g, device=dev)]
        rows += cluster_noise * torch.randn(e - s, d, generator=g, device=dev)
        if s < n_planted:
            p = min(e, n_planted) - s
            qidx = torch.arange(s, s + p, device=dev) // top_k
            rows[:p] = queries[qidx] + planted_noise * torch.randn(p, d, generator=g,
                                                                   device=dev)
        corpus[s:e] = rows
    truth = torch.arange(n_queries * top_k, device=dev).reshape(n_queries, top_k)
    return corpus, queries, truth


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, ties away from
    zero, as the tensor cores' conversion rounds)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A float32 operand of a product, as `precision` computes with it."""
    if precision == "tf32":
        x = tf32(x)
    elif precision != "float64":
        raise ValueError(f"unknown precision {precision!r}")
    return x.to(F64)


def padded_len(n: int, pad: int) -> int:
    """Rows of a table's slab: n + pad rounded up to a multiple of 512."""
    return n + (-(n + pad) % 512 + pad)


def window_len(per_table: int) -> int:
    return (per_table + ALIGN + WIN_ROUND - 1) // WIN_ROUND * WIN_ROUND


def hash_bits(x: torch.Tensor, proj: torch.Tensor, precision: str = "float64",
              block: int = 1 << 17):
    """-> (bits [n, L k] bool, margin [n, L k] float64): bit = r . x >= 0,
    margin = |r . x| / (|r| |x|), in row blocks."""
    p = operand(proj, precision)
    pn = torch.linalg.vector_norm(proj.to(F64), dim=0)
    bits, margin = [], []
    for s in range(0, x.shape[0], block):
        xb = operand(x[s:s + block], precision)
        acc = xb @ p
        bits.append(acc >= 0)
        xn = torch.linalg.vector_norm(x[s:s + block].to(F64), dim=1, keepdim=True)
        margin.append(acc.abs() / torch.clamp(xn * pn, min=1e-300))
    return torch.cat(bits), torch.cat(margin)


def bucket_ids(bits: torch.Tensor, k: int, L: int) -> torch.Tensor:
    """[n, L k] bits -> [n, L] int64 bucket ids, first bit highest."""
    w = 2 ** torch.arange(k - 1, -1, -1, device=bits.device)
    return (bits.reshape(bits.shape[0], L, k).long() * w).sum(-1)


def csr(buckets: torch.Tensor, n_buckets: int):
    """[n, L] bucket ids -> (sorted_rows [L, n], starts [L, n_buckets + 1]),
    int64: rows in stable bucket order and each bucket's first position."""
    rows, starts = [], []
    for t in range(buckets.shape[1]):
        order = torch.sort(buckets[:, t], stable=True).indices
        counts = torch.bincount(buckets[:, t], minlength=n_buckets)
        rows.append(order)
        starts.append(torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]))
    return torch.stack(rows), torch.stack(starts)


def window_starts(starts: torch.Tensor, q_buckets: torch.Tensor, per_table: int):
    """Each (query, table) window's start: the JAX package's salted
    pseudo-random offset into an oversized bucket (int32 wraparound), the
    bucket's start where it fits.  -> [q, L] int64."""
    L = q_buckets.shape[1]
    t = torch.arange(L, device=q_buckets.device)
    qb = q_buckets.long()
    lo = starts[t[None, :], qb]
    size = starts[t[None, :], qb + 1] - lo
    mix = (qb * -1640531527) ^ (t[None, :] * 40503)
    mix = (mix + (1 << 31)) % (1 << 32) - (1 << 31)
    mix = torch.where(mix == -(1 << 31), mix, mix.abs())
    return lo + torch.remainder(mix, torch.clamp(size - per_table, min=0) + 1)


def aligned_starts(s0: torch.Tensor, per_table: int, n_pad: int) -> torch.Tensor:
    """Window starts aligned down to 32 rows, clamped so the window ends
    inside the slab."""
    return torch.clamp(torch.div(s0, ALIGN, rounding_mode="floor") * ALIGN,
                       max=n_pad - window_len(per_table))


@dataclasses.dataclass
class CosineIndex:
    """The reference's view of a cosine LSH index over `corpus`."""

    corpus: torch.Tensor       # [n, d] float32, the benchmark's rows
    proj: torch.Tensor         # [d, L k] float32, the benchmark's hyperplanes
    k: int
    L: int
    per_table: int
    pad: int
    sorted_rows: torch.Tensor  # [L, n_pad] int64, sentinel n past n
    starts: torch.Tensor       # [L, 2^k + 1] int64
    norms: torch.Tensor        # [n, 1] float32
    g: torch.Tensor            # float32 scalar

    @property
    def n(self) -> int:
        return self.corpus.shape[0]

    @property
    def n_pad(self) -> int:
        return self.sorted_rows.shape[1]

    @property
    def win(self) -> int:
        return window_len(self.per_table)


def row_norms(x: torch.Tensor, block: int = 1 << 17) -> torch.Tensor:
    """[n, 1] float32: sqrt of the float64 sum of squares, rounded."""
    return torch.cat([torch.sqrt(torch.sum(torch.square(x[s:s + block].to(F64)), dim=1))
                      .float()[:, None] for s in range(0, x.shape[0], block)])


def global_scale(x: torch.Tensor, norms: torch.Tensor, block: int = 1 << 17) -> torch.Tensor:
    amax = max(float(torch.max(torch.amax(torch.abs(x[s:s + block]), dim=1)
                               / torch.clamp(norms[s:s + block, 0], min=1e-30)))
               for s in range(0, x.shape[0], block))
    return torch.clamp(torch.tensor(amax, dtype=torch.float32, device=x.device),
                       min=1e-30) / 127.0


def build(corpus, proj, k, L, per_table, pad, buckets) -> CosineIndex:
    """The reference index from the corpus rows' bucket ids [n, L]."""
    n = corpus.shape[0]
    rows, starts = csr(buckets.long(), 1 << k)
    n_pad = padded_len(n, pad)
    rows = torch.nn.functional.pad(rows, (0, n_pad - n), value=n)
    norms = row_norms(corpus)
    return CosineIndex(corpus, proj, k, L, per_table, pad, rows, starts, norms,
                       global_scale(corpus, norms))


def slab_rows(index: CosineIndex, ids: torch.Tensor) -> torch.Tensor:
    """The int8 slab rows of corpus rows `ids` (any shape; the sentinel n a
    zero row), as float64."""
    real = ids < index.n
    safe = torch.where(real, ids, 0)
    x = index.corpus[safe] / torch.clamp(index.norms[safe], min=1e-30)
    q = torch.clamp(torch.round(x / index.g), -127, 127)
    return torch.where(real[..., None], q, 0.0).to(F64)


def unit(q: torch.Tensor, precision: str) -> torch.Tensor:
    """Queries normalized in float64, as `precision` multiplies with them."""
    q64 = q.to(F64)
    qn = q64 / torch.clamp(torch.linalg.vector_norm(q64, dim=1, keepdim=True), min=1e-300)
    return operand(qn.float(), precision) if precision == "tf32" else qn


def query_buckets(index: CosineIndex, queries: torch.Tensor, precision: str = "float64"):
    """-> (bucket ids [q, L], least bit margin [q]) of the queries."""
    bits, margin = hash_bits(queries, index.proj, precision)
    return bucket_ids(bits, index.k, index.L), margin.min(dim=1).values


def windows(index: CosineIndex, q_buckets: torch.Tensor) -> torch.Tensor:
    """[q, L] absolute first rows of each window in the flat [L n_pad] slab."""
    a0 = aligned_starts(window_starts(index.starts, q_buckets, index.per_table),
                        index.per_table, index.n_pad)
    return a0 + torch.arange(index.L, device=a0.device)[None, :] * index.n_pad


def _dedup_top(score: torch.Tensor, ids: torch.Tensor, n: int, top_k: int):
    """Distinct real ids of [b, m] candidates (every copy of an id carries
    the same score), best top_k, equal scores lowest id first.  -> (scores,
    ids) [b, top_k], -inf and -1 past the distinct ids."""
    score = torch.where(ids < n, score, -math.inf)
    ids_s, perm = torch.sort(ids, dim=1, stable=True)
    s = torch.gather(score, 1, perm)
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    s = torch.where(dup, -math.inf, s)
    best, pos = torch.sort(s, dim=1, descending=True, stable=True)
    best, pos = best[:, :top_k], pos[:, :top_k]
    out = torch.where(best > -math.inf, torch.gather(ids_s, 1, pos), -1)
    return best, out


def _windows_sorted(index: CosineIndex, queries: torch.Tensor, q_buckets: torch.Tensor,
                    precision: str):
    """Every lane of the queries' windows, each window's lanes by int8 dot
    descending (equal dots lowest lane first): -> (dots, ids) [q, L, win]."""
    row0 = windows(index, q_buckets)                                   # [q, L]
    lanes = row0[:, :, None] + torch.arange(index.win, device=row0.device)
    ids = index.sorted_rows.reshape(-1)[lanes]
    dots = torch.einsum("qd,qlwd->qlw", unit(queries, precision), slab_rows(index, ids))
    v, lane = torch.sort(dots, dim=2, descending=True, stable=True)
    return v, torch.gather(ids, 2, lane)


def _pools(v: torch.Tensor, kk: int, slack: float):
    """Which lanes of windows sorted descending ([q, L, win]) any selection
    of the best kk by values within `slack` of these keeps (strict), and
    which it may keep (loose)."""
    rank = torch.arange(v.shape[2], device=v.device)
    nxt = v[:, :, kk:kk + 1] if kk < v.shape[2] else torch.full_like(v[:, :, :1], -math.inf)
    strict = (rank < kk) & (v > nxt + slack)
    loose = v >= v[:, :, kk - 1:kk] - slack
    return strict, loose


def window_topk(index: CosineIndex, queries: torch.Tensor, q_buckets: torch.Tensor,
                kk: int, top_k: int, precision: str = "float64", slack: float = 0.0):
    """Stage 1 and 2 over the queries' windows: -> (int8 dots [q, top_k]
    float64, ids [q, top_k] int64, -1 pad).  slack > 0 (in g-scaled dots)
    keeps at stage 1 only the lanes every selection within the slack keeps:
    the answer that any such selection matches or beats rank by rank."""
    v, ids = _windows_sorted(index, queries, q_buckets, precision)
    b = queries.shape[0]
    if slack > 0:
        keep, _ = _pools(v, kk, slack / float(index.g))
        v = torch.where(keep, v, -math.inf)
    else:
        v, ids = v[:, :, :kk], ids[:, :, :kk]
    return _dedup_top(v.reshape(b, -1), ids.reshape(b, -1), index.n, top_k)


def int8_sims(index: CosineIndex, queries: torch.Tensor, ids: torch.Tensor,
              precision: str = "float64") -> torch.Tensor:
    """g x (int8 row . unit query) of rows ids [q, m] (-1: -inf), float64."""
    qn = unit(queries, precision)
    real = ids >= 0
    rows = slab_rows(index, torch.where(real, ids, index.n))
    s = torch.einsum("qd,qmd->qm", qn, rows) * index.g.to(F64)
    return torch.where(real, s, -math.inf)


def cosines(corpus: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor,
            precision: str = "float64") -> torch.Tensor:
    """Exact cosine of the queries with rows ids [q, m] (-1: -inf)."""
    real = ids >= 0
    x = corpus[torch.where(real, ids, 0)]
    xn = torch.linalg.vector_norm(x.to(F64), dim=2)
    qn = torch.linalg.vector_norm(queries.to(F64), dim=1)
    dots = torch.einsum("qd,qmd->qm", operand(queries, precision), operand(x, precision))
    s = dots / torch.clamp(xn * qn[:, None], min=1e-300)
    return torch.where(real, s, -math.inf)


def retrieve(index: CosineIndex, queries: torch.Tensor, q_buckets: torch.Tensor,
             kk: int, top_core: int, top_k: int, precision: str = "float64",
             slack: float = 0.0):
    """Retrieval with the exact rerank: the best top_core by int8 dot,
    rescored by exact cosine.  -> (cosines [q, top_k], ids [q, top_k]).
    slack > 0 (in g-scaled dots) reranks only the candidates that every
    selection within the slack, at stage 1 and at the top_core cut, keeps."""
    if slack <= 0:
        _, cand = window_topk(index, queries, q_buckets, kk, top_core, precision)
    else:
        v, ids = _windows_sorted(index, queries, q_buckets, precision)
        s = slack / float(index.g)
        strict, loose = _pools(v, kk, s)
        b, m = queries.shape[0], v.shape[1] * v.shape[2]
        sv, sid = _dedup_top(torch.where(strict, v, -math.inf).reshape(b, m),
                             ids.reshape(b, m), index.n, m)
        lv, _ = _dedup_top(torch.where(loose, v, -math.inf).reshape(b, m),
                           ids.reshape(b, m), index.n, m)
        # loose rows within the slack of a strict row or above it, itself included
        above = torch.searchsorted(-lv, -(sv - s), right=True)
        cand = torch.where(torch.isfinite(sv) & (above <= top_core), sid, -1)
    sc = cosines(index.corpus, queries, cand, precision)
    best, pos = torch.sort(sc, dim=1, descending=True, stable=True)
    best, pos = best[:, :top_k], pos[:, :top_k]
    return best, torch.where(best > -math.inf, torch.gather(cand, 1, pos), -1)


def cf_predict(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, ids,
               precision: str = "float64") -> torch.Tensor:
    """Mean-centred CF over neighbours ids [q, P] (-1 pad) with similarities
    sims [q, P]: -> predictions [q, c] float64 (known coins keep their
    rating)."""
    valid = ids >= 0
    w = torch.where(valid, sims.to(F64), 0.0)
    safe = torch.where(valid, ids, 0)
    centred = torch.where(valid[..., None],
                          n_ratings[safe].to(F64) - n_mean[safe].to(F64)[..., None], 0.0)
    if precision == "tf32":
        w, centred = operand(w.float(), precision), operand(centred.float(), precision)
    total = torch.einsum("qp,qpc->qc", w, centred)
    abs_sum = w.abs().sum(1)
    delta = torch.where(abs_sum[:, None] > 0,
                        total / torch.clamp(abs_sum, min=1e-300)[:, None], 0.0)
    return torch.where(q_known, q_ratings.to(F64), q_mean.to(F64)[:, None] + delta)


def top_unknown(pred: torch.Tensor, known: torch.Tensor, n: int):
    """-> (values, coins) [q, n]: the best unknown coins, lowest index
    first among equals; -inf and -1 where fewer than n are unknown."""
    s = torch.where(known, -math.inf, pred)
    v, c = torch.sort(s, dim=1, descending=True, stable=True)
    v, c = v[:, :n], c[:, :n]
    return v, torch.where(v > -math.inf, c, -1)


def blocks(n: int, step: int):
    for s in range(0, n, step):
        yield slice(s, min(n, s + step))


def query_block(d: int, win: int, L: int, budget: int = 1 << 27) -> int:
    """Queries a block so one [b, L, win, d] float64 gather stays near 1 GB."""
    return max(1, budget // (L * win * d))
