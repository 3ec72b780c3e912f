"""P4 probe: the final slab-kernel design, end to end with recall.

Port of `benchmarks/experiments/probe_r3_final.py` on the card, on the
planted clustered corpus, q = 8,192, with ms, q/s and recall@10:

  bf16 masked+exact      K1 (mask=True) + the flat exact top-k epilogue
  bf16 nomask+exact      `retrieve_nomask`, m1 = L * top_k
  bf16 nomask+approx80   the same; the probe's approx_max_k stage 1 is an
  bf16 nomask+approx40   exact top-k here (m1 = 80 and 40), labels kept
  int8 vpu nomask+approx80   K1 dots on int8 slabs, f32 queries
  int8 mxu nomask+approx80   `i8_dot`: int8 slabs x per-row int8 queries

The probe's timing of the corpus generator is not kept.

    python -m crypto_rec_tpu_torch.experiments.probe_r3_final [--n N] [--q Q]
"""

from __future__ import annotations

from typing import Tuple

import torch

from crypto_rec_tpu_torch.experiments import _common as C
from crypto_rec_tpu_torch.models.lsh.index import pack_index
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _window_offsets, slab_topk, slab_window_dots,
)
from crypto_rec_tpu_torch.ops.kernels.slabvariants import (
    quantize_queries, slab_window_variant,
)


def retrieve_nomask(
    packed: torch.Tensor,         # [L, n_pad, d] CSR slabs
    packed_rows: torch.Tensor,    # [L, n_pad] int32 CSR row ids
    bucket_starts: torch.Tensor,  # [L, n_buckets + 1]
    n_rows: int,
    queries: torch.Tensor,        # [q, d] f32 normalized (int8 for mxu_i8)
    q_buckets: torch.Tensor,      # [q, L]
    per_table: int,
    top_k: int,
    m1: int,
    score: str = "vpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """probe_r3_final.py:132-156 with an exact stage 1: maskless window
    dots (score "vpu": K1; "mxu_i8": `i8_dot`), a flat top-m1 over each
    query's [L * win] lanes, their row ids, then the dedup top-k: the flat
    branch of `slab_topk`, whose `_dedup_topk_pairs` is the probe's
    `dedup_topk` (:117-129).  m1 runs from top_k to L * top_k."""
    L = packed.shape[0]
    if not top_k <= m1 <= L * top_k:
        raise ValueError(f"m1={m1} must lie in [{top_k}, {L * top_k}]")
    s0, sizes = _window_offsets(bucket_starts, q_buckets, per_table)
    if score == "vpu":
        dots, a0 = slab_window_dots(packed, s0, sizes, queries, per_table, mask=False)
    elif score == "mxu_i8":
        dots, a0 = slab_window_variant(packed, s0, queries, per_table, "i8_dot")
    else:
        raise ValueError(f"unknown score {score!r}")
    return slab_topk(dots, a0, packed_rows, n_rows, top_k, stage1_width=m1)


def run_final(p16: C.ProbeIndex, p8: C.ProbeIndex, top_k: int = C.TOP_K) -> dict:
    """p16 / p8: the same index and queries with bf16 / int8 slabs."""
    dev = p16.packed.device
    L = p16.packed.shape[0]

    def masked_exact():
        dots, a0 = slab_window_dots(p16.packed, p16.s0, p16.sizes, p16.qv,
                                    p16.per_table, mask=True)
        return slab_topk(dots, a0, p16.packed_rows, p16.n_rows, top_k)

    def nomask(p, m1, score="vpu", queries=None):
        return lambda: retrieve_nomask(
            p.packed, p.packed_rows, p.bucket_starts, p.n_rows,
            p.qv if queries is None else queries, p.q_buckets, p.per_table, top_k, m1,
            score)

    q_i8 = quantize_queries(p8.qv)
    rows = [("bf16 masked+exact", masked_exact, p16),
            ("bf16 nomask+exact", nomask(p16, L * top_k), p16),
            ("bf16 nomask+approx80", nomask(p16, L * top_k), p16),
            ("bf16 nomask+approx40", nomask(p16, 4 * top_k), p16),
            ("int8 vpu nomask+approx80", nomask(p8, L * top_k), p8),
            ("int8 mxu nomask+approx80", nomask(p8, L * top_k, "mxu_i8", q_i8), p8)]
    res = {}
    for name, fn, p in rows:
        ms, (_, ids) = C.timed(fn, dev)
        res[name] = dict(ms=ms, recall=C.recall(ids, p))
    return res


def report(res: dict, q: int) -> None:
    for name, r in res.items():
        print(f"{name:25s}: {C.rate(r['ms'], q)}  recall {C.fmt_recall(r['recall'])}",
              flush=True)


def main(argv=None) -> int:
    args, dev = C.start(argv, __doc__)
    corpus, queries, true_idx = C.make_corpus("planted", args.n, args.q, args.seed, dev)
    index = C.build_cosine(corpus, args.seed + 1)
    p16, p8 = (C.probe_index(pack_index(index, corpus, dtype=dt), queries,
                             true_idx=true_idx)
               for dt in (torch.bfloat16, torch.int8))
    report(run_final(p16, p8), args.q)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
