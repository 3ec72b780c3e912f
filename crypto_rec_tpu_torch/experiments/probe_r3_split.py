"""P2 probe: where the slab retrieval's time goes, and the scoring variants.

Port of `benchmarks/experiments/probe_r3_split.py` on the card, on a random
N(0, 1) corpus (timing only, no recall), bf16 slabs, q = 8,192:

  A  K1 (mask=True) + the per-table top-k epilogue
  B  K1 alone
  C  the epilogue alone on cached dots
  D/E  the window loop with each of the probe's scoring bodies: "zeros"
     (`load_floor`: every byte loaded, no arithmetic), "vpu" (K1 without
     the mask), "mxu_rep" and "mxu_tile" (both `rounded_query`: the query
     rounded to bf16).  The probe's nbuf / q_tile sweeps are TPU pipeline
     knobs with no counterpart here.

"zeros", K1's row-wise body (one block per window) and "vpu" (the
tile-major K1) run in alternating rounds (`floor_vs_k1`), so the load
floor is compared inside each round with the access pattern it bounds;
it prints the medians, their spread, the per-round ratio floor /
row-wise, and the logical window rates.  The load floor reads every
window from memory and writes K1's [q, L, win] f32 output, as the
row-wise body does: it bounds that body's loop, not the tile-major
kernel, which reads each covered slab row about once.

    python -m crypto_rec_tpu_torch.experiments.probe_r3_split [--n N] [--q Q]
"""

from __future__ import annotations

import statistics

import torch

from crypto_rec_tpu_torch.experiments import _common as C
from crypto_rec_tpu_torch.models.lsh.index import pack_index
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    slab_topk, slab_window_dots, slab_window_dots_rowwise, window_len,
)
from crypto_rec_tpu_torch.ops.kernels.slabvariants import PROBE_MODES, slab_window_variant

VARIANTS = ("zeros", "vpu", "mxu_rep", "mxu_tile")
ROUNDS = 31


def floor_vs_k1(p: C.ProbeIndex, rounds: int = ROUNDS) -> dict:
    """The load floor against the access pattern it bounds, K1's row-wise
    body without the mask (one block per window), in `rounds` alternating
    rounds with the tile-major K1 on the same windows: each one's times,
    and the per-round ratio load floor / row-wise K1.  Works on int8 and
    bf16 slabs."""
    args = (p.packed, p.s0, p.sizes, p.qv, p.per_table)
    times = C.timed_alternating({
        "rowwise": lambda: slab_window_dots_rowwise(*args, mask=False),
        "zeros": lambda: slab_window_variant(p.packed, p.s0, p.qv, p.per_table,
                                             "load_floor"),
        "vpu": lambda: slab_window_dots(*args, mask=False),
    }, p.packed.device, rounds)
    row, floor, k1 = times["rowwise"], times["zeros"], times["vpu"]
    res = dict(dtype=str(p.packed.dtype)[6:], rounds=rounds, rowwise_rounds_ms=row,
               floor_rounds_ms=floor, k1_rounds_ms=k1,
               ratio_rounds=None if row is None else [f / r for f, r in zip(floor, row)])
    for key, xs in (("rowwise_ms", row), ("zeros_ms", floor), ("vpu_ms", k1)):
        res[key] = None if xs is None else statistics.median(xs)
    q, L, d = p.qv.shape[0], p.packed.shape[0], p.packed.shape[2]
    window_bytes = q * L * window_len(p.per_table) * d * p.packed.element_size()
    res["window_gb"] = window_bytes / 1e9
    res["load_floor_gbps"] = C.gbps(window_bytes, res["zeros_ms"])
    res["rowwise_gbps"] = C.gbps(window_bytes, res["rowwise_ms"])
    res["k1_gbps"] = C.gbps(window_bytes, res["vpu_ms"])
    return res


def report_floor(res: dict) -> None:
    print(f"load floor vs row-wise K1 ({res['dtype']}, {res['rounds']} alternating "
          f"rounds, median (min-max)): load floor {C.spread(res['floor_rounds_ms'])} ms, "
          f"row-wise K1 {C.spread(res['rowwise_rounds_ms'])} ms, per-round ratio "
          f"{C.spread(res['ratio_rounds'])}; tile-major K1 "
          f"{C.spread(res['k1_rounds_ms'])} ms", flush=True)
    if res["load_floor_gbps"] is not None:
        print(f"logical window bytes {res['window_gb']:.2f} GB: load floor "
              f"{res['load_floor_gbps']:.0f} GB/s, row-wise K1 "
              f"{res['rowwise_gbps']:.0f} GB/s, tile-major K1 (vpu) "
              f"{res['k1_gbps']:.0f} GB/s", flush=True)


def run_split(p: C.ProbeIndex, top_k: int = C.TOP_K) -> dict:
    dev = p.packed.device

    def kern(mask=True):
        return slab_window_dots(p.packed, p.s0, p.sizes, p.qv, p.per_table, mask=mask)

    def topk(dots, a0):
        return slab_topk(dots, a0, p.packed_rows, p.n_rows, top_k, exact=False)

    res = {}
    res["B_kernel_ms"], (dots, a0) = C.timed(kern, dev)
    res["C_topk_ms"], _ = C.timed(lambda: topk(dots, a0), dev)
    del dots, a0
    res["A_kernel_topk_ms"], _ = C.timed(lambda: topk(*kern()), dev)
    res["floor"] = floor_vs_k1(p)
    for mode in VARIANTS:
        if mode in ("zeros", "vpu"):
            res[f"{mode}_ms"] = res["floor"][f"{mode}_ms"]
        else:
            res[f"{mode}_ms"], _ = C.timed(lambda: slab_window_variant(
                p.packed, p.s0, p.qv, p.per_table, PROBE_MODES[mode]), dev)
    return res


def report(res: dict, q: int) -> None:
    for key, label in (("B_kernel_ms", "B kernel only (mask)"),
                       ("C_topk_ms", "C topk epilogue only"),
                       ("A_kernel_topk_ms", "A kernel + topk")):
        print(f"{label:22s}: {C.rate(res[key], q)}", flush=True)
    for mode in VARIANTS:
        print(f"D/E {mode:18s}: {C.rate(res[f'{mode}_ms'], q)}", flush=True)
    report_floor(res["floor"])


def main(argv=None) -> int:
    args, dev = C.start(argv, __doc__)
    corpus, queries, _ = C.make_corpus("normal", args.n, args.q, args.seed, dev)
    pidx = pack_index(C.build_cosine(corpus, args.seed + 1), corpus, dtype=torch.bfloat16)
    report(run_split(C.probe_index(pidx, queries)), args.q)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
