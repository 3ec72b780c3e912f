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

The load floor runs beside K1 in alternating rounds (`floor_vs_k1`): the
tile-major floor ("zeros" as the probe runs it: one block a tile of slab
rows, each covered row read once) beside the tile-major K1 ("vpu").  It
prints the medians, their spread, the per-round ratio floor / K1, and two
rates: the logical window bytes (what a body with one block a window
reads) and the covered bytes (the slab rows some window covers, what a
tile-major body reads) over each time.  The floor writes K1's
[q, L, win] f32 output.

    python -m crypto_rec_tpu_torch.experiments.probe_r3_split [--n N] [--q Q]
"""

from __future__ import annotations

import statistics

import torch

from crypto_rec_tpu_torch.experiments import _common as C
from crypto_rec_tpu_torch.models.lsh.index import pack_index
from crypto_rec_tpu_torch.ops.kernels.bounds import covered_rows
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _geometry, slab_topk, slab_window_dots, window_len,
)
from crypto_rec_tpu_torch.ops.kernels.slabvariants import PROBE_MODES, slab_window_variant

VARIANTS = ("zeros", "vpu", "mxu_rep", "mxu_tile")
ROUNDS = 31


def floor_vs_k1(p: C.ProbeIndex, rounds: int = ROUNDS) -> dict:
    """The tile-major load floor beside the tile-major K1 (without the
    mask), in `rounds` alternating rounds on the same windows: each one's
    times, the per-round ratios floor / K1 (`tile_ratio_rounds`), and the
    rates of logical window bytes and of covered slab bytes.  Works on int8
    and bf16 slabs."""
    times = C.timed_alternating({
        "zeros": lambda: slab_window_variant(p.packed, p.s0, p.qv, p.per_table,
                                             "load_floor"),
        "vpu": lambda: slab_window_dots(p.packed, p.s0, p.sizes, p.qv, p.per_table,
                                        mask=False),
    }, p.packed.device, rounds)
    floor, k1 = times["zeros"], times["vpu"]
    res = dict(dtype=str(p.packed.dtype)[6:], rounds=rounds, floor_rounds_ms=floor,
               k1_rounds_ms=k1,
               tile_ratio_rounds=None if k1 is None else [f / k for f, k in zip(floor, k1)])
    for key, xs in (("zeros_ms", floor), ("vpu_ms", k1)):
        res[key] = None if xs is None else statistics.median(xs)
    q, L, d = p.qv.shape[0], p.packed.shape[0], p.packed.shape[2]
    win = window_len(p.per_table)
    row_bytes = d * p.packed.element_size()
    window_bytes = q * L * win * row_bytes
    row0 = _geometry(p.packed, p.s0, None, p.per_table, False)[2]
    covered_bytes = covered_rows(row0, win, L * p.packed.shape[1]) * row_bytes
    res["window_gb"], res["covered_gb"] = window_bytes / 1e9, covered_bytes / 1e9
    for name, key in (("load_floor", "zeros_ms"), ("k1", "vpu_ms")):
        res[f"{name}_gbps"] = C.gbps(window_bytes, res[key])
        res[f"{name}_covered_gbps"] = C.gbps(covered_bytes, res[key])
    return res


def report_floor(res: dict) -> None:
    print(f"load floor vs K1 ({res['dtype']}, {res['rounds']} alternating rounds, "
          f"median (min-max)): tile-major floor {C.spread(res['floor_rounds_ms'])} ms, "
          f"tile-major K1 {C.spread(res['k1_rounds_ms'])} ms, per-round ratio "
          f"{C.spread(res['tile_ratio_rounds'])}", flush=True)
    if res["load_floor_gbps"] is not None:
        rates = ", ".join(
            f"{label} {res[f'{name}_gbps']:.0f} / {res[f'{name}_covered_gbps']:.0f}"
            for label, name in (("tile-major floor", "load_floor"), ("tile-major K1", "k1")))
        print(f"GB/s of logical window bytes ({res['window_gb']:.2f} GB) / of covered slab "
              f"bytes ({res['covered_gb']:.2f} GB): {rates}", flush=True)


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
