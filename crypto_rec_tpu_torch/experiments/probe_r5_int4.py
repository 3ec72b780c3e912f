"""P6 probe: int4 nibble-packed slabs against int8.

Port of `benchmarks/experiments/probe_r5_int4.py` on the card, on the
planted clustered corpus, q = 32,768: the int8 global-scale slabs are
requantized to int4 (`repack_int4`); the raw K1 (int8, no mask) and int4
kernels' ms and logical slab GB/s, with int4's int8-equivalent rate (int8
bytes over the int4 time); then full retrieval (kernel + per-table top-k)
for both, with ms, q/s and recall@10 against the planted truth.

    python -m crypto_rec_tpu_torch.experiments.probe_r5_int4 [--n N] [--q Q]
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.experiments import _common as C
from crypto_rec_tpu_torch.models.lsh.index import pack_index
from crypto_rec_tpu_torch.ops.kernels.int4slab import (
    repack_int4, slab_topk_int4, slab_window_dots_int4, window_len4,
)
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    slab_topk, slab_window_dots, window_len,
)

Q4 = 32768


def run_int4(p: C.ProbeIndex, top_k: int = C.TOP_K) -> dict:
    """p: int8 global-scale slabs."""
    dev = p.packed.device
    packed4 = repack_int4(p.packed)
    q, L, d = p.qv.shape[0], p.packed.shape[0], p.packed.shape[2]

    def k8():
        return slab_window_dots(p.packed, p.s0, p.sizes, p.qv, p.per_table, mask=False)

    def k4():
        return slab_window_dots_int4(packed4, p.s0, p.qv, p.per_table)

    res = dict(int8_gb=p.packed.numel() / 1e9, int4_gb=packed4.numel() / 1e9,
               window_gb8=q * L * window_len(p.per_table) * d / 1e9,
               window_gb4=q * L * (window_len4(p.per_table) // 2) * d / 1e9)
    res["raw8_ms"], _ = C.timed(k8, dev)
    res["raw4_ms"], _ = C.timed(k4, dev)
    res["full8_ms"], (_, ids8) = C.timed(
        lambda: slab_topk(*k8(), p.packed_rows, p.n_rows, top_k, exact=False), dev)
    res["full4_ms"], (_, ids4) = C.timed(
        lambda: slab_topk_int4(*k4(), p.packed_rows, p.n_rows, top_k), dev)
    res["recall8"], res["recall4"] = C.recall(ids8, p), C.recall(ids4, p)
    return res


def report(res: dict, q: int) -> None:
    print(f"int8 slabs {res['int8_gb']:.2f} GB -> int4 {res['int4_gb']:.2f} GB", flush=True)
    for key, gb, extra in (("raw8_ms", "window_gb8", ""),
                           ("raw4_ms", "window_gb4", "window_gb8")):
        line = f"raw int{key[3]} kernel: {C.rate(res[key], q)}"
        if res[key] is not None:
            line += f"  {C.gbps(res[gb] * 1e9, res[key]):.0f} GB/s slab"
            if extra:
                line += f" ({C.gbps(res[extra] * 1e9, res[key]):.0f} int8-equiv)"
        print(line, flush=True)
    for bits in ("8", "4"):
        print(f"full int{bits}: {C.rate(res[f'full{bits}_ms'], q)}  recall "
              f"{C.fmt_recall(res[f'recall{bits}'])}", flush=True)


def main(argv=None) -> int:
    args, dev = C.start(argv, __doc__, q=Q4)
    corpus, queries, true_idx = C.make_corpus("planted", args.n, args.q, args.seed, dev)
    pidx = pack_index(C.build_cosine(corpus, args.seed + 1), corpus, dtype=torch.int8)
    report(run_int4(C.probe_index(pidx, queries, true_idx=true_idx)), args.q)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
