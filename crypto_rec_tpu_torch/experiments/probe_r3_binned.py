"""P3 probe: the in-kernel strided binned top-1 reduction.

Port of `benchmarks/experiments/probe_r3_binned.py` on the card, on the
planted clustered corpus, q = 8,192: binned retrieval (`retrieve_binned`)
for bf16 and int8 slabs and nbins 128 and 256, with ms, q/s and recall@10
against the planted truth.  Beside it, the binned kernel alone and the
K1 path it replaces (K1 without the mask + the per-table top-k epilogue).

    python -m crypto_rec_tpu_torch.experiments.probe_r3_binned [--n N] [--q Q]
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.experiments import _common as C
from crypto_rec_tpu_torch.models.lsh.index import pack_index
from crypto_rec_tpu_torch.ops.kernels.binned import binned_dots, retrieve_binned
from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_topk, slab_window_dots

NBINS = (128, 256)


def run_binned(p: C.ProbeIndex, nbins_list=NBINS, top_k: int = C.TOP_K) -> dict:
    dev = p.packed.device

    def k1_path():
        dots, a0 = slab_window_dots(p.packed, p.s0, p.sizes, p.qv, p.per_table,
                                    mask=False)
        return slab_topk(dots, a0, p.packed_rows, p.n_rows, top_k, exact=False)

    res = {}
    res["k1_path_ms"], (_, ids) = C.timed(k1_path, dev)
    res["k1_path_recall"] = C.recall(ids, p)
    for nbins in nbins_list:
        res[f"kernel{nbins}_ms"], _ = C.timed(
            lambda: binned_dots(p.packed, p.s0, p.qv, p.per_table, nbins), dev)
        res[f"binned{nbins}_ms"], (_, ids) = C.timed(
            lambda: retrieve_binned(p.packed, p.packed_rows, p.bucket_starts, p.n_rows,
                                    p.qv, p.q_buckets, p.per_table, top_k, nbins), dev)
        res[f"binned{nbins}_recall"] = C.recall(ids, p)
    return res


def report(res: dict, dname: str, q: int, nbins_list=NBINS) -> None:
    print(f"{dname} K1 + per-table topk: {C.rate(res['k1_path_ms'], q)}  "
          f"recall {C.fmt_recall(res['k1_path_recall'])}", flush=True)
    for nbins in nbins_list:
        print(f"{dname} binned{nbins}: {C.rate(res[f'binned{nbins}_ms'], q)}  recall "
              f"{C.fmt_recall(res[f'binned{nbins}_recall'])}  (kernel alone "
              f"{C.rate(res[f'kernel{nbins}_ms'], q)})", flush=True)


def main(argv=None) -> int:
    args, dev = C.start(argv, __doc__)
    corpus, queries, true_idx = C.make_corpus("planted", args.n, args.q, args.seed, dev)
    index = C.build_cosine(corpus, args.seed + 1)
    for dname, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        pidx = pack_index(index, corpus, dtype=dt)
        report(run_binned(C.probe_index(pidx, queries, true_idx=true_idx)), dname, args.q)
        del pidx
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
