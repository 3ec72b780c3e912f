"""P1 probe: the slab kernel's masking strategy, kernel against epilogue.

Port of `benchmarks/experiments/probe_r3_mask.py` on the card, on a random
N(0, 1) corpus (timing only, no recall), bf16 slabs, q = 8,192:

  A  K1 with the in-kernel mask (mask=True)
  B  the per-table top-k epilogue (`slab_topk`, exact=False) alone
  C  K1 without the mask (the probe's `dots_nomask`)
  D  C + B
  E  C, the mask applied outside the kernel, then B

and the probe's two agreement checks: maskless scores >= masked scores rank
for rank, and the share of ids the two agree on.

    python -m crypto_rec_tpu_torch.experiments.probe_r3_mask [--n N] [--q Q]
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.experiments import _common as C
from crypto_rec_tpu_torch.models.lsh.index import pack_index
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _geometry, _mask, slab_topk, slab_window_dots,
)


def run_mask(p: C.ProbeIndex, top_k: int = C.TOP_K) -> dict:
    dev = p.packed.device

    def kern(mask):
        return slab_window_dots(p.packed, p.s0, p.sizes, p.qv, p.per_table, mask=mask)

    def topk(dots, a0):
        return slab_topk(dots, a0, p.packed_rows, p.n_rows, top_k, exact=False)

    def outside_mask():
        dots, a0 = kern(False)
        _, _, _, head, size = _geometry(p.packed, p.s0, p.sizes, p.per_table, False)
        return topk(_mask(dots, head, size), a0)

    res = {}
    res["A_kernel_mask_ms"], (dots, a0) = C.timed(lambda: kern(True), dev)
    res["B_topk_ms"], _ = C.timed(lambda: topk(dots, a0), dev)
    del dots, a0
    res["C_kernel_nomask_ms"], _ = C.timed(lambda: kern(False), dev)
    res["D_nomask_topk_ms"], (s_nm, i_nm) = C.timed(lambda: topk(*kern(False)), dev)
    res["E_outside_mask_topk_ms"], (s_xm, i_xm) = C.timed(outside_mask, dev)
    res["nomask_ge_masked"] = bool((s_nm + 1e-5 >= s_xm).all())
    res["id_agreement"] = float((i_nm == i_xm).float().mean())
    return res


def report(res: dict, q: int) -> None:
    for key, label in (("A_kernel_mask_ms", "A kernel (mask in kernel)"),
                       ("B_topk_ms", "B per-table topk only"),
                       ("C_kernel_nomask_ms", "C kernel (no mask)"),
                       ("D_nomask_topk_ms", "D nomask kern+topk"),
                       ("E_outside_mask_topk_ms", "E mask outside kern+topk")):
        print(f"{label:26s}: {C.rate(res[key], q)}", flush=True)
    print(f"rank-for-rank nomask >= masked: {res['nomask_ge_masked']}")
    print(f"id agreement nomask vs masked: {res['id_agreement']:.4f}", flush=True)


def main(argv=None) -> int:
    args, dev = C.start(argv, __doc__)
    corpus, queries, _ = C.make_corpus("normal", args.n, args.q, args.seed, dev)
    pidx = pack_index(C.build_cosine(corpus, args.seed + 1), corpus, dtype=torch.bfloat16)
    report(run_mask(C.probe_index(pidx, queries)), args.q)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
