"""P5 probe: block-transposed slabs against the row layout.

Port of `benchmarks/experiments/probe_r4_blk.py` on the card, on the
planted clustered corpus, q = 8,192, int8 and bf16: K1 (row layout, no
mask) against `blk_window_dots` over the same slabs blocked by `to_blk`,
and the probe's parity number: max |blocked - row| over the first 8
queries' lanes, with K1 run at starts pre-aligned to 128 so the lanes line
up.

    python -m crypto_rec_tpu_torch.experiments.probe_r4_blk [--n N] [--q Q]
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.experiments import _common as C
from crypto_rec_tpu_torch.models.lsh.index import pack_index
from crypto_rec_tpu_torch.ops.kernels.blkslab import B, blk_window_dots, to_blk
from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_window_dots


def run_blk(p: C.ProbeIndex) -> dict:
    dev = p.packed.device
    packed_blk = to_blk(p.packed)
    res = {}
    res["row_ms"], _ = C.timed(lambda: slab_window_dots(
        p.packed, p.s0, p.sizes, p.qv, p.per_table, mask=False), dev)
    res["blk_ms"], (dots_b, _) = C.timed(lambda: blk_window_dots(
        packed_blk, p.s0, p.qv, p.per_table), dev)
    del packed_blk
    dots_r, _ = slab_window_dots(p.packed, (p.s0 // B) * B, p.sizes, p.qv, p.per_table,
                                 mask=False)
    w = min(dots_b.shape[2], dots_r.shape[2])
    res["max_abs_diff"] = float((dots_b[:8, :, :w] - dots_r[:8, :, :w]).abs().max())
    res["max_abs_dot"] = float(dots_r[:8].abs().max())
    return res


def report(res: dict, dname: str) -> None:
    def ms(v):
        return "not measured" if v is None else f"{v:.3f} ms"

    print(f"[{dname}] row-layout kernel: {ms(res['row_ms'])}", flush=True)
    print(f"[{dname}] blk-layout kernel: {ms(res['blk_ms'])}", flush=True)
    print(f"[{dname}] max |blk - row| on shared lanes: {res['max_abs_diff']:.5f}",
          flush=True)


def main(argv=None) -> int:
    args, dev = C.start(argv, __doc__)
    corpus, queries, _ = C.make_corpus("planted", args.n, args.q, args.seed, dev)
    index = C.build_cosine(corpus, args.seed + 1)
    for dname, dt in (("int8", torch.int8), ("bfloat16", torch.bfloat16)):
        pidx = pack_index(index, corpus, dtype=dt)
        report(run_blk(C.probe_index(pidx, queries)), dname)
        del pidx
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
