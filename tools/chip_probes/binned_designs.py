#!/usr/bin/env python3
"""The tile-major probe bodies (P2 rounded_query and load_floor, P3, P4,
P5, P6) against the row-wise ones, at the probes' operating point.

On the probes' index (2M x 128 planted corpus, cosine k = 13, L = 8, window
488 -> win 640; benchmarks/experiments/_common): P3 (binned top-1) at
q = 8,192 on int8 and bf16 slabs, nbins 128 and 256: the tile-major kernel
(`binned_dots`, csrc/probetile.cu) against the previous row-wise body
(`binned_dots_rowwise`); P6 (int4 slabs) at q = 32,768, P2's rounded_query
(bf16), P4's i8_dot (int8), P2's load_floor (int8 and bf16) and P5
(blocked int8 and bf16 slabs) at q = 8,192: the tile-major kernel against
the row-wise body.
Each is first held against its plain version on 2,048 queries (values
within rtol 1e-5 / atol 1e-4, P3's winning lanes equal wherever a bin's
best two dots differ by more; i8_dot's dots and load_floor's output and
fold exactly), then timed in alternating rounds (CUDA
events, medians) beside the host-side schedule of the tile-major kernels
alone (the sort of the pairs by first row) and, for the record, K1's torch
work list at the same windows (`tile_plan`, ~25 small operations), with
the bound of the call (ops/kernels/bounds.py).  Each timed call ends in a
synchronize, so its time includes the host's dispatch of the wrapper's
small operations; the P2, P4 and P5 rows also time ten tile-major calls
back to back in one pair of events ("tiles_back_to_back", per call), where
the host runs ahead and the device time shows.

    python3 tools/chip_probes/binned_designs.py [--rounds 15]

Needs a CUDA device.  Prints the card first and the results as one JSON
line last (also written to chiprun_out/binned_designs.json).
"""

import argparse
import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from crypto_rec_tpu_torch.experiments import _common as C  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.index import pack_index  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels import (  # noqa: E402
    binned, blkslab, bounds, int4slab, slabvariants,
)
from crypto_rec_tpu_torch.ops.kernels.slabscore import (  # noqa: E402
    _geometry, slab_window_dots_plain, tile_plan, window_len,
)

Q3, Q6, CHECK_Q = 8192, 32768, 2048
TOL = dict(rtol=1e-5, atol=1e-4)


def check_p3(fn, p, nbins):
    """-> (max |err| of vals, bins whose winner differs though clear)."""
    c = (p.packed, p.s0[:CHECK_Q], p.qv[:CHECK_Q], p.per_table, nbins)
    vk, pk, ak = fn(*c)
    vp, pp, ap = binned.binned_dots_plain(*c)
    if not torch.equal(ak, ap) or not torch.allclose(vk, vp, **TOL):
        raise AssertionError(f"{fn.__name__}: kernel and plain differ")
    dots, _ = slab_window_dots_plain(p.packed, c[1], None, c[2], p.per_table, mask=False)
    top2 = torch.topk(dots.reshape(CHECK_Q, -1, nbins), 2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > TOL["atol"] + TOL["rtol"] * top2[:, 0].abs()
    bad = int(((pk != pp) & clear).sum())
    if bad:
        raise AssertionError(f"{fn.__name__}: {bad} clear winners differ")
    return float((vk - vp).abs().max())


def p3_rows(p, rounds):
    dname = str(p.packed.dtype)[6:]
    win = window_len(p.per_table)
    _, _, row0, _, _ = _geometry(p.packed, p.s0, None, p.per_table, False)
    n_rows = p.packed.shape[0] * p.packed.shape[1]
    out = []
    for nbins in (128, 256):
        err = check_p3(binned.binned_dots, p, nbins)
        a = (p.packed, p.s0, p.qv, p.per_table, nbins)
        t = C.timed_alternating({
            "tiles": lambda: binned.binned_dots(*a),
            "rowwise": lambda: binned.binned_dots_rowwise(*a),
            "sort": lambda: torch.sort(row0.reshape(-1)),
            "k1_work_list": lambda: tile_plan(p.packed, row0.contiguous(), None, None, win),
        }, p.packed.device, rounds)
        ms = {k: statistics.median(v) for k, v in t.items()}
        b = bounds.window_call(row0, win, n_rows, p.packed.shape[2] * p.packed.element_size(),
                               p.packed.shape[2], inputs=(p.qv,),
                               outputs=binned.binned_dots(*a))
        row = dict(kernel="P3 binned_dots", geometry=f"{dname} nbins {nbins}, q = {Q3}",
                   max_abs_err=err, ms=ms, bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   share_of_bound={k: b["bound_ms"] / ms[k]
                                   for k in ("tiles", "rowwise")})
        print(f"P3 {dname} nbins {nbins}: tiles {ms['tiles']:.3f} ms (sort "
              f"{ms['sort']:.3f}; K1's work list {ms['k1_work_list']:.3f}), row-wise "
              f"{ms['rowwise']:.3f}; bound {b['bound_ms']:.3f} ms ({b['bound_by']}); max "
              f"|err| {err:.3g}", flush=True)
        out.append(row)
    return out


def p6_row(p, rounds):
    p4 = int4slab.repack_int4(p.packed)
    c = (p4, p.s0[:CHECK_Q], p.qv[:CHECK_Q], p.per_table)
    (dk, ak), (dp, ap) = int4slab.slab_window_dots_int4(*c), \
        int4slab.slab_window_dots_int4_plain(*c)
    if not torch.equal(ak, ap) or not torch.allclose(dk, dp, **TOL):
        raise AssertionError("P6: kernel and plain differ")
    err = float((dk - dp).abs().max())
    del dk, dp
    a = (p4, p.s0, p.qv, p.per_table)
    win, _, row0 = int4slab._geometry4(p4, p.s0, p.per_table)
    t = C.timed_alternating({
        "tiles": lambda: int4slab.slab_window_dots_int4(*a),
        "rowwise": lambda: int4slab.slab_window_dots_int4_rowwise(*a),
        "sort": lambda: torch.sort(row0.reshape(-1)),
    }, p4.device, rounds)
    ms = {k: statistics.median(v) for k, v in t.items()}
    outs = int4slab.slab_window_dots_int4(*a)
    b = bounds.window_call(row0, win // 2, p4.shape[0] * p4.shape[1], p4.shape[2],
                           2 * p4.shape[2], inputs=(p.qv,), outputs=outs)
    print(f"P6 int4 q = {Q6}: tiles {ms['tiles']:.3f} ms (sort "
          f"{ms['sort']:.3f}), row-wise {ms['rowwise']:.3f}; bound "
          f"{b['bound_ms']:.3f} ms ({b['bound_by']}); max |err| {err:.3g}", flush=True)
    return dict(kernel="P6 slab_window_dots_int4", geometry=f"uint8 {list(p4.shape)}, "
                f"q = {Q6}", max_abs_err=err, ms=ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"],
                share_of_bound={k: b["bound_ms"] / ms[k] for k in ("tiles", "rowwise")})


def dots_row(kernel, geometry, designs, plain, row0, win, n_rows, row_bytes, d, qv,
             rounds, exact=False, bound=None):
    """A dots-writing kernel's designs (name -> fn of a query count, None
    for all) held against `plain` on the first CHECK_Q queries: the dots
    within TOL (exact: equal), the aligned starts and any further output
    (load_floor's fold) equal; then timed with the sort of its pairs.
    bound: a function of the tile-major call's outputs giving its bound in
    place of `bounds.window_call` on (row0, win)."""
    want = plain(CHECK_Q)
    errs = {}
    for name, fn in designs.items():
        got = fn(CHECK_Q)
        close = (torch.equal(got[0], want[0]) if exact
                 else torch.allclose(got[0], want[0], **TOL))
        if not close or not all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])):
            raise AssertionError(f"{kernel} {name}: kernel and plain differ")
        errs[name] = float((got[0] - want[0]).abs().max())
        del got
    del want
    t = C.timed_alternating({**{k: (lambda f=f: f(None)) for k, f in designs.items()},
                             "sort": lambda: torch.sort(row0.reshape(-1)),
                             "tiles_x10": lambda: [designs["tiles"](None) for _ in range(10)]},
                            qv.device, rounds)
    ms = {k: statistics.median(v) for k, v in t.items()}
    ms["tiles_back_to_back"] = ms.pop("tiles_x10") / 10
    outs = designs["tiles"](None)
    b = (bound(outs) if bound is not None else
         bounds.window_call(row0, win, n_rows, row_bytes, d, inputs=(qv,), outputs=outs))
    print(f"{kernel} {geometry}: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f" ms; bound {b['bound_ms']:.3f} ms ({b['bound_by']}); max |err| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()), flush=True)
    return dict(kernel=kernel, geometry=geometry, max_abs_err=errs, ms=ms,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                share_of_bound={k: b["bound_ms"] / ms[k] for k in designs})


def p2_row(p, rounds):
    """P2 rounded_query (bf16): tile-major against the row-wise body."""
    def args(q):
        return (p.packed, p.s0[:q], p.qv[:q], p.per_table)
    _, _, row0, _, _ = _geometry(p.packed, p.s0, None, p.per_table, False)
    return dots_row(
        "P2 rounded_query", f"bf16, q = {Q3}",
        {"tiles": lambda q: slabvariants.rounded_query_dots(*args(q)),
         "rowwise": lambda q: slabvariants.slab_window_variant_rowwise(*args(q))},
        lambda q: slabvariants.slab_window_variant_plain(*args(q), "rounded_query"),
        row0, window_len(p.per_table), p.packed.shape[0] * p.packed.shape[1],
        p.packed.shape[2] * 2, p.packed.shape[2], p.qv, rounds)


def variant_row(p, mode, rounds):
    """P4 i8_dot (int8 slabs, the queries quantized once, outside the
    timed calls) or P2 load_floor: the tile-major kernel against the
    row-wise body, exact against the plain version, with the mode's bound
    (`bounds.variant_call`: i8_dot on the int8 tensor cores, load_floor no
    operations)."""
    qv = slabvariants.quantize_queries(p.qv) if mode == "i8_dot" else p.qv

    def args(q):
        return (p.packed, p.s0[:q], qv[:q], p.per_table, mode)
    _, _, row0, _, _ = _geometry(p.packed, p.s0, None, p.per_table, False)
    return dots_row(
        f"P{4 if mode == 'i8_dot' else 2} {mode}", f"{str(p.packed.dtype)[6:]}, q = {Q3}",
        {"tiles": lambda q: slabvariants.slab_window_variant(*args(q)),
         "rowwise": lambda q: slabvariants.slab_window_variant_rowwise(*args(q))},
        lambda q: slabvariants.slab_window_variant_plain(*args(q)),
        row0, window_len(p.per_table), p.packed.shape[0] * p.packed.shape[1],
        p.packed.shape[2] * p.packed.element_size(), p.packed.shape[2], qv, rounds,
        exact=True, bound=lambda outs: bounds.variant_call(*args(None)[:4], mode, outs))


def p5_row(p, rounds):
    """P5 (blocked slabs): the tile-major kernel against the row-wise body."""
    blk = blkslab.to_blk(p.packed)

    def args(q):
        return (blk, p.s0[:q], p.qv[:q], p.per_table)
    win, _, blk0 = blkslab._geometry_blk(blk, p.s0, p.per_table)
    return dots_row(
        "P5 blk_window_dots", f"{str(blk.dtype)[6:]}, q = {Q3}",
        {"tiles": lambda q: blkslab.blk_window_dots(*args(q)),
         "rowwise": lambda q: blkslab.blk_window_dots_rowwise(*args(q))},
        lambda q: blkslab.blk_window_dots_plain(*args(q)),
        blk0 * blkslab.B, win, p.packed.shape[0] * p.packed.shape[1],
        p.packed.shape[2] * p.packed.element_size(), p.packed.shape[2], p.qv, rounds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--n", type=int, default=C.N)
    args = ap.parse_args(argv)
    C.require_cuda()
    card = C.card()
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    corpus, queries, true_idx = C.make_corpus("planted", args.n, Q6, 0, dev)
    index = C.build_cosine(corpus, 40)
    rows = []
    for dt in (torch.int8, torch.bfloat16):
        pidx = pack_index(index, corpus, dtype=dt)
        p = C.probe_index(pidx, queries[:Q3])
        rows += p3_rows(p, args.rounds)
        if dt == torch.int8:
            rows.append(p6_row(C.probe_index(pidx, queries), args.rounds))
            rows.append(variant_row(p, "i8_dot", args.rounds))
        else:
            rows.append(p2_row(p, args.rounds))
        rows.append(variant_row(p, "load_floor", args.rounds))
        rows.append(p5_row(p, args.rounds))
        del pidx
        torch.cuda.empty_cache()
    line = json.dumps({"card": card, "rows": rows})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "binned_designs.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
