#!/usr/bin/env python3
"""What ops/topk's tie-ordered selection costs on the card.

ops/topk returns equal values lowest index first (`lax.top_k`'s order)
through a stable descending sort of the row cut to k.  This times, at the
shape each caller hands it and on tied and on untied values, five
selections in alternating CUDA-event rounds:

  topk     `torch.topk` on the values: no tie order (the selection the
           port had before the tie rule);
  stable   ops/topk.topk_desc, the stable sort;
  keys     `torch.topk` over int64 keys, unique per row: the value's bits
           in total order above the inverted index;
  tail     `torch.topk` over int32 total-order keys, with the elements
           tied with the k-th key re-chosen lowest index first (a cumsum
           and a scatter over the row) and the k put in order;
  fix      on rows over 4,096 long with k at most an eighth of them,
           `torch.topk`, with the rows whose k-th value also lies past
           the k re-selected by the stable sort (one host sync) and the k
           put in order; the stable sort elsewhere;

and checks that all but topk pick the same indices.  keys, tail and fix
are the tie-exact selections that were tried in place of the sort.  Then
the callers with topk, stable and fix swapped into ops/topk (and into the
modules that import its topk_desc): phase 5's CF scoring
(`recommend_topk_retrieved`, 2M x 128 neighbours) at q = 8,192 and 32,768
and the streamed merge of four chunks' top-10 at q = 16,384 (CUDA
events); and `main -validate` on chip_smoke phase 13's dataset, phase ms
per selection (PhaseTimer, median of two runs after a warm run), where
the stable and fix runs must write the same file.  Then, at the shape of
each site that once called `torch.topk` and now sorts for lowest-index-
first ties (`SITES`: the exact oracle and its streamed merge, the directed
probes' two selections, the dedup epilogue, rerank_exact), `torch.topk`
against the stable sort (`topk_desc`, or `topk_asc` where the site takes
the smallest values) in alternating rounds.

    python3 tools/chip_probes/topk_select.py [--no-program] [--sites-only]

Needs a CUDA device.  Prints the card first and one JSON line last (also
written to chiprun_out/topk_select.json).
"""

import argparse
import contextlib
import io
import json
import os
import statistics
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from chip_smoke import PIPE  # noqa: E402
from crypto_rec_tpu_torch.experiments._common import card, timed_alternating  # noqa: E402
from crypto_rec_tpu_torch.models import ivf  # noqa: E402
from crypto_rec_tpu_torch.models.lsh import index, streamed  # noqa: E402
from crypto_rec_tpu_torch.ops import topk  # noqa: E402

DEV = torch.device("cuda")
ROUNDS = 11
CF_ROWS = 2_000_000        # phase 5's neighbour set

# (caller, rows, axis length m, k): the shapes the callers hand ops/topk
SHAPES = [
    ("cluster_A block: recommend, top-P = every co-member (phase 13)", 894, 20000, 20000),
    ("validate fold: recommend over the dense mask (phase 13)", 2000, 18000, 20),
    ("lsh_A: recommend_from_ids over the csr budget (phase 13)", 19997, 256, 20),
    ("CF top-N coins, q = 8,192 (phase 5)", 8192, 128, 5),
    ("CF top-N coins, q = 32,768 (phase 5)", 32768, 128, 5),
    ("streamed merge, q = 16,384 (phase 19)", 16384, 20, 10),
    ("IVF probe selection, 1,953 centroids (phase 20)", 256, 1953, 16),
    ("IVF scores, nprobe 16 x 1,024 rows (phase 20)", 256, 16384, 10),
    ("blocked core stage 1 (phases 17, 18)", 256, 4096, 80),
]


# (site, rows, axis length m, k, "desc" or "asc"): the repaired sites'
# shapes at chip_smoke's points
SITES = [
    ("ops/oracle exact_nearest: phase 5's oracle, 256 queries x 2M rows",
     256, 2_000_000, 10, "asc"),
    ("ops/oracle exact_nearest: a streamed slice of 2^18 rows, 64 queries",
     64, 1 << 18, 10, "asc"),
    ("ops/oracle exact_nearest: a streamed slice of 2^20 rows, 64 queries",
     64, 1 << 20, 10, "asc"),
    ("ops/oracle exact_nearest_streamed merge, 1,024 queries", 1024, 20, 10, "asc"),
    ("hypercube directed_probe_vertices: bit margins, k = 13, m = 8", 32768, 13, 8, "asc"),
    ("hypercube directed_probe_vertices: subset scores, 2^6 for 16 probes",
     32768, 64, 16, "asc"),
    ("hypercube directed_probe_vertices: subset scores, 2^8 for 64 probes",
     32768, 256, 64, "asc"),
    ("slabscore _dedup_topk_pairs: CF point, 8 x 12 survivors, top-20", 8192, 96, 20, "desc"),
    ("slabscore _dedup_topk_pairs: CF point at q = 32,768", 32768, 96, 20, "desc"),
    ("slabscore _dedup_topk_pairs: euclidean cube, 64 probes x 10", 32768, 640, 10, "desc"),
    ("index candidate_ids_scored stage 2 (_dedup_topk_pairs): budget 256", 8192, 256, 256,
     "desc"),
    ("index rerank_exact: 40 candidates, top-10", 8192, 40, 10, "desc"),
]


def sel_topk(values, k):
    v, i = torch.topk(values, k, dim=-1)
    return v, i


stable_topk = topk.topk_desc          # held here: the callers' runs swap it out


def _total_order(values):
    """int32 keys that order like the f32 values in IEEE total order."""
    bits = values.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def sel_keys(values, k):
    low = (1 << 32) - 1
    key = _total_order(values).long() * (1 << 32) + (
        low - torch.arange(values.shape[-1], device=values.device))
    top = torch.topk(key, k, dim=-1).values
    idx = low - (top & low)
    return torch.gather(values, -1, idx), idx


def _in_order(values, idx):
    """The k picked, ordered: value descending, equal values lowest index
    first."""
    idx = torch.sort(idx, dim=-1).values
    vals, order = torch.sort(torch.gather(values, -1, idx), dim=-1, descending=True,
                             stable=True)
    return vals, torch.gather(idx, -1, order)


def sel_tail(values, k):
    key = _total_order(values)
    top, idx = torch.topk(key, k, dim=-1)
    kth = top[..., -1:]
    need = (top == kth).sum(-1, keepdim=True)
    tied = key == kth
    rank = torch.cumsum(tied, dim=-1)
    slot = torch.where(tied & (rank <= need), rank + (k - 1 - need), k)
    idx = torch.cat([idx, idx[..., :1]], dim=-1)
    idx.scatter_(-1, slot, torch.arange(key.shape[-1], device=key.device).expand_as(slot))
    return _in_order(values, idx[..., :k])


def sel_fix(values, k):
    if values.shape[-1] <= 4096 or 8 * k > values.shape[-1]:
        return stable_topk(values, k)
    vals, idx = torch.topk(values, k, dim=-1)
    kth = vals[..., -1:]
    tied = ((values == kth).sum(-1) != (vals == kth).sum(-1)) | torch.isnan(kth[..., 0])
    rows = tied.nonzero(as_tuple=True)
    if rows[0].numel():
        idx[rows] = stable_topk(values[rows], k)[1]
    return _in_order(values, idx)


SELECTIONS = dict(topk=sel_topk, stable=stable_topk, keys=sel_keys, tail=sel_tail,
                  fix=sel_fix)
CALLER_SELECTIONS = ("topk", "stable", "fix")
USERS = (topk, index, streamed, ivf)            # modules that bind topk_desc


@contextlib.contextmanager
def swapped(fn):
    """ops/topk.topk_desc (and each module's import of it) set to fn; k
    above the axis length is cut to it, as the sort's slice cuts it."""
    saved = [m.topk_desc for m in USERS]
    for m in USERS:
        m.topk_desc = lambda values, k: fn(values, min(k, values.shape[-1]))
    try:
        yield
    finally:
        for m, f in zip(USERS, saved):
            m.topk_desc = f


def med(xs):
    return statistics.median(xs)


def values_of(g, kind, rows, m):
    """[rows, m] values on the card: "grid", 2,001 levels, so wide rows hold
    exact ties everywhere; "uniform" floats, where ties are rare."""
    if kind == "grid":
        return torch.randint(-1000, 1001, (rows, m), generator=g, device=DEV).float() / 1000
    return torch.rand(rows, m, generator=g, device=DEV)


def micro(g):
    """Each selection at each caller's shape on both kinds of
    `values_of`."""
    out = []
    for name, rows, m, k in SHAPES:
        for kind in ("grid", "uniform"):
            v = values_of(g, kind, rows, m)
            idx = {s: fn(v, k)[1] for s, fn in SELECTIONS.items()}
            same = all(torch.equal(idx["stable"], idx[s]) for s in ("keys", "tail", "fix"))
            t = timed_alternating({s: (lambda fn=fn: fn(v, k)) for s, fn in SELECTIONS.items()},
                                  DEV, ROUNDS)
            row = dict(caller=name, values=kind, shape=[rows, m], k=k, same_indices=same,
                       **{f"{s}_ms": med(t[s]) for s in SELECTIONS})
            out.append(row)
            print(f"{name} [{rows}, {m}] k = {k}, {kind}: " + ", ".join(
                f"{s} {row[s + '_ms']:.3f} ms" for s in SELECTIONS)
                + f"; stable / keys / tail / fix indices {'equal' if same else 'DIFFER'}",
                flush=True)
            if not same:
                raise AssertionError(f"{name}: the tie-exact selections disagree")
            del v, idx
    return out


def sites(g):
    """torch.topk against the stable sort at each repaired site's shape,
    on grid and uniform values (as `micro`); the sort's indices must be
    the lowest-index-first selection's."""
    out = []
    for name, rows, m, k, order in SITES:
        stable = topk.topk_desc if order == "desc" else topk.topk_asc
        fns = dict(topk=lambda v, k=k: torch.topk(v, k, dim=-1, largest=order == "desc"),
                   stable=lambda v, k=k: stable(v, k))
        for kind in ("grid", "uniform"):
            v = values_of(g, kind, rows, m)
            want = sel_keys(v if order == "desc" else -v, k)[1]
            if not torch.equal(fns["stable"](v)[1], want):
                raise AssertionError(f"{name}: the stable sort is not lowest index first")
            t = timed_alternating({s: (lambda fn=fn: fn(v)) for s, fn in fns.items()},
                                  DEV, ROUNDS)
            row = dict(site=name, values=kind, shape=[rows, m], k=k, order=order,
                       topk_ms=med(t["topk"]), stable_ms=med(t["stable"]))
            out.append(row)
            print(f"site {name} [{rows}, {m}] k = {k} ({order}), {kind}: torch.topk "
                  f"{row['topk_ms']:.3f} ms, stable sort {row['stable_ms']:.3f} ms "
                  f"({row['stable_ms'] / row['topk_ms']:.2f}x)", flush=True)
            del v, want
        torch.cuda.empty_cache()
    return out


def callers(g):
    """Phase 5's CF scoring and phase 19's merge with each selection."""
    from crypto_rec_tpu_torch.models.rec.engine import RatingSet, recommend_topk_retrieved

    n, d, top_p, top_n = CF_ROWS, 128, 20, 5
    corpus = torch.rand(n, d, generator=g, device=DEV)
    known = torch.rand(n, d, generator=g, device=DEV) < 0.6
    nset = RatingSet(corpus, known, (corpus * known).sum(1) / known.sum(1).clamp(min=1))
    out = {}
    for qn in (8192, 32768):
        qr = torch.rand(qn, d, generator=g, device=DEV)
        qk = torch.rand(qn, d, generator=g, device=DEV) < 0.6
        qset = RatingSet(qr, qk, (qr * qk).sum(1) / qk.sum(1).clamp(min=1))
        sims = torch.sort(torch.rand(qn, top_p, generator=g, device=DEV), dim=1,
                          descending=True).values
        nidx = torch.randint(0, n, (qn, top_p), generator=g, device=DEV, dtype=torch.int32)
        out[f"cf_scoring_q{qn}"] = _by_selection(
            lambda: recommend_topk_retrieved(qset, nset, sims, nidx, top_n))
    q, tk = 16384, 10
    parts = [(torch.rand(q, tk, generator=g, device=DEV),
              torch.randint(0, 4_000_000, (q, tk), generator=g, device=DEV,
                            dtype=torch.int32)) for _ in range(4)]

    def merge():
        bv = torch.full((q, tk), float("-inf"), device=DEV)
        bi = torch.full((q, tk), -1, dtype=torch.int32, device=DEV)
        for ci, (v, ids) in enumerate(parts):
            bv, bi = streamed.merge_topk(bv, bi, v, ids, ci * 4_000_000, tk)
        return bv, bi

    out["streamed_merge_4_chunks_q16384"] = _by_selection(merge)
    for name, r in out.items():
        print(f"{name}: " + ", ".join(f"{s} {ms:.3f} ms" for s, ms in r.items()), flush=True)
    return out


def _by_selection(fn):
    def under(sel):
        def run():
            with swapped(sel):
                return fn()
        return run

    t = timed_alternating({s: under(SELECTIONS[s]) for s in CALLER_SELECTIONS}, DEV, ROUNDS)
    return {s: med(v) for s, v in t.items()}


def program():
    """`main -validate` on phase 13's dataset with each selection."""
    from crypto_rec_tpu_torch import main as rec_main
    from crypto_rec_tpu_torch.io.synth import write_synthetic_dataset

    res = {s: [] for s in CALLER_SELECTIONS}
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        tweets, conf = write_synthetic_dataset(os.path.join(tmp, "ds"), **PIPE)

        def run(sel, out):
            buf = io.StringIO()
            with swapped(SELECTIONS[sel]), contextlib.redirect_stdout(buf):
                rc = rec_main.main(["-d", tweets, "-o", out, "-c", conf, "-validate"])
            if rc != 0:
                raise AssertionError(f"main exited {rc}")
            return json.loads(buf.getvalue().strip().splitlines()[-1])["phase_ms"]

        run("stable", os.path.join(tmp, "warm.txt"))       # kernels loaded
        for _ in range(2):
            for sel in res:
                out = os.path.join(tmp, f"{sel}.txt")
                res[sel].append(run(sel, out))
                with open(out) as f:
                    files[sel] = [x for x in f.read().splitlines()
                                  if not x.startswith("Execution Time")]
    phases = res["stable"][0].keys()
    ms = {s: {p: med([r[p] for r in runs]) for p in phases} for s, runs in res.items()}
    differ = {s: sum(a != b for a, b in zip(files[s], files["stable"])) for s in files}
    for s in ms:
        print(f"program {s}: phase ms {ms[s]}; {differ[s]} output lines differ from the "
              f"stable sort's", flush=True)
    if differ["fix"]:
        raise AssertionError("the stable sort and the fix wrote different files")
    return dict(phase_ms=ms, lines_differ_from_stable=differ)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-program", action="store_true",
                    help="skip the program runs on phase 13's dataset")
    ap.add_argument("--sites-only", action="store_true",
                    help="time only the repaired sites (SITES)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("topk_select: needs a CUDA device", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    g = torch.Generator(device=DEV).manual_seed(0)
    res = dict(card=smi, rounds=ROUNDS, sites=sites(g))
    torch.cuda.empty_cache()
    if not args.sites_only:
        res.update(micro=micro(g), callers=callers(g))
        torch.cuda.empty_cache()
        if not args.no_program:
            res["program"] = program()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "topk_select.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
