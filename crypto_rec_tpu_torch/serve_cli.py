"""Serving CLI: answer queries from checkpointed state.

Mode `retrieve` — nearest-neighbour lookups against a saved cosine or
euclidean LSH index + corpus (archives from either package):

    python -m crypto_rec_tpu_torch.serve_cli retrieve \\
        --index idx.npz --corpus corpus.npz --queries q.csv \\
        --top-k 10 [--pack [--augment]] -o out.tsv

Without `--pack` the unpacked gather path serves; `--pack` attaches bf16
slabs (`--augment`: the euclidean rank layout) unless the archive carries
slabs.  corpus.npz holds {"vectors": [n, d]}; queries are "id,v1,v2,..."
rows; each output line is the query id followed by tab-separated
"row:score" pairs.

Mode `recommend` — top-N coins for every user of a saved UserMatrix
(`checkpoint.save_user_matrix`), dense-mask cosine-LSH CF over the users
themselves (K2 hashes them):

    python -m crypto_rec_tpu_torch.serve_cli recommend \\
        --users users.npz --coins coins.tsv --top-n 5 -o out.txt

State goes to `--device`: `cuda` (the default) runs the Hopper kernels and
exits 2 when there is no NVIDIA GPU; `cpu` runs the kernels' plain
PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crypto_rec_tpu_torch.serve_cli")
    sub = p.add_subparsers(dest="mode", required=True)
    r = sub.add_parser("retrieve")
    r.add_argument("--index", required=True)
    r.add_argument("--corpus", required=True)
    r.add_argument("--queries", required=True)
    r.add_argument("--delimiter", default=",")
    r.add_argument("--top-k", type=int, default=10)
    r.add_argument("--per-table", type=int, default=256)
    r.add_argument(
        "--pack", action="store_true",
        help="attach the packed-slab layout (L bf16 corpus copies) after "
             "restore, unless the archive already carries slabs",
    )
    r.add_argument(
        "--augment", action="store_true",
        help="with --pack on a euclidean index: norm-augmented slabs, so "
             "retrieval rides the slab kernel",
    )
    r.add_argument(
        "--fast-int8", action="store_true",
        help="global-scale int8 indexes: rank raw dots and dequantize the "
             "scores (skip the exact rerank)",
    )
    r.add_argument("-o", dest="output", required=True)

    c = sub.add_parser("recommend")
    c.add_argument("--users", required=True)
    c.add_argument("--coins", required=True)
    c.add_argument("--delimiter", default="\t")
    c.add_argument("--top-n", type=int, default=5)
    c.add_argument("--top-p", type=int, default=20)
    c.add_argument("--lsh-k", type=int, default=4)
    c.add_argument("--lsh-l", type=int, default=5)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("-o", dest="output", required=True)
    for sp in (r, c):
        sp.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="cuda (default): the Hopper kernels, and exit 2 without a GPU; "
                 "cpu: their plain PyTorch versions",
        )
    return p


def _retrieve(args, dev) -> int:
    from crypto_rec_tpu_torch.checkpoint import load_index
    from crypto_rec_tpu_torch.io.readers import read_dense_vectors
    from crypto_rec_tpu_torch.models.lsh.index import pack_index, retrieve_topk

    index = load_index(args.index, dev)
    with np.load(args.corpus) as z:
        corpus = torch.from_numpy(z["vectors"]).to(dev)
    if corpus.shape[0] != index.n_rows:
        print(
            f"error: corpus rows {corpus.shape[0]} != index rows {index.n_rows}",
            file=sys.stderr,
        )
        return 1
    ids, queries = read_dense_vectors(args.queries, args.delimiter)
    if args.pack:
        if index.packed is not None:
            print("restored packed slabs from checkpoint", file=sys.stderr)
        else:
            index = pack_index(index, corpus, augment=args.augment)
    t0 = time.perf_counter()
    scores, rows = retrieve_topk(
        index, torch.from_numpy(queries).to(dev), corpus,
        top_k=args.top_k, per_table=args.per_table,
        int8_rerank=not args.fast_int8,
    )
    scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
    dt = time.perf_counter() - t0
    with open(args.output, "w") as out:
        for i, qid in enumerate(ids):
            pairs = [
                f"{int(r)}:{s:.5f}" for r, s in zip(rows[i], scores[i]) if r >= 0
            ]
            out.write("\t".join([qid] + pairs) + "\n")
    print(
        f"{len(ids)} queries in {dt*1e3:.1f} ms ({len(ids)/max(dt,1e-9):,.0f} q/s)",
        file=sys.stderr,
    )
    return 0


def recommend_users(um, coins, top_p: int, top_n: int, family, out) -> int:
    """Dense-mask CF of every user of `um` against all of them: the users'
    cosine index under `family` (CosineLsh, K2), the [n, n] candidate mask,
    `recommend`; writes a recommendation line per user with neighbours to
    `out`.  -> the number of such users."""
    from crypto_rec_tpu_torch.io.readers import write_recommendations
    from crypto_rec_tpu_torch.models.lsh.index import build_index, candidate_mask
    from crypto_rec_tpu_torch.models.rec.engine import RatingSet, recommend

    dev = family.proj.device
    users = RatingSet.from_user_matrix(um, dev)
    index = build_index(None, users.ratings, "cosine", family.k, family.L,
                        family=family)
    mask = candidate_mask(index, users.ratings)
    rec = recommend(users, users, mask, top_p=top_p, top_n=top_n)
    top = rec.top_n.cpu().numpy()
    has = rec.has_neighbors.cpu().numpy()
    for i, uid in enumerate(um.ids):
        if has[i]:
            write_recommendations(out, uid, top[i], coins.queries)
    return int(has.sum())


def _recommend(args, dev) -> int:
    from crypto_rec_tpu_torch.checkpoint import load_user_matrix
    from crypto_rec_tpu_torch.io.ingest import CoinTable
    from crypto_rec_tpu_torch.io.readers import read_str_vectors
    from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh

    um = load_user_matrix(args.users)
    coins = CoinTable.from_rows(read_str_vectors(args.coins, args.delimiter)[0])
    family = CosineLsh.create(torch.Generator().manual_seed(args.seed),
                              um.ratings.shape[1], args.lsh_k, args.lsh_l, dev)
    with open(args.output, "w") as out:
        n = recommend_users(um, coins, args.top_p, args.top_n, family, out)
    print(f"recommended for {n}/{len(um.ids)} users", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no NVIDIA GPU is available "
              "(pass --device cpu to run the plain PyTorch versions)",
              file=sys.stderr)
        return 2
    dev = torch.device(args.device)
    return (_retrieve if args.mode == "retrieve" else _recommend)(args, dev)


if __name__ == "__main__":
    sys.exit(main())
