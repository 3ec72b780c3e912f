"""Serving CLI: answer queries from a checkpointed index.

Mode `retrieve` — nearest-neighbour lookups against a saved cosine or
euclidean LSH index + corpus (archives from either package):

    python -m crypto_rec_tpu_torch.serve_cli retrieve \\
        --index idx.npz --corpus corpus.npz --queries q.csv \\
        --top-k 10 --pack -o out.tsv

A euclidean index is served with `--pack --augment` (augmented bf16 slabs,
scores are negated distances) unless its archive carries augmented slabs.

corpus.npz holds {"vectors": [n, d]}; queries are "id,v1,v2,..." rows; each
output line is the query id followed by tab-separated "row:score" pairs.
The index, corpus and queries go to `--device`: `cuda` (the default) runs
the Hopper kernels and exits with an error when there is no NVIDIA GPU;
`cpu` runs the kernels' plain PyTorch versions.  The `recommend` mode is
not ported yet (ROADMAP Queue 1 item 9).
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
    r.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (default): the Hopper kernels, and an error without a GPU; "
             "cpu: their plain PyTorch versions",
    )
    r.add_argument("-o", dest="output", required=True)
    return p


def _retrieve(args) -> int:
    from crypto_rec_tpu_torch.checkpoint import load_index
    from crypto_rec_tpu_torch.io.readers import read_dense_vectors
    from crypto_rec_tpu_torch.models.lsh.index import pack_index, retrieve_topk

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but no NVIDIA GPU is available "
              "(pass --device cpu to run the plain PyTorch versions)",
              file=sys.stderr)
        return 2
    dev = torch.device(args.device)
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


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    return _retrieve(args)


if __name__ == "__main__":
    sys.exit(main())
