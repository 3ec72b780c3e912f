#!/usr/bin/env python3
"""Recall@10 of the single euclidean cube (chip_smoke phase 10's leg:
k = 13, w = 8, 64 directed probes, window 976, int8 augmented slabs,
q = 32,768) over several draws of its hash functions, on two planted
corpora: 32,768 planted queries (chip_smoke's) and 65,536 (bench.py's
QMAX at N = 2M).  Optional argument: an npz with a handed-over family
(proj [128, 13], offsets [1, 13], mix_mul [13], mix_add [13]), run as one
more draw; bench.py's own draw is the JAX package's
build_hypercube(PRNGKey(7), ..., "euclidean", 13, 8.0) family and mixes,
saved with numpy on a machine that has JAX.

    python3 tools/chip_probes/euclid_cube_draws.py [family.npz]

Needs a CUDA device.  Prints one line per (corpus, draw) and the card.
"""

import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.hypercube import (  # noqa: E402
    build_hypercube, cube_retrieve_topk, pack_cube,
)
from crypto_rec_tpu_torch.models.lsh.pstable import PStableLsh  # noqa: E402
from crypto_rec_tpu_torch.ops.oracle import recall_at_k  # noqa: E402

N, D, K, W, PROBES, PT, Q = 2_000_000, 128, 13, 8.0, 64, 976, 32768


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    handed = None
    if len(sys.argv) > 1:
        z = np.load(sys.argv[1])
        handed = dict(
            family=PStableLsh(proj=torch.from_numpy(z["proj"]).to(dev),
                              offsets=torch.from_numpy(z["offsets"]).to(dev),
                              weights=torch.zeros(1, K, dtype=torch.int32, device=dev),
                              w=W, k=K, L=1),
            mix_mul=torch.from_numpy(z["mix_mul"]).to(dev),
            mix_add=torch.from_numpy(z["mix_add"]).to(dev))
    for planted in (32768, 65536):
        corpus, queries, true_idx = planted_clustered_corpus(
            torch.Generator(device=dev).manual_seed(0), N, D, planted, 10)
        qs, truth = queries[:Q], true_idx[:Q]
        draws = [(f"seed {s}", dict(generator=torch.Generator().manual_seed(s)))
                 for s in range(30, 38)]
        if handed is not None:
            draws.append(("handed-over family", dict(generator=None, **handed)))
        recalls = []
        for label, kw in draws:
            gen = kw.pop("generator")
            cube = pack_cube(build_hypercube(gen, corpus, "euclidean", K, W, **kw),
                             corpus, dtype=torch.int8, augment=True)
            _, ids = cube_retrieve_topk(cube, qs, corpus, 10, PROBES, PT)
            r = recall_at_k(ids, truth)
            recalls.append(r)
            occ = torch.bincount(cube.vertices.long(), minlength=1 << K)
            print(f"planted {planted}: {label}: recall@10 {r:.4f} (largest vertex "
                  f"{int(occ.max())} rows, occupied vertices {int((occ > 0).sum())})",
                  flush=True)
            del cube
        print(f"planted {planted}: seeds 30-37 recall min {min(recalls[:8]):.4f} "
              f"median {float(np.median(recalls[:8])):.4f} max {max(recalls[:8]):.4f}",
              flush=True)
        del corpus
    return 0


if __name__ == "__main__":
    sys.exit(main())
