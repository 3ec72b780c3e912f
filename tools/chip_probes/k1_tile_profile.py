#!/usr/bin/env python3
"""Where the tile-major K1's time goes, and K2 against its yardsticks.

On chip_smoke's CF leg (2M x 128 planted corpus, cosine k = 13, L = 8,
int8 slabs, window 488) at q = 8,192 and 32,768, and on the euclidean
MultiCube geometry of chip_smoke phase 8 (q = 1,024): the work list
(`tile_plan`) and the kernel alone, in alternating rounds with the whole
wrapper (CUDA events), the item statistics, and a torch.profiler table of
one wrapper call.  Then K2 at L = 8 and L = 1: kernel, torch.matmul.

    python3 tools/chip_probes/k1_tile_profile.py

Needs a CUDA device.  Prints the card first.
"""

import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from crypto_rec_tpu_torch.experiments._common import timed_alternating  # noqa: E402
from crypto_rec_tpu_torch.io.synth import planted_clustered_corpus  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.hypercube import (  # noqa: E402
    build_multicube, multicube_windows,
)
from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh  # noqa: E402
from crypto_rec_tpu_torch.models.lsh.index import (  # noqa: E402
    build_index, pack_index, query_hashes,
)
from crypto_rec_tpu_torch.ops.kernels import slabscore as S  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.signproj import signproj_bucket_ids  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels.slabscore import augment_queries  # noqa: E402

N, D, K, L, PT = 2_000_000, 128, 13, 8, 488


def med(t, k):
    return f"{statistics.median(t[k]):.3f}"


def k1_pieces(label, packed, s0, sizes, qv, per_table, shared):
    """Wrapper, work list and kernel alone."""
    win, _, row0, head, size = S.card_geometry(packed, s0, sizes, qv, per_table, False,
                                               shared)
    q, T = s0.shape
    plan = S.tile_plan(packed, row0, head, size, win)
    qf = qv.float().contiguous()
    dots = torch.empty(q, T, win, device=packed.device)

    def kernel():
        S.tile_launch(packed, qf, plan, dots, False)
        return dots

    a = (packed, s0, sizes, qv, per_table)
    t = timed_alternating({
        "wrapper": lambda: S.slab_window_dots(*a, mask=False, shared_slab=shared),
        "plan": lambda: S.tile_plan(packed, row0, head, size, win),
        "kernel": kernel,
    }, packed.device, 7)
    cnt = plan[3]
    m = S.tile_shape(packed.dtype, packed.shape[2])[1]
    real = int((cnt > 0).sum())
    print(f"{label}: pairs {q * T}, items {cnt.numel()} listed / {real} real, "
          f"mean pairs {float(cnt[cnt > 0].float().mean()):.1f}, full "
          f"{int((cnt == m).sum())}; ms (median of 7 alternating rounds): wrapper "
          f"{med(t, 'wrapper')}, work list and fields {med(t, 'plan')}, kernel "
          f"{med(t, 'kernel')}",
          flush=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        S.slab_window_dots(*a, mask=False, shared_slab=shared)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=8), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    corpus, queries, _ = planted_clustered_corpus(g, N, D, 32768, 10)
    proj = CosineLsh.create(torch.Generator().manual_seed(1), D, K, L, dev).proj
    for LL, p in ((L, proj), (1, proj[:, :K].contiguous())):
        t = timed_alternating({
            "kernel": lambda: signproj_bucket_ids(corpus, p, K, LL),
            "matmul": lambda: torch.matmul(corpus, p),
        }, dev, 7)
        print(f"K2 L = {LL}: kernel {med(t, 'kernel')} ms, torch.matmul {med(t, 'matmul')}",
              flush=True)
    index = pack_index(build_index(None, corpus, "cosine", K, L, family=CosineLsh(proj, K, L)),
                       corpus, dtype=torch.int8)
    for q in (8192, 32768):
        qv = torch.nn.functional.normalize(queries[:q], dim=1)
        qb, _ = query_hashes(index, qv)
        s0, sizes = S._window_offsets(index.bucket_starts, qb, PT)
        k1_pieces(f"CF leg q = {q}", index.packed, s0, sizes, qv, PT, False)
    del index
    mc = build_multicube(torch.Generator(device=dev).manual_seed(8), corpus, "euclidean",
                         3, K, 8.0, corpus_dtype=torch.int8)
    qs = queries[:1024]
    q_aug = augment_queries(qs, mc.packed_aug_scale, mc.packed.shape[2])
    s0, sizes = multicube_windows(mc, qs, 24, 976)
    R = s0.shape[1] // 8
    k1_pieces("euclidean MultiCube q = 1024", mc.packed, s0.reshape(-1, 8),
              sizes.reshape(-1, 8), q_aug.repeat_interleave(R, dim=0), 976, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
