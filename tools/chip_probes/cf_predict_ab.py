#!/usr/bin/env python3
"""The CF engine's prediction kernel (`csrc/cfpredict.cu`) and its top-N
through S1, on the card, at the CF cell's shape (cf-jester-73k-100: q =
n = 73,421 users, c = 100 coins, P = 20 neighbours, a quarter of the users
with their last four slots -1 pads, known density 0.56, top-5):

1. `nvcc -Xptxas -v` of cfpredict.cu: each instantiation's registers and
   spills;
2. the kernel against `cf_predict_plain` on the same card tensors (max
   |err|, held to rtol 1e-5 / atol 1e-5), and S1's top-N against the
   stable sort's on the same predictions (equal);
3. alternating CUDA-event rounds: the plain prediction against the kernel,
   the stable sort's top-N against S1's, and the CF stage as a whole,
   plain prediction and stable sort against `recommend_topk_retrieved`;
   then the profiler's device ms of the kernel (`predict_rows`) and of
   S1's top-N, beside the kernel's byte bound (`bounds.cf_predict_call`).

    python3 tools/chip_probes/cf_predict_ab.py

Needs a CUDA device.  Prints the card first and one JSON line last (also
written to chiprun_out/cf_predict_ab.json).
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from chip_smoke import device_ms  # noqa: E402
from crypto_rec_tpu_torch.experiments._common import (  # noqa: E402
    card, require_cuda, spread, timed_alternating,
)
from crypto_rec_tpu_torch.models.rec import engine  # noqa: E402
from crypto_rec_tpu_torch.ops import topk  # noqa: E402
from crypto_rec_tpu_torch.ops.kernels import bounds, build, cfpredict  # noqa: E402

Q, C, P, TOP_N, DENSITY, PADDED, SEED = 73_421, 100, 20, 5, 0.56, 0.25, 2100


def ptxas() -> list:
    """`-Xptxas -v` lines of cfpredict.cu (registers, spills)."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build.CSRC), "-c",
             "-o", os.path.join(tmp, "cfpredict.o"), str(build.CSRC / "cfpredict.cu")],
            capture_output=True, text=True)
    build._check_run(res.returncode, res.stdout, res.stderr, "nvcc cfpredict.cu")
    return [ln.strip() for ln in res.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def case(dev):
    """The cell's shape on planted ratings: (queries, neighbours, sims,
    neighbour ids with -1 pads)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    r = torch.randn(Q, C, generator=g, device=dev) * 3.0
    known = torch.rand(Q, C, generator=g, device=dev) < DENSITY
    mean = (r * known).sum(1) / known.sum(1).clamp(min=1)
    users = engine.RatingSet(ratings=r, known=known, mean=mean)
    sims = torch.sort(torch.rand(Q, P, generator=g, device=dev), dim=1, descending=True)[0]
    ids = torch.randint(0, Q, (Q, P), generator=g, device=dev)
    pads = torch.rand(Q, 1, generator=g, device=dev) < PADDED
    ids = torch.where(pads & (torch.arange(P, device=dev) >= P - 4), -1, ids)
    return users, sims, ids


def main() -> int:
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = card()
    print(smi, flush=True)
    res = dict(card=smi, shape=dict(q=Q, c=C, P=P, top_n=TOP_N))
    res["ptxas"] = ptxas()
    for ln in res["ptxas"]:
        print("ptxas:", ln)

    users, sims, ids = case(dev)
    valid = ids >= 0
    idx = torch.clamp(ids, min=0) * valid
    args = (users.ratings, users.known, users.mean, users.ratings, users.mean, sims, idx,
            valid)
    got = cfpredict.cf_predict(*args)
    want = cfpredict.cf_predict_plain(*args)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ok = torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    again = cfpredict.cf_predict(*args)
    res["check"] = dict(max_abs_err=err, allclose_1e5=ok, repeats_bitwise=torch.equal(got, again),
                        valid_share=valid.float().mean().item())
    mask = ~users.known

    def stable_topn(pred):
        vals, i = topk._topk_padded(torch.where(mask, pred, topk.NEG_INF), TOP_N)
        return torch.where(vals > topk.NEG_INF, i, -1)

    s1_top = topk.topn_indices(got, mask, TOP_N)
    res["check"]["topn_equal"] = torch.equal(s1_top, stable_topn(got))
    print("check:", res["check"], flush=True)

    def parent_stage():
        pred = cfpredict.cf_predict_plain(*args)
        return stable_topn(pred)

    def stage():
        return engine.recommend_topk_retrieved(users, users, sims, ids, TOP_N).top_n

    times = timed_alternating({
        "predict_plain": lambda: cfpredict.cf_predict_plain(*args),
        "predict_kernel": lambda: cfpredict.cf_predict(*args),
        "topn_sort": lambda: stable_topn(got),
        "topn_s1": lambda: topk.topn_indices(got, mask, TOP_N),
        "stage_parent": parent_stage,
        "stage_now": stage,
    }, dev, rounds=21)
    res["event_ms"] = {k: statistics.median(v) for k, v in times.items()}
    for k, v in times.items():
        print(f"{k}: {spread(v)} ms (CUDA events, 21 rounds)", flush=True)
    res["device_ms"] = dict(
        predict_rows=device_ms(lambda: cfpredict.cf_predict(*args), "predict_rows"),
        topn_s1=device_ms(lambda: topk.topn_indices(got, mask, TOP_N), "warp_rows"))
    b = bounds.cf_predict_call(Q, P, C, Q, ids.element_size())
    res["bound"] = b
    res["share_of_bound_pct"] = 100.0 * b["bound_ms"] / res["device_ms"]["predict_rows"]
    print(f"device ms: {res['device_ms']}; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
          f"kernel at {res['share_of_bound_pct']:.1f}% of it", flush=True)
    res["peak_bytes"] = {}
    for name, fn in (("stage_parent", parent_stage), ("stage_now", stage)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        res["peak_bytes"][name] = torch.cuda.max_memory_allocated() - base
    print("peak bytes above the inputs:", res["peak_bytes"], flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "cf_predict_ab.json"), "w") as f:
        json.dump(res, f)
    print(json.dumps(res))
    return 0 if ok and res["check"]["topn_equal"] and res["check"]["repeats_bitwise"] else 1


if __name__ == "__main__":
    sys.exit(main())
