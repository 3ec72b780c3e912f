"""The probe entry points: the probes' retrieval paths on a JAX-built
cosine index handed to the port as arrays (the same top-10 as the JAX
functions on the same arrays), each `run_*` on CPU tensors, and each
`main()` refusing to run without a CUDA device.  Kernel-level parity is in
test_torch_probes.py; tolerances as there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu.models.lsh import index as jax_index
from crypto_rec_tpu_torch.experiments import _common
from crypto_rec_tpu_torch.models.lsh.index import index_from_numpy
from crypto_rec_tpu_torch.ops.kernels import binned, blkslab, int4slab, slabvariants
from crypto_rec_tpu_torch.experiments.probe_r3_final import retrieve_nomask
from crypto_rec_tpu_torch.ops.kernels.slabscore import (
    _dedup_topk_pairs, _window_offsets, slab_window_dots,
)

from _torch_parity import assert_topk_match, handover, probe_functions, to_np, to_torch as _t

L, D, PT = 4, 128, 200
ATOL = {"bfloat16": 1e-6, "int8": 1e-4}
PROBES = ("probe_r3_mask", "probe_r3_split", "probe_r3_binned", "probe_r3_final",
          "probe_r4_blk", "probe_r5_int4")


@pytest.fixture(scope="module")
def probes():
    return probe_functions()


RN, RQ, RK = 4096, 24, 10


@pytest.fixture(scope="module")
def index():
    """A JAX cosine index (k = 5, L = 4) over rows with planted near
    neighbours, packed bf16 and int8, handed to the port as arrays."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(RN, D)).astype(np.float32)
    qs = x[:RQ] + 0.05 * rng.normal(size=(RQ, D)).astype(np.float32)
    jidx = jax_index.build_index(jax.random.PRNGKey(2), jnp.asarray(x), "cosine", k=5,
                                 L=L, lsh_bucket_div=4, euclidean_h_w=1.0)
    qb, _ = jax_index.query_hashes(jidx, jnp.asarray(qs))
    qv = qs / np.linalg.norm(qs, axis=1, keepdims=True)
    out = dict(qb=qb, qv=qv)
    for dt in ATOL:
        p = jax_index.pack_index(jidx, jnp.asarray(x), dtype=jnp.dtype(dt), pad=1024)
        out[dt] = (p, index_from_numpy(*handover(p), "cpu"))
    return out


def _retrieve_args(tidx, index):
    return (tidx.packed, tidx.packed_rows, tidx.bucket_starts, tidx.n_rows,
            torch.from_numpy(index["qv"]), _t(index["qb"]))


@pytest.mark.parametrize("dtype,nbins", [("bfloat16", 128), ("int8", 256)])
def test_retrieve_binned_matches_jax(probes, index, dtype, nbins):
    jp, tidx = index[dtype]
    want = probes["p3"].retrieve_binned(jp.packed, jp.packed_rows, jp.bucket_starts,
                                        jp.n_rows, jnp.asarray(index["qv"]), index["qb"],
                                        PT, RK, nbins)
    got = binned.retrieve_binned(*_retrieve_args(tidx, index), PT, RK, nbins)
    assert_topk_match(*want, *got, rtol=1e-5, atol=ATOL[dtype])
    assert to_np(got[1]).max() < tidx.n_rows


@pytest.mark.parametrize("dtype,m1,score", [("bfloat16", 40, "vpu"), ("int8", 40, "vpu"),
                                            ("int8", 40, "mxu_i8")])
def test_retrieve_nomask_matches_jax(probes, index, dtype, m1, score):
    jp, tidx = index[dtype]
    args = list(_retrieve_args(tidx, index))
    jq = jnp.asarray(index["qv"])
    if score == "mxu_i8":
        args[4] = slabvariants.quantize_queries(args[4])
        jq = jnp.asarray(args[4].numpy())
    want = probes["p4"].retrieve_nomask(jp.packed, jp.packed_rows, jp.bucket_starts,
                                        jp.n_rows, jq, index["qb"], PT, RK, m1, False,
                                        score=score)
    got = retrieve_nomask(*args, PT, RK, m1, score)
    assert_topk_match(*want, *got, rtol=1e-5, atol=0 if score == "mxu_i8" else ATOL[dtype])


def test_slab_topk_int4_matches_jax(probes, index):
    """The same int4 dots through both epilogues, then the port's whole
    int4 path (its plain dots + epilogue) against JAX's."""
    jp, tidx = index["int8"]
    p4 = int4slab.repack_int4(tidx.packed)
    s0, _ = _window_offsets(tidx.bucket_starts, _t(index["qb"]), PT)
    qv = torch.from_numpy(index["qv"])
    jd, ja = probes["p6"].slab_window_dots_int4(jnp.asarray(p4.numpy()), jnp.asarray(s0),
                                                jnp.asarray(index["qv"]), per_table=PT)
    want = probes["p6"].slab_topk_int4(jd, ja, jp.packed_rows, jp.n_rows, RK)
    got = int4slab.slab_topk_int4(_t(jd), _t(ja), tidx.packed_rows, tidx.n_rows, RK)
    assert_topk_match(*want, *got)
    dots, a0 = int4slab.slab_window_dots_int4(p4, s0, qv, PT)
    got = int4slab.slab_topk_int4(dots, a0, tidx.packed_rows, tidx.n_rows, RK)
    assert_topk_match(*want, *got, rtol=1e-5, atol=1e-5)


def test_dedup_topk_is_the_probes(probes):
    """The probe's dedup_topk (probe_r3_final.py:117-129) and the port's
    _dedup_topk_pairs on pairs with duplicate ids, sentinels and -inf."""
    rng = np.random.default_rng(4)
    n_rows = 50
    ids = rng.integers(0, n_rows + 5, size=(8, 40)).astype(np.int32)
    s = rng.normal(size=(8, 40)).astype(np.float32)
    s[rng.random(size=s.shape) < 0.1] = -np.inf
    want = probes["p4"].dedup_topk(jnp.asarray(s), jnp.asarray(ids), n_rows, 10)
    got = _dedup_topk_pairs(torch.from_numpy(s), torch.from_numpy(ids), n_rows, 10)
    assert_topk_match(*want, *got, rtol=0, atol=0)


# ---- the entry points ----

def test_run_functions_on_cpu(index):
    """Each probe's run_* on CPU tensors: every time is None ("not
    measured"), every recall lies in [0, 1], the agreement checks hold."""
    from crypto_rec_tpu_torch.experiments import (
        probe_r3_binned, probe_r3_final, probe_r3_mask, probe_r3_split, probe_r4_blk,
        probe_r5_int4,
    )

    true_idx = torch.arange(RQ, dtype=torch.int32)[:, None].expand(RQ, 2)
    qb = _t(index["qb"])
    ps = {}
    for dt in ATOL:
        t = index[dt][1]
        s0, sizes = _window_offsets(t.bucket_starts, qb, PT)
        ps[dt] = _common.ProbeIndex(t.packed, t.packed_rows, t.bucket_starts, t.n_rows,
                                    torch.from_numpy(index["qv"]), qb, s0, sizes, PT,
                                    true_idx)
    p16, p8 = ps["bfloat16"], ps["int8"]
    split = probe_r3_split.run_split(p16)
    results = [probe_r3_mask.run_mask(p16), split, split["floor"],
               probe_r3_split.floor_vs_k1(p8),
               probe_r3_binned.run_binned(p8), probe_r4_blk.run_blk(p16),
               probe_r5_int4.run_int4(p8), *probe_r3_final.run_final(p16, p8).values()]
    for res in results:
        for key, v in res.items():
            if key.endswith("ms") or key.endswith("gbps"):
                assert v is None, key
            if "recall" in key:
                assert 0.0 <= v <= 1.0, key
    assert results[0]["nomask_ge_masked"]
    assert results[5]["max_abs_diff"] < 1e-5
    assert split["floor"]["ratio_rounds"] is None


@pytest.mark.parametrize("name", PROBES)
def test_probe_main_raises_without_cuda(monkeypatch, name):
    mod = importlib.import_module(f"crypto_rec_tpu_torch.experiments.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        mod.main(["--n", "1000", "--q", "16"])


_REFUSALS = {
    "nbins not dividing L x win": (
        ValueError, lambda p, s, q: binned.binned_dots(p, s, q, 100, nbins=100)),
    "rounded_query on int8": (
        TypeError, lambda p, s, q: slabvariants.slab_window_variant(
            p, s, q, 100, "rounded_query")),
    "i8_dot with f32 queries": (
        TypeError, lambda p, s, q: slabvariants.slab_window_variant(p, s, q, 100, "i8_dot")),
    "unknown mode": (
        ValueError, lambda p, s, q: slabvariants.slab_window_variant(p, s, q, 100, "mxu")),
    "odd n_pad for int4": (ValueError, lambda p, s, q: int4slab.repack_int4(p[:, :-1])),
    "the mask without sizes": (
        ValueError, lambda p, s, q: slab_window_dots(p, s, None, q, 100, mask=True)),
    "m1 outside [top_k, L x top_k]": (
        ValueError, lambda p, s, q: retrieve_nomask(p, None, None, 0, q, None, 100, 10, 30)),
    "n_pad % 128 for blocks": (ValueError, lambda p, s, q: blkslab.to_blk(p[:, :-64])),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    """The refusals that hold on every device (the kernel-only ones, dtype,
    d % 16 and mixed devices, are card tests in test_torch_cuda.py)."""
    err, call = _REFUSALS[case]
    g = torch.Generator().manual_seed(0)
    packed = torch.randint(-127, 128, (2, 1024, D), generator=g).to(torch.int8)
    with pytest.raises(err):
        call(packed, torch.zeros(4, 2, dtype=torch.int32), torch.randn(4, D, generator=g))
