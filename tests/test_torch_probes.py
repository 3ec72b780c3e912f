"""The probe kernels P1-P6: the port's plain versions against the probes'
JAX functions (Pallas in interpret mode), on the same numpy-made inputs.
The probes' retrieval paths and entry points are in
test_torch_probe_paths.py.

P1-P5's functions come from their scripts through `load_probe` (the
scripts build a 2M-row corpus at module level); probe_r5_int4.py is
imported as it is.  Tolerances: f32 dots within rtol 1e-5 and atol 1e-6
on unit-norm float slabs, 1e-4 on int8 slabs whose raw dots reach ~10
(summation order only); int8 x int8 dots, window starts, to_blk and the
int4 repack exactly; a bin's winning lane exactly wherever its best and
second-best dots differ by more than the dot tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crypto_rec_tpu_torch.ops.kernels import binned, blkslab, int4slab, slabvariants
from crypto_rec_tpu_torch.ops.kernels.slabscore import slab_window_dots

from _torch_parity import probe_functions, to_np, to_torch as _t

L, N_PAD, D, Q, PT = 4, 2048, 128, 20, 200
ATOL = {"bfloat16": 1e-6, "int8": 1e-4}


@pytest.fixture(scope="module")
def probes():
    return probe_functions()


@pytest.fixture(scope="module")
def slabs():
    """Random unit rows as bf16 and global-scale int8 slabs, window starts
    running into the slab's end, unit f32 queries (Q is not a multiple of
    the probes' 16-query tile)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(L, N_PAD, D)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return dict(
        bfloat16=jnp.asarray(x, jnp.bfloat16),
        int8=jnp.asarray(np.clip(np.round(x / (np.abs(x).max() / 127)), -127, 127)
                         .astype(np.int8)),
        starts=rng.integers(0, N_PAD, size=(Q, L)).astype(np.int32),
        qv=q,
    )


def _args(slabs, dtype):
    return (slabs[dtype], jnp.asarray(slabs["starts"]), jnp.asarray(slabs["qv"])), (
        _t(slabs[dtype]), torch.from_numpy(slabs["starts"]), torch.from_numpy(slabs["qv"]))


def _close(got, want, dtype):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", list(ATOL))
def test_p1_dots_nomask_is_k1_without_mask(probes, slabs, dtype):
    (jp, js, jq), (tp, ts, tq) = _args(slabs, dtype)
    want_d, want_a = probes["p1"].dots_nomask(jp, js, jq, PT)
    got_d, got_a = slab_window_dots(tp, ts, ts, tq, PT, mask=False)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    _close(got_d, want_d, dtype)


@pytest.mark.parametrize("mode", ["zeros", "vpu", "mxu_rep", "mxu_tile"])
def test_p2_run_variant_modes(probes, slabs, mode):
    """bf16, as the probe ran.  zeros -> load_floor (exact), vpu -> K1,
    mxu_rep / mxu_tile -> rounded_query."""
    (jp, js, jq), (tp, ts, tq) = _args(slabs, "bfloat16")
    want = probes["p2"].run_variant(jp, js, js, jq, PT, 16, 4, mode)[:Q]
    if mode == "vpu":
        got, _ = slab_window_dots(tp, ts, ts, tq, PT, mask=False)
    else:
        got = slabvariants.slab_window_variant(tp, ts, tq, PT,
                                               slabvariants.PROBE_MODES[mode])[0]
    if mode == "zeros":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, "bfloat16")


@pytest.mark.parametrize("dtype", list(ATOL))
def test_load_floor_fold_is_xor_of_window_words(slabs, dtype):
    """The load floor's XOR fold against a numpy XOR over each query's
    window words (the probe has no such output; the kernel keeps it so its
    loads stay live)."""
    _, (tp, ts, tq) = _args(slabs, dtype)
    out, aligned, fold = slabvariants.slab_window_variant(tp, ts, tq, PT, "load_floor")
    words = to_np(tp).view(np.int32) if dtype == "int8" else \
        np.asarray(slabs[dtype]).view(np.int32)
    win = out.shape[2]
    for qi in range(Q):
        want = np.bitwise_xor.reduce(np.concatenate(
            [words[t, a:a + win].ravel() for t, a in enumerate(aligned[qi].tolist())]))
        assert int(fold[qi]) == int(want)


@pytest.mark.parametrize("nbins", [128, 256])
@pytest.mark.parametrize("dtype", list(ATOL))
def test_p3_binned_dots(probes, slabs, dtype, nbins):
    (jp, js, jq), (tp, ts, tq) = _args(slabs, dtype)
    want_v, want_p, want_a = probes["p3"].binned_dots(jp, js, jq, PT, nbins=nbins)
    got_v, got_p, got_a = binned.binned_dots(tp, ts, tq, PT, nbins)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    _close(got_v, want_v, dtype)
    # the winner's lane is exact wherever the bin has a clear best row
    dots, _ = slab_window_dots(tp, ts, ts, tq, PT, mask=False)
    top2 = torch.topk(dots.reshape(Q, -1, nbins), 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] > ATOL[dtype] + 1e-5 * top2[:, 0].abs()).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_p.numpy()[clear], np.asarray(want_p)[clear])
    assert int(got_p.max()) < L * dots.shape[2]


def test_p3_binned_ties_go_to_the_lowest_row(probes):
    """Integer-valued slabs and queries: every dot is an exact integer in
    any summation order, so bins tie often and each winner's lane must
    equal the TPU body's (the lowest row reaching the max) in every bin."""
    rng = np.random.default_rng(9)
    p8 = rng.integers(-2, 3, size=(L, N_PAD, D)).astype(np.int8)
    q = rng.integers(-1, 2, size=(Q, D)).astype(np.float32)
    starts = rng.integers(0, N_PAD, size=(Q, L)).astype(np.int32)
    want_v, want_p, _ = probes["p3"].binned_dots(jnp.asarray(p8), jnp.asarray(starts),
                                                 jnp.asarray(q), PT, nbins=128)
    got_v, got_p, _ = binned.binned_dots(torch.from_numpy(p8), torch.from_numpy(starts),
                                         torch.from_numpy(q), PT, 128)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("dtype,score", [("bfloat16", "vpu"), ("int8", "vpu"),
                                         ("int8", "mxu_i8")])
def test_p4_nomask_dots(probes, slabs, dtype, score):
    """vpu -> K1 without the mask; mxu_i8 -> i8_dot, exact, on the probe's
    per-row int8 queries."""
    (jp, js, jq), (tp, ts, tq) = _args(slabs, dtype)
    if score == "mxu_i8":
        jq = jnp.asarray(to_np(slabvariants.quantize_queries(tq)))
        tq = _t(jq)
    want_d, want_a = probes["p4"].nomask_dots(jp, js, jq, PT, score=score)
    if score == "vpu":
        got_d, got_a = slab_window_dots(tp, ts, ts, tq, PT, mask=False)
        _close(got_d, want_d, dtype)
    else:
        got_d, got_a = slabvariants.slab_window_variant(tp, ts, tq, PT, "i8_dot")
        np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_quantize_queries_matches_probe(slabs):
    """probe_r3_final.py:212-213, exactly."""
    qvf = jnp.asarray(slabs["qv"] * 3.0)
    qsc = jnp.max(jnp.abs(qvf), axis=1, keepdims=True) / 127.0
    want = jnp.clip(jnp.round(qvf / qsc), -127, 127).astype(jnp.int8)
    got = slabvariants.quantize_queries(torch.from_numpy(slabs["qv"] * 3.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(ATOL))
def test_p5_blk_window_dots(probes, slabs, dtype):
    (jp, js, jq), (tp, ts, tq) = _args(slabs, dtype)
    jblk = jnp.swapaxes(jp.reshape(L, N_PAD // 128, 128, D), 2, 3)   # probe :174-177
    tblk = blkslab.to_blk(tp)
    np.testing.assert_array_equal(to_np(tblk), to_np(jblk))
    want_d, want_a = probes["p5"].blk_window_dots(jblk, js, jq, PT)
    got_d, got_a = blkslab.blk_window_dots(tblk, ts, tq, PT)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    _close(got_d, want_d, dtype)


def _repack_numpy(p8):
    """probe_r5_int4.py:195-200 in numpy: per table, round(x * 7 / 127) in
    f32 clipped to +-7; hi nibble = even rows, lo nibble = odd rows."""
    out = []
    for t in p8:
        v4 = np.clip(np.round(t.astype(np.float32) * np.float32(7.0 / 127.0)),
                     -7, 7).astype(np.int32)
        out.append((((v4[0::2] & 0xF) << 4) | (v4[1::2] & 0xF)).astype(np.uint8))
    return np.stack(out)


def test_p6_repack_int4(slabs):
    p8 = np.asarray(slabs["int8"])
    got = int4slab.repack_int4(torch.from_numpy(p8))
    np.testing.assert_array_equal(got.numpy(), _repack_numpy(p8))
    # every int8 value, so each rounding case is covered
    every = np.arange(-127, 128, dtype=np.int8)
    every = np.tile(np.concatenate([every, every[:1]])[None, :, None], (1, 1, 16))
    np.testing.assert_array_equal(int4slab.repack_int4(torch.from_numpy(every)).numpy(),
                                  _repack_numpy(every))


def test_p6_int4_window_dots(probes, slabs):
    p4 = int4slab.repack_int4(_t(slabs["int8"]))
    qv = slabs["qv"]
    want_d, want_a = probes["p6"].slab_window_dots_int4(
        jnp.asarray(p4.numpy()), jnp.asarray(slabs["starts"]), jnp.asarray(qv),
        per_table=PT)
    got_d, got_a = int4slab.slab_window_dots_int4(p4, torch.from_numpy(slabs["starts"]),
                                                  torch.from_numpy(qv), PT)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
