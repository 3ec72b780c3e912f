"""The CF engine's prediction (`models/rec/engine.predict_scores`).

    w_p     = valid_p ? sim_p : 0,   abs_sum = sum_p |w_p|
    main_j  = sum_p w_p (R[id_p, j] - mean[id_p])        (valid slots only)
    pred_j  = known_j ? rating_j
                      : mean_q + (abs_sum > 0 ? main_j / max(abs_sum, 1e-30) : 0)

(get_predicted_user_sim, reference lib/crypto_rec.hpp:280-306), for q users
with P selected neighbours each, over an [n, c] rating table.

`cf_predict` routes by device: a CUDA tensor launches the Hopper kernel in
`csrc/cfpredict.cu` (and raises where it cannot), a CPU tensor runs
`cf_predict_plain`, the plain PyTorch version: the JAX package's XLA ops
(`crypto_rec_tpu/models/rec/engine.py:61`) in torch, a [q, P, c] neighbour
gather, its centred copy and an einsum.  The kernel replaces no TPU kernel:
it reads each operand once and writes the prediction once, with nothing of
[q, P, c] in device memory.
"""

from __future__ import annotations

import torch

from crypto_rec_tpu_torch.ops.kernels import build

_EPS = 1e-30


def cf_predict_plain(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, idx, valid):
    """[q, P] selected neighbours -> [q, c] predictions (known cells keep
    their rating), in plain torch on any device."""
    w = torch.where(valid, sims, 0.0)                               # [q, P]
    abs_sum = torch.sum(torch.abs(w), dim=1)                        # [q]
    idx = idx.long()
    neigh_r = n_ratings[idx]                                        # [q, P, c]
    neigh_mu = n_mean[idx]                                          # [q, P]
    centered = (neigh_r - neigh_mu[:, :, None]) * valid[:, :, None]
    main_sum = torch.einsum("qp,qpc->qc", w, centered)
    delta = main_sum / torch.clamp(abs_sum, min=_EPS)[:, None]
    pred_unknown = q_mean[:, None] + torch.where((abs_sum > 0.0)[:, None], delta, 0.0)
    return torch.where(q_known, q_ratings, pred_unknown)


def cf_predict(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, idx, valid):
    """q_ratings [q, c] f32, q_known [q, c] bool, q_mean [q] f32, n_ratings
    [n, c] f32, n_mean [n] f32, sims [q, P] f32, idx [q, P] int32 / int64
    (read only where valid), valid [q, P] bool -> predictions [q, c] f32.

    CPU tensors take the plain version; CUDA tensors the Hopper kernel, at
    any q, P and c (`check_cf_predict` says what it takes).  Each sum runs
    over the valid slots in order, so it differs from the plain version's
    contraction in summation order only.  A valid slot whose id lies
    outside [0, n) makes the user's unknown coins NaN on the card (the
    plain gather raises)."""
    if not q_ratings.is_cuda:
        return cf_predict_plain(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, idx,
                                valid)
    out = _launch(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, idx, valid)
    cf_predict.launches += 1
    return out


cf_predict.launches = 0


def check_cf_predict(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, idx, valid) -> None:
    """Raise on what the card's kernel does not take, before any launch:
    shapes other than the ones `cf_predict` names, ratings, means or sims
    not float32, ids not int32 / int64, masks not bool, operands on more
    than one device, or a dimension of 2^31 or more."""
    if q_ratings.dim() != 2 or n_ratings.dim() != 2 or sims.dim() != 2:
        raise ValueError(f"cf_predict takes [q, c] queries, [n, c] neighbours and [q, P] "
                         f"sims; got {tuple(q_ratings.shape)}, {tuple(n_ratings.shape)}, "
                         f"{tuple(sims.shape)}")
    (q, c), n, P = q_ratings.shape, n_ratings.shape[0], sims.shape[1]
    want = [(q_known, (q, c)), (q_mean, (q,)), (n_ratings, (n, c)), (n_mean, (n,)),
            (sims, (q, P)), (idx, (q, P)), (valid, (q, P))]
    for t, shape in want:
        if tuple(t.shape) != shape:
            raise ValueError(f"cf_predict: an operand of shape {tuple(t.shape)} where "
                             f"{shape} belongs (q={q}, P={P}, c={c}, n={n})")
    for t in (q_ratings, q_mean, n_ratings, n_mean, sims):
        if t.dtype != torch.float32:
            raise TypeError(f"cf_predict takes float32 ratings, means and sims, got {t.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"cf_predict takes int32 or int64 ids, got {idx.dtype}")
    if q_known.dtype != torch.bool or valid.dtype != torch.bool:
        raise TypeError("cf_predict takes bool known and valid masks")
    if len({t.device for t, _ in want} | {q_ratings.device}) != 1:
        raise ValueError("cf_predict's operands must live on one device")
    if max(q, P, c, n) >= 1 << 31:
        raise ValueError("cf_predict indexes q, P, c and n with int32")


def _launch(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, idx, valid) -> torch.Tensor:
    check_cf_predict(q_ratings, q_known, q_mean, n_ratings, n_mean, sims, idx, valid)
    ops = [t.contiguous() for t in (q_ratings, q_known, q_mean, n_ratings, n_mean, sims,
                                    idx, valid)]
    (q, c), n, P = q_ratings.shape, n_ratings.shape[0], sims.shape[1]
    out = torch.empty(q, c, dtype=torch.float32, device=q_ratings.device)
    with torch.cuda.device(q_ratings.device):
        err = build.library().crt_cf_predict(
            *(t.data_ptr() for t in ops), out.data_ptr(), q, P, c, n, idx.element_size(),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "crt_cf_predict")
    return out
