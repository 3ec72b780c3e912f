"""The port's cosine LSH index over int8 slabs, served one of two ways
(the configuration's "serve"):

- "cf": `retrieve_topk_pallas` (top-P neighbours, scale-free int8 scores,
  stage 1 keeping `stage1_per_table` lanes a window) then
  `recommend_topk_retrieved` (mean-centred prediction, top-N coins);
- "retrieve": `retrieve_topk` (top-k by exact cosine after the int8
  windows' over-fetch).

The benchmark makes the corpus, the queries, the ratings and the
hyperplanes from the seed on the device, hands the same hyperplanes to the
program (`family=CosineLsh(proj, k, L)`) and to the reference, and judges
the program's state and answers against `portbench.reference`.

The requests draw from one of two pools (the configuration's "queries"):
"planted" (the default), the `pool` planted queries, each with `truth_k`
planted neighbours in the corpus; or "corpus", the corpus rows themselves,
as the recommender's Part A queries every user against an index of all
users.  There a planted row's truth is its planted group: the `truth_k`
rows planted around one query, itself among them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from portbench import reference as ref

F64 = torch.float64


def _nanmax(x: torch.Tensor) -> float:
    """Largest entry, +inf if any is NaN, 0 for an empty tensor."""
    if x.numel() == 0:
        return 0.0
    if bool(torch.isnan(x).any()):
        return math.inf
    return float(x.max())


def _gap(want: torch.Tensor, got: torch.Tensor) -> torch.Tensor:
    """want - got position by position; 0 where both are -inf (no entry on
    either side), +inf where only `got` is missing."""
    both = torch.isneginf(want) & torch.isneginf(got)
    return torch.where(both, 0.0, want - got)


def _ids_sound(ids: torch.Tensor, n: int) -> torch.Tensor:
    """[b] rows whose ids [b, m] are in [-1, n), distinct among the real
    ones, and -1 only after the last real one."""
    in_range = ((ids >= -1) & (ids < n)).all(1)
    real = ids >= 0
    s = torch.sort(torch.where(real, ids, -1 - torch.arange(ids.shape[1],
                                                            device=ids.device)), dim=1).values
    distinct = ~(s[:, 1:] == s[:, :-1]).any(1)
    trailing = ~(~real[:, :-1] & real[:, 1:]).any(1)
    return in_range & distinct & trailing


class Path:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        if cfg["slab_dtype"] != "int8":
            raise ValueError("the cosine_lsh path covers int8 slabs")
        if cfg["serve"] not in ("cf", "retrieve"):
            raise ValueError(f"unknown serve {cfg['serve']!r}")
        self.cfg, self.seed, self.dev = cfg, seed, device
        self.cf = cfg["serve"] == "cf"
        self.of_corpus = cfg.get("queries", "planted") == "corpus"
        if not self.of_corpus and cfg.get("queries", "planted") != "planted":
            raise ValueError(f"unknown queries {cfg['queries']!r}")
        self.index = None
        self._own = None      # the reference's own index, for the bounds' windows

    @property
    def pool(self) -> int:
        return int(self.cfg["n"] if self.of_corpus else self.cfg["pool"])

    # ---- set-up -------------------------------------------------------
    def prepare(self) -> None:
        """Load the kernel library, then make the inputs from the seed."""
        if self.dev.type == "cuda":
            from crypto_rec_tpu_torch.ops.kernels import build

            build.library()
        c = self.cfg
        g = torch.Generator(device=self.dev).manual_seed(self.seed)
        self.corpus, self.queries, self.truth = ref.planted_corpus(
            g, c["n"], c["d"], c["pool"], c["truth_k"])
        self.proj = torch.randn(c["d"], c["L"] * c["k"], generator=g, device=self.dev)
        if self.cf:
            p = c["known_density"]
            self.n_known = torch.rand(c["n"], c["d"], generator=g, device=self.dev) < p
            self.n_mean = ((self.corpus * self.n_known).sum(1)
                           / self.n_known.sum(1).clamp(min=1))
        if self.of_corpus:
            tk = c["truth_k"]
            self.queries = self.corpus
            group = torch.arange(c["n"], device=self.dev) // tk
            self.truth = torch.where((group < c["pool"])[:, None],
                                     group[:, None] * tk + torch.arange(tk, device=self.dev), -1)
            if self.cf:
                self.q_known, self.q_mean = self.n_known, self.n_mean
        elif self.cf:
            self.q_known = torch.rand(c["pool"], c["d"], generator=g, device=self.dev) < p
            self.q_mean = ((self.queries * self.q_known).sum(1)
                           / self.q_known.sum(1).clamp(min=1))
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def build(self):
        """The program's index: build_index + pack_index (int8)."""
        from crypto_rec_tpu_torch.models.lsh import index as lsh_index
        from crypto_rec_tpu_torch.models.lsh.hyperplane import CosineLsh

        c = self.cfg
        idx = lsh_index.build_index(None, self.corpus, "cosine", c["k"], c["L"],
                                    family=CosineLsh(self.proj, c["k"], c["L"]))
        return lsh_index.pack_index(idx, self.corpus, dtype=torch.int8, pad=c["pad"])

    def use(self, index) -> None:
        from crypto_rec_tpu_torch.models.rec.engine import RatingSet

        self.index = index
        if self.cf:
            self.nset = RatingSet(ratings=self.corpus, known=self.n_known, mean=self.n_mean)

    # ---- the timed path -----------------------------------------------
    def serve(self, rows: np.ndarray, mark=None) -> dict:
        """One request for pool rows `rows`; `mark()` is called once the
        retrieval's calls have returned."""
        from crypto_rec_tpu_torch.models.lsh import index as lsh_index
        from crypto_rec_tpu_torch.models.rec import engine

        c = self.cfg
        ids = torch.from_numpy(rows).to(self.dev)
        if not self.cf:
            scores, nb = lsh_index.retrieve_topk(self.index, self.queries[ids], self.corpus,
                                                 c["top_k"], per_table=c["per_table"])
            if mark:
                mark()
            return dict(rows=ids, neighbors=nb, scores=scores)
        qs = engine.RatingSet(ratings=self.queries[ids], known=self.q_known[ids],
                              mean=self.q_mean[ids])
        sims, nb = lsh_index.retrieve_topk_pallas(
            self.index, qs.ratings, self.corpus, top_k=c["top_p"], per_table=c["per_table"],
            int8_rerank=False, stage1_per_table=c["stage1_per_table"])
        if mark:
            mark()
        rec = engine.recommend_topk_retrieved(qs, self.nset, sims, nb, c["top_n"])
        return dict(rows=ids, neighbors=rec.neighbor_idx, scores=rec.sims,
                    predicted=rec.predicted, top_n=rec.top_n)

    # ---- after the window ---------------------------------------------
    def state(self) -> dict:
        return dict(bucket_ids=self.index.bucket_ids, sorted_rows=self.index.sorted_rows,
                    starts=self.index.bucket_starts)

    def release(self) -> None:
        """Free the program's index (its state() tensors stay with the caller)."""
        self.index = None
        self.nset = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def shape(self) -> dict:
        c = self.cfg
        return dict(d=c["d"], L=c["L"], k=c["k"], n=c["n"], win=ref.window_len(c["per_table"]),
                    n_pad=ref.padded_len(c["n"], c["pad"]), slab_bytes=1,
                    kk=c["stage1_per_table"], top_k=c["top_p"] if self.cf else c["top_k"])

    def windows(self, rows: np.ndarray) -> torch.Tensor:
        """[q, L] absolute first rows of the windows of pool rows `rows`, as
        the reference works them out from its own hash of the corpus."""
        if self._own is None:
            c = self.cfg
            bits, _ = ref.hash_bits(self.corpus, self.proj)
            self._own = ref.build(self.corpus, self.proj, c["k"], c["L"], c["per_table"],
                                  c["pad"], ref.bucket_ids(bits, c["k"], c["L"]))
        q = self.queries[torch.from_numpy(rows).to(self.dev)]
        return ref.windows(self._own, ref.query_buckets(self._own, q)[0])

    def sample_rows(self, outs: list, seed: int) -> dict:
        """The judged answers: every row of the kept requests, cut to a
        seeded sample of judge_rows."""
        cat = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        m = cat["rows"].shape[0]
        keep = int(self.cfg["judge_rows"])
        if m > keep:
            pick = np.sort(np.random.default_rng([seed, 4]).choice(m, keep, replace=False))
            sel = torch.from_numpy(pick).to(self.dev)
            cat = {k: v[sel] for k, v in cat.items()}
        return cat

    def judge(self, state: dict, outs: list, seed: int) -> dict:
        """The numbers compared, each {value, limit, ok}."""
        values = self.numbers(state, self.sample_rows(outs, seed))
        limits = self.cfg["checks"]
        return {k: dict(value=v, limit=limits[k],
                        ok=(v >= limits[k]) if k.startswith("recall") else (v <= limits[k]))
                for k, v in values.items()}

    def numbers(self, state: dict, ans: dict, explain: Optional[dict] = None) -> dict:
        """Compare a state and its answers with the reference; `explain`,
        when given, is filled with the row of the widest rank gap."""
        c = self.cfg
        k, L, n = c["k"], c["L"], c["n"]
        prog = state["bucket_ids"].long()
        # the corpus rows' hash: a bit may differ from float64 only where
        # rounding decides it.  The reference's bucket ids are its own
        # float64 bits; only a bit within the hash_margin limit of 0, which
        # the card's rounding decides and the reference cannot know, is the
        # program's.
        limit = c["checks"]["hash_margin"]
        shifts = torch.arange(k - 1, -1, -1, device=prog.device)
        margin = 0.0
        own = torch.empty_like(prog)
        for b in ref.blocks(n, 1 << 17):
            bits, marg = ref.hash_bits(self.corpus[b], self.proj)
            pb = ((prog[b][:, :, None] >> shifts) & 1).bool().reshape(bits.shape)
            margin = max(margin, _nanmax(marg[pb != bits]))
            own[b] = ref.bucket_ids(torch.where(marg < limit, pb, bits), k, L)
        out = {"hash_margin": margin}
        # the tables, from the reference's bucket ids
        ridx = ref.build(self.corpus, self.proj, k, L, c["per_table"], c["pad"], own)
        del own
        srt, st = state["sorted_rows"].long(), state["starts"].long()
        mis = (int((ridx.sorted_rows[:, :n] != srt).sum()) + int((ridx.starts != st).sum())
               if srt.shape == (L, n) and st.shape == ridx.starts.shape else L * n)
        out["csr_mismatch"] = mis
        # the answers
        nb = ans["neighbors"].long()
        kk = c["stage1_per_table"]
        slack = 2.0 * c["checks"]["score_err"]   # two scores, each within its limit
        step = ref.query_block(c["d"], ridx.win, L)
        err, gap, cf_err, hits, truths, sound = 0.0, 0.0, 0.0, 0, 0, True
        for b in ref.blocks(nb.shape[0], step):
            q = self.queries[ans["rows"][b]]
            qb, qmarg = ref.query_buckets(ridx, q)
            clear = qmarg >= c["checks"]["hash_margin"]
            pid = nb[b]
            sound &= bool(_ids_sound(pid, n).all())
            got = ans["scores"][b].to(F64)
            if self.cf:
                want_s, want_i = ref.window_topk(ridx, q, qb, kk, c["top_p"], slack=slack)
                want_s = want_s * ridx.g.to(F64)
                judged = ref.int8_sims(ridx, q, pid)
            else:
                want_s, want_i = ref.retrieve(ridx, q, qb, kk, c["rerank_candidates"],
                                              c["top_k"], slack=slack)
                judged = ref.cosines(self.corpus, q, pid)
            err = max(err, _nanmax(_gap(judged, got).abs()))
            g_rows = torch.where(clear[:, None], _gap(want_s, judged), 0.0).amax(1)
            if explain is not None and g_rows.numel() and float(g_rows.max()) > gap:
                w = int(g_rows.argmax())
                explain.update(row=int(ans["rows"][b][w]), gap=float(g_rows[w]),
                               margin=float(qmarg[w]), buckets=qb[w].tolist(),
                               want_ids=want_i[w].tolist(), want=want_s[w].tolist(),
                               got_ids=pid[w].tolist(), got=judged[w].tolist())
            gap = max(gap, _nanmax(g_rows))
            t = self.truth[ans["rows"][b]]
            top = pid[:, :t.shape[1]]
            real_t = (t >= 0)[:, None, :]
            hits += int(((top[:, :, None] == t[:, None, :]) & real_t).any(2).sum())
            truths += int(real_t.sum())
            if self.cf:
                r = ans["rows"][b]
                pred = ref.cf_predict(self.queries[r], self.q_known[r], self.q_mean[r],
                                      self.corpus, self.n_mean, judged, pid)
                cf_err = max(cf_err, _nanmax((ans["predicted"][b].to(F64) - pred).abs()))
                best, _ = ref.top_unknown(pred, self.q_known[r], c["top_n"])
                coins = ans["top_n"][b].long()
                ok = (coins >= 0) & ~torch.gather(self.q_known[r], 1, coins.clamp(min=0))
                picked = torch.where(ok, torch.gather(pred, 1, coins.clamp(min=0)), -math.inf)
                cf_err = max(cf_err, _nanmax(_gap(best, picked)))
        if not sound:
            err = math.inf
        out["score_err"] = err
        out["rank_gap"] = max(gap, 0.0)
        if self.cf:
            out["cf_err"] = cf_err
        out["recall_at_10"] = hits / max(truths, 1)
        return out

    # ---- the control --------------------------------------------------
    def control(self, outs: list, seed: int) -> tuple:
        """The reference in the program's place, its products in TF32: ->
        (state, answers) for the same sampled rows, in the program's form."""
        c = self.cfg
        k, L, n = c["k"], c["L"], c["n"]
        ans = self.sample_rows(outs, seed)
        bits = torch.cat([ref.hash_bits(self.corpus[b], self.proj, "tf32")[0]
                          for b in ref.blocks(n, 1 << 17)])
        cb = ref.bucket_ids(bits, k, L)
        del bits
        cidx = ref.build(self.corpus, self.proj, k, L, c["per_table"], c["pad"], cb)
        state = dict(bucket_ids=cb.int(), sorted_rows=cidx.sorted_rows[:, :n],
                     starts=cidx.starts)
        parts = []
        step = ref.query_block(c["d"], cidx.win, L)
        for b in ref.blocks(ans["rows"].shape[0], step):
            r = ans["rows"][b]
            q = self.queries[r]
            qb, _ = ref.query_buckets(cidx, q, "tf32")
            if self.cf:
                s, i = ref.window_topk(cidx, q, qb, c["stage1_per_table"], c["top_p"], "tf32")
                s = s * cidx.g.to(F64)
                pred = ref.cf_predict(q, self.q_known[r], self.q_mean[r], self.corpus,
                                      self.n_mean, s, i, "tf32")
                _, coins = ref.top_unknown(pred, self.q_known[r], c["top_n"])
                parts.append(dict(rows=r, neighbors=i, scores=s.float(),
                                  predicted=pred.float(), top_n=coins))
            else:
                s, i = ref.retrieve(cidx, q, qb, c["stage1_per_table"],
                                    c["rerank_candidates"], c["top_k"], "tf32")
                parts.append(dict(rows=r, neighbors=i, scores=s.float()))
        return state, {kk: torch.cat([p[kk] for p in parts]) for kk in parts[0]}
