"""Training loss and filtered-evaluation objectives over a dense [N, d]
entity table."""

from __future__ import annotations

import numpy as np
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.ops.membership import true_answer_mask
from temp_tpu_torch.ops.ranking import filtered_ranks
from temp_tpu_torch.ops.sampling import (
    draw_negatives, draw_shared_negatives, shared_bad,
)
from temp_tpu_torch.ops.scores import query_for, row_scores, table_scores


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.sum(m).clamp(min=1.0)


def draw_pool(gen: torch.Generator, cfg: TKGConfig, data: TKGData, tp):
    """The negative candidates of the train queries of the targets tp [B]
    (a tensor on the data's device), from `gen`: "neg_tail" and
    "neg_head", the tail and the head queries' candidates, [B, E, 1 + K]
    long under ``per_query`` (``draw_negatives``, column 0 the positive)
    and the pools [B, K] long under ``shared``
    (``draw_shared_negatives``); both None under "all", which draws
    nothing."""
    if cfg.negative_pool == "all":
        return {"neg_tail": None, "neg_head": None}
    tr, r2 = data.train, 2 * data.num_rels
    n, k = data.num_ents, cfg.negative_rate
    src, rel, dst = (x[tp].long() for x in (tr.src, tr.rel, tr.dst))
    out = {}
    for key, tbl, grp, pos in (
            ("neg_tail", data.train_tail, src * r2 + rel, dst),
            ("neg_head", data.train_head, dst * r2 + rel, src)):
        if cfg.negative_pool == "shared":
            out[key] = draw_shared_negatives(gen, tbl.grp[tp], tbl.val[tp],
                                             grp, n, k)[0]
        else:
            out[key] = draw_negatives(gen, tbl.grp[tp], tbl.val[tp], grp,
                                      pos, n, k, cfg.neg_oversample)
    return out


def element_neg(draws, b: int):
    """Element b's (neg_tail, neg_head) of ``draw_pool``'s draws, or None
    (the "all" pool, or draws without them)."""
    if draws.get("neg_tail") is None:
        return None
    return draws["neg_tail"][b], draws["neg_head"][b]


def make_raw_scorers(cfg: TKGConfig, data: TKGData, t_pos: int, src, rel,
                     dst, neg=None):
    """The candidate scorers of one target snapshot's train queries (src,
    rel, dst [P], long): (score_tail, score_head), each mapping a query
    (``ops.scores.query_for``: (qvec [P, d], kind)) and an entity table
    [N, d] to [P, 1 + C] logits, the positive's score in column 0, the
    candidates' scores in ``cfg.hot_dtype`` (the positive's in float32).
    The candidates follow ``cfg.negative_pool``:

    - "all": every entity, the other true answers of the query (train
      facts at t) masked to -1e9;
    - "shared": one pool [K] of entity ids a direction, its true answers
      masked per query;
    - "per_query": each query's own candidates [P, 1 + K] (column 0 the
      positive), their columns of the scores against the whole table.

    `neg` is (tail, head) of the drawn candidates (``draw_pool``; None for
    "all"): the scorers never draw. Tables blended by the gated losses
    share the one draw and mask. `data` holds tensors."""
    r2 = 2 * data.num_rels
    pool = cfg.negative_pool
    if (neg is None) != (pool == "all"):
        raise ValueError(f"negative_pool={pool!r} with drawn candidates "
                         f"{neg is not None}")

    hot = cfg.hot_dtype

    def scorer(tbl, q_grp, pos, cand):
        if pool == "per_query":
            return lambda query, table: torch.gather(
                table_scores(query, table, hot), 1, cand.long())
        grp, val = tbl.grp[t_pos], tbl.val[t_pos]
        bad = (true_answer_mask(grp, val, q_grp, data.num_ents)
               if cand is None
               else shared_bad(grp, val, q_grp, data.num_ents, cand))

        def score(query, table):
            rows = table if cand is None else table[cand.long()]
            sc = table_scores(query, rows, hot).masked_fill(bad, -1e9)
            sc_pos = row_scores(query, table[pos])
            return torch.cat([sc_pos[:, None], sc], dim=1)
        return score

    nt, nh = (None, None) if neg is None else neg
    return (scorer(data.train_tail, src * r2 + rel, dst, nt),
            scorer(data.train_head, dst * r2 + rel, src, nh))


def train_loss_single(cfg: TKGConfig, data: TKGData, score_all_fn,
                      rel_embeds, table, t_pos: int, src, rel, dst,
                      pos_mask, neg=None):
    """Tail+head cross-entropy for one target snapshot over the candidates
    of ``cfg.negative_pool`` (``make_raw_scorers``; `neg` its drawn
    candidates, None for "all"), the positive in column 0. The mean over
    the positives `pos_mask` [E] (the edge slots the loss takes) of each
    direction, summed. `data` holds tensors."""
    src, rel, dst = src.long(), rel.long(), dst.long()
    r_emb = rel_embeds[rel]
    score_t, score_h = make_raw_scorers(cfg, data, t_pos, src, rel, dst, neg)
    ce_tail = cross_entropy_0(score_t(
        query_for(score_all_fn, table[src], r_emb, "tail"), table))
    ce_head = cross_entropy_0(score_h(
        query_for(score_all_fn, table[dst], r_emb, "head"), table))
    return _masked_mean(ce_tail, pos_mask) + _masked_mean(ce_head, pos_mask)


def cross_entropy_0(logits):
    """[P] cross-entropy of [P, C] logits whose positive is column 0."""
    return -torch.log_softmax(logits, dim=-1)[:, 0]


def both_ranks(data: TKGData, t_pos: int, sc_tail, sc_head, src, rel, dst):
    """Filtered ranks [2Q] of the tail scores sc_tail and head scores
    sc_head [Q, N] of one eval snapshot's queries (src, rel, dst [Q],
    long) against the total table (every split's facts at t): [head
    ranks, tail ranks]."""
    r2 = 2 * data.num_rels
    ranks_tail = filtered_ranks(sc_tail, dst, data.total_tail.grp[t_pos],
                                data.total_tail.val[t_pos], src * r2 + rel)
    ranks_head = filtered_ranks(sc_head, src, data.total_head.grp[t_pos],
                                data.total_head.val[t_pos], dst * r2 + rel)
    return torch.cat([ranks_head, ranks_tail])


def eval_ranks_single(cfg: TKGConfig, data: TKGData, score_all_fn,
                      score_single_fn, rel_embeds, table, t_pos: int,
                      src, rel, dst, qmask):
    """Filtered ranks for one eval snapshot, both directions.

    Returns (ranks [2Q], mask [2Q], bce scalar); the rank layout is
    [head ranks, tail ranks]. `data` holds tensors.
    """
    src, rel, dst = src.long(), rel.long(), dst.long()
    r_emb = rel_embeds[rel]
    ranks = both_ranks(data, t_pos,
                       score_all_fn(table[src], r_emb, table, "tail"),
                       score_all_fn(table[dst], r_emb, table, "head"),
                       src, rel, dst)
    # eval loss: BCE-with-logits of the positives against label 1
    pos_score = score_single_fn(table[src], r_emb, table[dst])
    bce = _masked_mean(torch.nn.functional.softplus(-pos_score), qmask)
    return ranks, torch.cat([qmask, qmask]), bce


def metrics_from_ranks(ranks, mask) -> dict:
    """MRR / Hits@1/3/10 over the masked ranks."""
    ranks = np.asarray(ranks).reshape(-1)
    mask = np.asarray(mask).reshape(-1).astype(bool)
    r = ranks[mask].astype(np.float64)
    if r.size == 0:
        return {"mrr": 0.0, "hit_1": 0.0, "hit_3": 0.0, "hit_10": 0.0, "n": 0}
    return {
        "mrr": float(np.mean(1.0 / r)),
        "hit_1": float(np.mean(r <= 1)),
        "hit_3": float(np.mean(r <= 3)),
        "hit_10": float(np.mean(r <= 10)),
        "n": int(r.size),
    }
