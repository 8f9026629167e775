"""Training loss and filtered-evaluation objectives over a dense [N, d]
entity table."""

from __future__ import annotations

import numpy as np
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.ops.membership import true_answer_mask
from temp_tpu_torch.ops.ranking import filtered_ranks
from temp_tpu_torch.ops.scores import query_for


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.sum(m).clamp(min=1.0)


def make_raw_scorers(cfg: TKGConfig, data: TKGData, t_pos: int, src, rel,
                     dst):
    """The candidate scorers of one target snapshot's train queries (src,
    rel, dst [P], long), negative pool "all": (score_tail, score_head),
    each mapping query vectors qhat [P, d] (``ops.scores.query_for``) and
    an entity table [N, d] to [P, 1 + N] logits, the positive's score (the
    query's own dst, or src, row of that table) in column 0 and the other
    true answers of the query (train facts at t) masked to -1e9. Tables
    blended by the gated losses share the one mask. `data` holds
    tensors."""
    if cfg.negative_pool != "all":
        raise NotImplementedError(
            f"negative_pool={cfg.negative_pool!r} (and its samplers "
            f"draw_negatives/draw_shared_negatives) is not ported yet; see "
            f"ROADMAP.md")
    r2 = 2 * data.num_rels

    def scorer(tbl, q_grp, pos):
        bad = true_answer_mask(tbl.grp[t_pos], tbl.val[t_pos], q_grp,
                               data.num_ents)

        def score(qhat, table):
            sc = (qhat @ table.transpose(-1, -2)).masked_fill(bad, -1e9)
            sc_pos = torch.sum(qhat * table[pos], -1)
            return torch.cat([sc_pos[:, None], sc], dim=1)
        return score

    return (scorer(data.train_tail, src * r2 + rel, dst),
            scorer(data.train_head, dst * r2 + rel, src))


def train_loss_single(cfg: TKGConfig, data: TKGData, score_all_fn,
                      rel_embeds, table, t_pos: int, src, rel, dst,
                      pos_mask):
    """Tail+head cross-entropy for one target snapshot, negative pool
    "all": an exact softmax over every entity, the other true answers of
    each query (train facts at t) masked out, the positive in column 0
    (``make_raw_scorers``). The mean over the positives `pos_mask` [E] (the
    edge slots the loss takes) of each direction, summed. `data` holds
    tensors."""
    src, rel, dst = src.long(), rel.long(), dst.long()
    r_emb = rel_embeds[rel]
    score_t, score_h = make_raw_scorers(cfg, data, t_pos, src, rel, dst)
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
