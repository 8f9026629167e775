"""Training loss and filtered-evaluation objectives over a dense [N, d]
entity table."""

from __future__ import annotations

import numpy as np
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.ops.membership import true_answer_mask
from temp_tpu_torch.ops.ranking import filtered_ranks
from temp_tpu_torch.ops.scores import score_against_rows, score_positive_rows


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.sum(m).clamp(min=1.0)


def train_loss_single(cfg: TKGConfig, data: TKGData, score_all_fn,
                      rel_embeds, table, t_pos: int, src, rel, dst,
                      pos_mask):
    """Tail+head cross-entropy for one target snapshot, negative pool
    "all": an exact softmax over every entity, the other true answers of
    each query (train facts at t) masked out, the positive in column 0.
    The mean over the positives `pos_mask` [E] (the edge slots the loss
    takes) of each direction, summed. `data` holds tensors."""
    if cfg.negative_pool != "all":
        raise NotImplementedError(
            f"negative_pool={cfg.negative_pool!r} (and its samplers "
            f"draw_negatives/draw_shared_negatives) is not ported yet; see "
            f"ROADMAP.md")
    r2 = 2 * data.num_rels
    src, rel, dst = src.long(), rel.long(), dst.long()
    r_emb = rel_embeds[rel]

    def ce_all(tbl, q_grp, q_rows, pos_rows, mode):
        bad = true_answer_mask(tbl.grp[t_pos], tbl.val[t_pos], q_grp,
                               data.num_ents)
        sc = score_against_rows(score_all_fn, q_rows, r_emb, table, mode)
        sc = sc.masked_fill(bad, -1e9)
        sc_pos = score_positive_rows(score_all_fn, q_rows, r_emb, pos_rows,
                                     mode)
        logits = torch.cat([sc_pos[:, None], sc], dim=1)
        return -torch.log_softmax(logits, dim=-1)[:, 0]

    ce_tail = ce_all(data.train_tail, src * r2 + rel, table[src], table[dst],
                     "tail")
    ce_head = ce_all(data.train_head, dst * r2 + rel, table[dst], table[src],
                     "head")
    return _masked_mean(ce_tail, pos_mask) + _masked_mean(ce_head, pos_mask)


def eval_ranks_single(cfg: TKGConfig, data: TKGData, score_all_fn,
                      score_single_fn, rel_embeds, table, t_pos: int,
                      src, rel, dst, qmask):
    """Filtered ranks for one eval snapshot, both directions.

    Returns (ranks [2Q], mask [2Q], bce scalar); the rank layout is
    [head ranks, tail ranks]. `data` holds tensors.
    """
    r2 = 2 * data.num_rels
    src, rel, dst = src.long(), rel.long(), dst.long()
    r_emb = rel_embeds[rel]
    sc_tail = score_all_fn(table[src], r_emb, table, "tail")       # [Q, N]
    ranks_tail = filtered_ranks(sc_tail, dst, data.total_tail.grp[t_pos],
                                data.total_tail.val[t_pos], src * r2 + rel)
    sc_head = score_all_fn(table[dst], r_emb, table, "head")
    ranks_head = filtered_ranks(sc_head, src, data.total_head.grp[t_pos],
                                data.total_head.val[t_pos], dst * r2 + rel)
    # eval loss: BCE-with-logits of the positives against label 1
    pos_score = score_single_fn(table[src], r_emb, table[dst])
    bce = _masked_mean(torch.nn.functional.softplus(-pos_score), qmask)
    return (torch.cat([ranks_head, ranks_tail]),
            torch.cat([qmask, qmask]), bce)


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
