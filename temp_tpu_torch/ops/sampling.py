"""The random draws of training: subsets of a snapshot's edges and the
loss's negative candidates.

``subsample_edges`` keeps exactly floor(rate * n_valid) of the masked edges
(the final snapshot trains on a 50% subsample), ``subsample_positives`` at
most ``max_facts`` of them (the positives of the loss). Both are uniform
without replacement: every masked edge gets a uniform key, padding sorts
last, and the lowest keys stay. The draws come from a ``torch.Generator``
on the tensor's device, so they differ from the JAX package's threefry bits
for the same seed; tests compare invariants and distributions, and hand the
JAX draws to the model where they need the same subset.

The negative samplers belong to the loss's candidate pools:
``draw_negatives`` to ``per_query`` (each positive its own candidates,
none a true answer of its query where a valid draw is at hand) and
``draw_shared_negatives`` to ``shared`` (one pool a snapshot and direction,
its true answers masked per query). Validity comes from the filter tables
through ``true_answer_mask``.
"""

from __future__ import annotations

import torch

from temp_tpu_torch.ops.membership import true_answer_mask


def _keep_lowest(gen, emask, n_keep):
    """emask & (rank of the edge's uniform key < n_keep), over the last
    axis; padding (emask False) ranks after every masked edge."""
    keys = torch.rand(emask.shape, generator=gen, device=emask.device)
    keys = torch.where(emask, keys, torch.full_like(keys, 2.0))
    order = torch.argsort(keys, dim=-1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(
        emask.shape[-1], device=emask.device).expand_as(order))
    return emask & (ranks < n_keep)


def subsample_edges(gen: torch.Generator, emask, rate: float):
    """Keep exactly floor(rate * n_valid) masked edges per row of `emask`
    [..., E] (bool), uniformly without replacement. Returns the new mask."""
    n_valid = emask.sum(-1, keepdim=True).to(torch.float32)
    n_keep = (rate * n_valid).to(torch.int64)  # truncation, as int32() does
    return _keep_lowest(gen, emask, n_keep)


def subsample_positives(gen: torch.Generator, emask, max_facts: int):
    """A uniform subset of at most `max_facts` masked edges per row of
    `emask` [..., E] (bool)."""
    return _keep_lowest(gen, emask, int(max_facts))


def shared_bad(grp_sorted, val_sorted, q_grp, num_ents: int, pool):
    """[..., P, K] bool: pool entry k is a true answer of query p (its
    group q_grp[p] holds the pair (q_grp[p], pool[k]) in the filter
    table), for a pool [..., K] long."""
    full = true_answer_mask(grp_sorted, val_sorted, q_grp, num_ents)
    idx = pool.long()[..., None, :].expand(*full.shape[:-1], pool.shape[-1])
    return torch.gather(full, -1, idx)


def draw_negatives(gen: torch.Generator, grp_sorted, val_sorted, q_grp, pos,
                   num_ents: int, negative_rate: int, oversample: int = 64,
                   strict: bool = False):
    """The ``per_query`` pool: [..., P, 1 + negative_rate] long candidate
    ids for the queries q_grp [..., P] (group keys h * 2R + r), column 0
    the positive pos [..., P], the others drawn uniformly from the
    `num_ents` entities, none a true answer of its query in the filter
    table (grp_sorted, val_sorted [..., F]) where a valid draw is at hand.

    negative_rate + oversample draws a query. By default a draw that is a
    true answer takes the spare draw at its column modulo `oversample`
    when that spare is valid (a true answer stays only where both are
    one). ``strict`` keeps the first negative_rate valid draws in draw
    order (0 fills the slots when fewer are valid).
    """
    K = negative_rate
    shape = tuple(q_grp.shape) + (K + oversample,)
    draws = torch.randint(0, num_ents, shape, generator=gen,
                          device=q_grp.device)
    full = true_answer_mask(grp_sorted, val_sorted, q_grp, num_ents)
    bad = torch.gather(full, -1, draws)
    if strict:
        valid = ~bad
        vidx = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
        dest = torch.where(valid & (vidx < K), vidx, torch.full_like(vidx, K))
        neg = torch.zeros(shape[:-1] + (K + 1,), dtype=draws.dtype,
                          device=draws.device)
        # every slot below K takes exactly one draw; the rest land in K
        neg = neg.scatter(-1, dest, draws)[..., :K]
    else:
        main, spare = draws[..., :K], draws[..., K:]
        sel = torch.arange(K, device=draws.device) % oversample
        rep, rep_bad = spare[..., sel], bad[..., K:][..., sel]
        neg = torch.where(bad[..., :K] & ~rep_bad, rep, main)
    return torch.cat([pos.long()[..., None], neg], dim=-1)


def draw_shared_negatives(gen: torch.Generator, grp_sorted, val_sorted,
                          q_grp, num_ents: int, negative_rate: int):
    """The ``shared`` pool: one pool [..., K] long of K = negative_rate
    uniform draws for all the queries q_grp [..., P] of a snapshot and
    direction, and bad [..., P, K], the pool entries that are true
    answers of each query (``shared_bad``), which its softmax masks."""
    pool = torch.randint(0, num_ents, tuple(q_grp.shape[:-1])
                         + (negative_rate,), generator=gen,
                         device=q_grp.device)
    return pool, shared_bad(grp_sorted, val_sorted, q_grp, num_ents, pool)
