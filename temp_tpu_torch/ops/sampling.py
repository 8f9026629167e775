"""Random subsets of a snapshot's edges for training.

``subsample_edges`` keeps exactly floor(rate * n_valid) of the masked edges
(the final snapshot trains on a 50% subsample), ``subsample_positives`` at
most ``max_facts`` of them (the positives of the loss). Both are uniform
without replacement: every masked edge gets a uniform key, padding sorts
last, and the lowest keys stay. The draws come from a ``torch.Generator``
on the tensor's device, so they differ from the JAX package's threefry bits
for the same seed; tests compare invariants and distributions, and hand the
JAX draws to the model where they need the same subset.

The negative samplers (``draw_negatives``, ``draw_shared_negatives``) belong
to the ``per_query`` and ``shared`` pools, which are not ported yet.
"""

from __future__ import annotations

import torch


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
