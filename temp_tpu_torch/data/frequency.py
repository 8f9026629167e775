"""Frequency features of the gated TeMP models, as dense numpy arrays.

The gates of ``models/post.py`` read, for every edge slot of every split at
every time position, how often the edge's entities and relation occur in
the train facts around that time:

- ``*_sub[T, E, 3]`` = [obj_freq, rel_freq, obj_rel_freq] (the features of
  the subject query, whose answer is the subject) and
- ``*_obj[T, E, 3]`` = [sub_freq, rel_freq, sub_rel_freq],

after the JAX package's ``data/frequency.py`` (the reference's
utils/frequency.py and models/PostDynamicRGCN.py:284-321). Its rule, kept
exactly: counts come from the TRAIN facts only; the count of an item at
target time t sums its occurrences over the window [t-L+1, t), plus the
future window (t, t+L-1] for the Bi modules; and it is zero for an item
that does not occur in the train facts AT t.

The JAX package walks nested dicts item by item. Here each category's
train occurrences are sorted once by (item, time), so every window count
is two binary searches: the same integers, built in a fraction of a
second at icews14's sizes. The DropEdge rates of the same module
(``with_drop_rates``) are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from temp_tpu_torch.data.snapshots import TKGData


@dataclass
class FreqFeatures:
    """Per-edge gating features of each split, float32 (numpy arrays, or
    tensors after ``data.snapshots.to_device``)."""

    train_sub: Any   # [T, E_train, 3]
    train_obj: Any
    valid_sub: Any   # [T, E_eval, 3]
    valid_obj: Any
    test_sub: Any
    test_obj: Any


class _Occurrences:
    """The train occurrences of one category's items (an int64 key per edge
    slot), sorted by (item, time), counted over time ranges."""

    def __init__(self, keys, emask, num_times: int):
        t, e = np.nonzero(emask)
        self.items, inv = np.unique(keys[t, e], return_inverse=True)
        self.codes = np.sort(inv.astype(np.int64) * num_times + t)
        self.num_times = num_times

    def count(self, keys, lo, hi):
        """Occurrences of each item `keys` [M] at the times [lo, hi) [M]
        (0 for an item that never occurs in the train facts)."""
        if self.items.size == 0:
            return np.zeros(keys.shape, np.int64)
        u = np.searchsorted(self.items, keys)
        found = self.items[np.minimum(u, self.items.size - 1)] == keys
        base = u.astype(np.int64) * self.num_times
        n = (np.searchsorted(self.codes, base + np.maximum(hi, lo))
             - np.searchsorted(self.codes, base + lo))
        return np.where(found, n, 0)


def _window_counts(occ: _Occurrences, keys, t, seq_len: int, future: bool):
    """The JAX package's aggregate at each (target time t, item key): the
    item's occurrences over the window of t when it occurs at t, else 0."""
    T = occ.num_times
    present = occ.count(keys, t, t + 1) > 0
    n = occ.count(keys, np.maximum(0, t - seq_len + 1), t)
    if future:
        n = n + occ.count(keys, t + 1, np.minimum(T, t + seq_len))
    return np.where(present, n, 0)


def _split_keys(src, rel, dst, r2: int):
    """Each category's int64 key of an edge (subject, object, relation,
    (subject, relation), (object, relation))."""
    src, rel, dst = (np.asarray(a).astype(np.int64) for a in (src, rel, dst))
    return {"sub": src, "obj": dst, "rel": rel, "sub_rel": src * r2 + rel,
            "obj_rel": dst * r2 + rel}


def _edge_features(split, occ, r2: int, seq_len: int, future: bool):
    """(sub [T, E, 3], obj [T, E, 3]) of one split's edge slots; zero rows
    for the padded slots."""
    emask = np.asarray(split.emask)
    T, E = emask.shape
    t, e = np.nonzero(emask)
    keys = _split_keys(split.src, split.rel, split.dst, r2)
    agg = {k: _window_counts(occ[k], keys[k][t, e], t, seq_len, future)
           for k in occ}
    sub_f = np.zeros((T, E, 3), np.float32)
    obj_f = np.zeros((T, E, 3), np.float32)
    sub_f[t, e] = np.stack([agg["obj"], agg["rel"], agg["obj_rel"]], 1)
    obj_f[t, e] = np.stack([agg["sub"], agg["rel"], agg["sub_rel"]], 1)
    return sub_f, obj_f


def build_freq_features(data: TKGData, seq_len: int, future: bool,
                        with_drop_rates: bool = False) -> FreqFeatures:
    """The gating features of every split of the host dataset `data` for
    windows of `seq_len` snapshots (``future`` for the Bi modules)."""
    if with_drop_rates:
        raise NotImplementedError("the DropEdge rates (edge_dropout) are "
                                  "not ported yet; see ROADMAP.md")
    tr = data.train
    r2 = 2 * data.num_rels
    T = data.num_times
    emask = np.asarray(tr.emask)
    occ = {k: _Occurrences(v, emask, T)
           for k, v in _split_keys(tr.src, tr.rel, tr.dst, r2).items()}
    feats = {}
    for name in ("train", "valid", "test"):
        sub_f, obj_f = _edge_features(getattr(data, name), occ, r2, seq_len,
                                      future)
        feats[f"{name}_sub"], feats[f"{name}_obj"] = sub_f, obj_f
    return FreqFeatures(**feats)
