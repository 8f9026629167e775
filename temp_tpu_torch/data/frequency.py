"""Frequency features of the gated TeMP models and DropEdge's drop rates,
as dense numpy arrays.

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

``build_drop_rates`` gives DropEdge's rates (``edge_dropout``; the JAX
package's ``_drop_rates``, after the reference's utils/DropEdge.py:97-106):
for target t and window step o, each train edge (s, r, o') of the step's
snapshot is dropped with probability lower + (upper - lower) * (1 - l /
(n + l)), where n is the window count at t of the edge's triple, else of
its (s, o') pair, else of (s, r), else of (o', r), the first of them that
occurs at t, with l its lambda (lambda_1, lambda_2, lambda_3, lambda_3);
and with probability lower when none occurs at t. Step o of the forward
window is time t - L + 1 + o, of the backward one t + L - 1 - o.

The JAX package walks nested dicts item by item. Here each category's
train occurrences are sorted once by (item, time), so every window count
is two binary searches: the same integers (and the same float64 rates),
built in a fraction of a second at icews14's sizes.
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
    # DropEdge's rates (``with_drop_rates``), [T, L-1, E_train] each; the
    # backward windows' zero for the unidirectional modules
    drop_rate_past: Any = None
    drop_rate_future: Any = None


class _Occurrences:
    """The train occurrences of one category's items (an int64 key per edge
    slot), sorted by (item, time), counted over time ranges."""

    def __init__(self, keys, emask, num_times: int):
        t, e = np.nonzero(emask)
        self.items, inv = np.unique(keys[t, e], return_inverse=True)
        self.codes = np.sort(inv.astype(np.int64) * num_times + t)
        self.num_times = num_times

    def window_counts(self, u, t, seq_len: int, future: bool):
        """The JAX package's aggregate at each (target time t [M], item
        u [M], an index into ``items``): the item's occurrences over the
        window of t when it occurs at t, else 0. The binary searches run
        over the queries sorted by (item, time), where numpy's searchsorted
        is fastest."""
        T = self.num_times
        base = u.astype(np.int64) * T
        order = np.argsort(base + t)
        base, ts = base[order], t[order]

        def count(lo, hi):
            return (np.searchsorted(self.codes, base + np.maximum(hi, lo))
                    - np.searchsorted(self.codes, base + lo))

        n = count(np.maximum(0, ts - seq_len + 1), ts)
        if future:
            n = n + count(ts + 1, np.minimum(T, ts + seq_len))
        out = np.empty_like(n)
        out[order] = np.where(count(ts, ts + 1) > 0, n, 0)
        return out


def _window_counts(occ: _Occurrences, keys, t, seq_len: int, future: bool):
    """``_Occurrences.window_counts`` of the items named by their keys [M]
    (0 for an item that never occurs in the train facts)."""
    if occ.items.size == 0:
        return np.zeros(keys.shape, np.int64)
    u = np.minimum(np.searchsorted(occ.items, keys), occ.items.size - 1)
    return np.where(occ.items[u] == keys,
                    occ.window_counts(u, t, seq_len, future), 0)


def _split_keys(src, rel, dst, r2: int):
    """Each category's int64 key of an edge (subject, object, relation,
    (subject, relation), (object, relation))."""
    src, rel, dst = (np.asarray(a).astype(np.int64) for a in (src, rel, dst))
    return {"sub": src, "obj": dst, "rel": rel, "sub_rel": src * r2 + rel,
            "obj_rel": dst * r2 + rel}


def _tier_keys(src, rel, dst, r2: int, n: int):
    """DropEdge's tiers in order, each (int64 key of an edge, lambda
    index): the triple, the (subject, object) pair, (subject, relation),
    (object, relation)."""
    src, rel, dst = (np.asarray(a).astype(np.int64) for a in (src, rel, dst))
    return [((src * r2 + rel) * n + dst, 0), (src * n + dst, 1),
            (src * r2 + rel, 2), (dst * r2 + rel, 2)]


def build_drop_rates(data: TKGData, seq_len: int, future: bool,
                     rate_lower: float = 0.2, rate_upper: float = 0.8,
                     lambda_1: float = 2.0, lambda_2: float = 10.0,
                     lambda_3: float = 20.0):
    """DropEdge's rates (past, future), each float32 [T, L-1, E_train]:
    entry [t, o, e] the drop probability of train edge slot e of window
    step o of target t (the forward window's for past, the backward
    window's for future, zeros unless `future`); 0 where the step lies off
    the data or the slot is padding. The windows' counts are over the past
    window, and the future one too when `future` (the Bi modules)."""
    tr = data.train
    T, L1, r2 = data.num_times, seq_len - 1, 2 * data.num_rels
    emask = np.asarray(tr.emask)
    E = emask.shape[1]
    tiers = _tier_keys(tr.src, tr.rel, tr.dst, r2, data.num_ents)
    occ = [_Occurrences(k, emask, T) for k, _ in tiers]
    # each edge slot's item index in each tier (a train edge's key is an
    # item of its tier)
    items = [np.searchsorted(o.items, k) for (k, _), o in zip(tiers, occ)]
    lambdas = (lambda_1, lambda_2, lambda_3)
    diff = rate_upper - rate_lower
    t = np.repeat(np.arange(T), L1)
    off = np.tile(np.arange(L1), T)
    out = []
    for backward in (False, True):
        rates = np.zeros((T, L1, E), np.float32)
        out.append(rates)
        if backward and not future:
            continue
        cur = t + L1 - off if backward else t - L1 + off
        ok = (cur >= 0) & (cur < T)
        m, e = np.nonzero(emask[np.clip(cur, 0, T - 1)] & ok[:, None])
        tm, cm = t[m], cur[m]
        rate = np.full(m.shape, rate_lower, np.float64)
        todo = np.ones(m.shape, bool)
        for (_, li), o, u in zip(tiers, occ, items):
            n = o.window_counts(u[cm, e], tm, seq_len, future)
            hit = todo & (n > 0)
            lam = lambdas[li]
            rate[hit] = rate_lower + diff * (1 - lam / (n[hit] + lam))
            todo &= ~hit
        rates[tm, off[m], e] = rate
    return out[0], out[1]


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
                        with_drop_rates: bool = False,
                        **rate_kw) -> FreqFeatures:
    """The gating features of every split of the host dataset `data` for
    windows of `seq_len` snapshots (``future`` for the Bi modules); with
    `with_drop_rates` also DropEdge's rates (``build_drop_rates``, whose
    rate bounds and lambdas `rate_kw` gives)."""
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
    if with_drop_rates:
        feats["drop_rate_past"], feats["drop_rate_future"] = (
            build_drop_rates(data, seq_len, future, **rate_kw))
    return FreqFeatures(**feats)
