"""Static-shape snapshot arrays, built on the host with numpy.

Every snapshot is a fixed-width padded edge list in global entity ids:

- ``src/rel/dst[T, E_pad]`` int32 + ``emask[T, E_pad]`` per split;
- ``active[T, N]`` bool: entities touched by any train/valid/test fact at t;
- per-time sorted (group, value) filter tables for the true-head/true-tail
  lookups of filtered ranking;
- the compact active sets ``act_idx/act_mask`` and the train edges in those
  compact coordinates, which the history window runs on.

``TKGData`` holds numpy arrays; ``to_device`` gives the same structure with
torch tensors on a device. ``build_tkg_data`` loads a dataset directory,
with an npz cache at the root of the checkout. The edge buckets and the
filter tables pack natively (``data/native.py``) where the library is
available; the numpy path is the reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from temp_tpu_torch.data import native
from temp_tpu_torch.data.quadruples import load_quadruples, load_stat
from temp_tpu_torch.parallel.edge_partition import (
    boundary_data, ring_data, ring_regroup_data,
)

INT_PAD = np.iinfo(np.int32).max


def _round_up(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def _map_fields(obj, fn: Callable):
    """Apply `fn` to every array field of a dataclass, recursing into nested
    dataclasses; ints and None stay as they are."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _map_fields(v, fn)
        elif isinstance(v, (np.ndarray, torch.Tensor)):
            v = fn(v)
        kw[f.name] = v
    return type(obj)(**kw)


@dataclass
class SplitEdges:
    """Per-timestamp padded edge lists for one split."""

    src: Any      # [T, E_pad] int32 global entity ids (0 where padded)
    rel: Any      # [T, E_pad] int32 relation ids
    dst: Any      # [T, E_pad] int32
    emask: Any    # [T, E_pad] bool: True for real edges
    n_edges: Any  # [T] int32


@dataclass
class FilterTable:
    """Per-timestamp (group, value) pairs sorted lexicographically.

    Tail queries: group = head * (2*num_rels) + rel, value = tail.
    Head queries: group = tail * (2*num_rels) + rel, value = head.
    Padding is INT32_MAX, so it sorts last and never matches.
    """

    grp: Any  # [T, F_pad] int32
    val: Any  # [T, F_pad] int32


@dataclass
class TKGData:
    """The dataset: every array indexed by time position 0..T-1."""

    train: SplitEdges
    valid: SplitEdges
    test: SplitEdges
    active: Any         # [T, N] bool
    times: Any          # [T] int32 raw time values (sorted)
    act_idx: Any        # [T, A_pad] int32 active entity ids (pad: num_ents)
    act_mask: Any       # [T, A_pad] bool
    train_src_loc: Any  # [T, E_pad] int32 src position within the act_idx row
    train_dst_loc: Any  # [T, E_pad] int32
    train_tail: FilterTable
    train_head: FilterTable
    total_tail: FilterTable
    total_head: FilterTable
    num_ents: int = 0
    num_rels: int = 0
    num_times: int = 0
    # the edge partition's tables of the train snapshots, built by
    # ring_layout: kernel K13's static CSR tables for "ring_pallas"
    # (parallel/edge_partition.py RingData), the exchange tables and K1's
    # tables of the ranks' edge slices for "boundary" (BoundaryData), else
    # None
    ring: Any = None
    # kernel K1's (RingData of one rank); built by ring_layout, else None
    spmm: Any = None

    @property
    def group_stride(self) -> int:
        return 2 * self.num_rels

    @property
    def bnd_c(self):
        """The boundary exchange's compact-space table [T, m, m, Cc] (the
        JAX package's ``TKGData.bnd_c``), or None."""
        return getattr(self.ring, "bnd_c", None)

    @property
    def bnd_g(self):
        """The boundary exchange's global-space table [T, m, m, Cg], or
        None."""
        return getattr(self.ring, "bnd_g", None)


@dataclass
class HistoryTables:
    """Last-active gather indices for the compact history window.

    For window length L ending at target position t: ``prev_step[t, k, a]``
    is the last step < k at which the entity of slot a of step k was active
    (or -1), and ``prev_row`` its slot in that step's act row. ``fin_*`` give
    the same for every entity after the last window step.
    """

    prev_step: Any  # [T, L-1, A] int16
    prev_row: Any   # [T, L-1, A] int16
    fin_step: Any   # [T, N] int16
    fin_row: Any    # [T, N] int16


@dataclass
class AnswerLists:
    """The true answers of each edge slot's query of one split, as one list
    a slot (the fused final step's loss masks them for the train slots, the
    fused eval's ranks for the valid and test slots).

    For slot e of time position t, ``tail_val[tail_ptr[t, e]:tail_ptr[t,
    e + 1]]`` (sorted ascending) are the entities c with (group, c) in the
    split's filter table at t, group = head * 2R + rel: the train filter
    table for the train slots, the total table (the facts of all three
    splits) for the valid and test slots, the slot's own tail among them.
    ``head_*`` the same for the head query (group = tail * 2R + rel).
    Padded slots have empty lists.
    """

    tail_ptr: Any  # [T, E_pad + 1] int32 offsets into tail_val
    tail_val: Any  # [n] int32
    head_ptr: Any
    head_val: Any


def to_device(obj, device):
    """The same dataclass with every numpy array as a tensor on `device`."""
    return _map_fields(obj, lambda a: torch.as_tensor(np.asarray(a)).to(device))


def build_history_tables(data: TKGData, length: int,
                         backward: bool = False) -> HistoryTables:
    """Host-side construction (numpy); see HistoryTables."""
    act_idx = np.asarray(data.act_idx)
    act_mask = np.asarray(data.act_mask)
    T, A = act_idx.shape
    N = data.num_ents
    L1 = length - 1
    prev_step = np.full((T, L1, A), -1, np.int16)
    prev_row = np.zeros((T, L1, A), np.int16)
    fin_step = np.full((T, N), -1, np.int16)
    fin_row = np.zeros((T, N), np.int16)
    rows_arange = np.arange(A, dtype=np.int16)

    for t in range(T):
        last_step = np.full(N + 1, -1, np.int16)  # +1: padding id == num_ents
        last_row = np.zeros(N + 1, np.int16)
        for k in range(L1):
            wpos = (t + L1 - k) if backward else (t - L1 + k)
            valid = (wpos <= T - 1) if backward else (wpos >= 0)
            safe = min(max(wpos, 0), T - 1)
            ids = act_idx[safe]
            mask = act_mask[safe] & valid
            prev_step[t, k] = last_step[ids]
            prev_row[t, k] = last_row[ids]
            upd = ids[mask]
            last_step[upd] = k
            last_row[upd] = rows_arange[mask]
        fin_step[t] = last_step[:N]
        fin_row[t] = last_row[:N]
    return HistoryTables(prev_step=prev_step, prev_row=prev_row,
                         fin_step=fin_step, fin_row=fin_row)


def _time_pos_lut(times: np.ndarray) -> np.ndarray:
    """Raw time value -> its position in the sorted unique `times` (-1 for
    a value that is not there)."""
    lut = np.full(int(times.max()) + 1 if len(times) else 1, -1, np.int32)
    lut[times] = np.arange(len(times), dtype=np.int32)
    return lut


def _native_ok(quads: np.ndarray, times: np.ndarray) -> bool:
    """Whether the native packer can take these arrays: edges to pack, and
    raw time values that index its lookup table."""
    return bool(len(quads) and len(times) and times.min() >= 0)


def _split_edges(quads: np.ndarray, times: np.ndarray, e_pad: int) -> SplitEdges:
    """Per-time padded edge arrays of one split, each time's edges in the
    order of `quads`: natively where the library is available."""
    T = len(times)
    if _native_ok(quads, times):
        packed = native.pack_snapshots(quads, _time_pos_lut(times), T, e_pad)
        if packed is not None:
            return SplitEdges(*packed)
    src = np.zeros((T, e_pad), np.int32)
    rel = np.zeros((T, e_pad), np.int32)
    dst = np.zeros((T, e_pad), np.int32)
    emask = np.zeros((T, e_pad), bool)
    n_edges = np.zeros((T,), np.int32)
    order = np.argsort(quads[:, 3], kind="stable")
    quads = quads[order]
    bounds = np.append(np.searchsorted(quads[:, 3], times), len(quads))
    for i in range(T):
        rows = quads[bounds[i]:bounds[i + 1]]
        k = len(rows)
        if k > e_pad:
            raise ValueError(f"{k} edges at time position {i} exceed the "
                             f"pad width {e_pad}")
        src[i, :k] = rows[:, 0]
        rel[i, :k] = rows[:, 1]
        dst[i, :k] = rows[:, 2]
        emask[i, :k] = True
        n_edges[i] = k
    return SplitEdges(src=src, rel=rel, dst=dst, emask=emask, n_edges=n_edges)


def _filter_tables(quads: np.ndarray, times: np.ndarray, num_rels: int,
                   pad_mult: int) -> Tuple[FilterTable, FilterTable]:
    """Build (tail_table, head_table) of deduped sorted per-time pairs:
    natively where the library is available."""
    T = len(times)
    r2 = 2 * num_rels
    if _native_ok(quads, times):
        # the pad width follows the largest per-time fact count
        f_pad = _round_up(int(np.unique(quads[:, 3], return_counts=True)[1]
                              .max()), pad_mult)
        lut = _time_pos_lut(times)
        tail = native.filter_pairs(quads, lut, T, f_pad, "tail", r2)
        if tail is not None:
            head = native.filter_pairs(quads, lut, T, f_pad, "head", r2)
            return FilterTable(*tail), FilterTable(*head)
    per_time_tail = []
    per_time_head = []
    order = np.argsort(quads[:, 3], kind="stable")
    quads = quads[order]
    bounds = np.append(np.searchsorted(quads[:, 3], times), len(quads))
    empty = np.zeros((0, 2), np.int64)
    for i in range(T):
        rows = quads[bounds[i]:bounds[i + 1]]
        tg = rows[:, 0].astype(np.int64) * r2 + rows[:, 1]
        hg = rows[:, 2].astype(np.int64) * r2 + rows[:, 1]
        tv = rows[:, 2].astype(np.int64)
        hv = rows[:, 0].astype(np.int64)
        per_time_tail.append(np.unique(np.stack([tg, tv], 1), axis=0)
                             if len(rows) else empty)
        per_time_head.append(np.unique(np.stack([hg, hv], 1), axis=0)
                             if len(rows) else empty)
    # the pad width follows the largest per-time fact count (duplicates
    # included), so it does not depend on how many pairs deduplicate
    counts = np.unique(quads[:, 3], return_counts=True)[1] if len(quads) else [0]
    f_pad = _round_up(int(np.max(counts)), pad_mult)

    def pack(per_time):
        grp = np.full((T, f_pad), INT_PAD, np.int32)
        val = np.full((T, f_pad), INT_PAD, np.int32)
        for i, pairs in enumerate(per_time):
            k = len(pairs)
            grp[i, :k] = pairs[:, 0]
            val[i, :k] = pairs[:, 1]
        return FilterTable(grp=grp, val=val)

    return pack(per_time_tail), pack(per_time_head)


def build_answer_lists(data: TKGData, split: str = "train") -> AnswerLists:
    """Host-side construction (numpy) for the edge slots of `split`
    ("train", "valid" or "test"); see AnswerLists."""
    edges = getattr(data, split)
    tables = ((data.train_tail, data.train_head) if split == "train"
              else (data.total_tail, data.total_head))
    r2 = 2 * data.num_rels
    rel, n_edges = np.asarray(edges.rel), np.asarray(edges.n_edges)
    T, e_pad = rel.shape
    out = {}
    for name, grp_ids, table in (("tail", edges.src, tables[0]),
                                 ("head", edges.dst, tables[1])):
        grp_ids = np.asarray(grp_ids)
        t_grp, t_val = np.asarray(table.grp), np.asarray(table.val)
        ptr = np.zeros((T, e_pad + 1), np.int64)
        vals = []
        off = 0
        for t in range(T):
            k = int(n_edges[t])
            ptr[t] = off
            if k == 0:
                continue
            # the table's row is sorted by (group, value), padding last
            grp = grp_ids[t, :k].astype(np.int64) * r2 + rel[t, :k]
            lo = np.searchsorted(t_grp[t], grp, "left")
            lens = np.searchsorted(t_grp[t], grp, "right") - lo
            ends = np.cumsum(lens)
            idx = (np.repeat(lo, lens) + np.arange(ends[-1])
                   - np.repeat(ends - lens, lens))
            vals.append(t_val[t][idx])
            ptr[t, 1:k + 1] = off + ends
            ptr[t, k + 1:] = off + ends[-1]
            off += int(ends[-1])
        out[f"{name}_ptr"] = ptr.astype(np.int32)
        out[f"{name}_val"] = (np.concatenate(vals) if vals
                              else np.zeros(0, np.int64)).astype(np.int32)
    return AnswerLists(**out)


def add_reverse_edges(quads: np.ndarray, num_rels: int) -> np.ndarray:
    """Double the edge set with inverse relations ``rel + num_rels``
    (extrapolation-mode graphs)."""
    if len(quads) == 0:
        return quads
    rev = np.stack([quads[:, 2], quads[:, 1] + num_rels, quads[:, 0],
                    quads[:, 3]], 1)
    return np.concatenate([quads, rev], 0)


def build_tkg_data_from_quads(
    train_q: np.ndarray,
    valid_q: np.ndarray,
    test_q: np.ndarray,
    num_ents: int,
    num_rels: int,
    edge_pad_multiple: int = 128,
) -> TKGData:
    """Assemble TKGData from raw quadruple arrays (host-side numpy)."""
    total_q = np.concatenate([train_q, valid_q, test_q], axis=0)
    if len(total_q) == 0:
        raise ValueError("dataset has no quadruples in any split")
    times = np.unique(total_q[:, 3])
    T = len(times)

    def count_max(quads):
        if len(quads) == 0:
            return 0
        return int(np.unique(quads[:, 3], return_counts=True)[1].max())

    e_pad_train = _round_up(count_max(train_q), edge_pad_multiple)
    e_pad_eval = _round_up(max(count_max(valid_q), count_max(test_q), 1),
                           edge_pad_multiple)

    train = _split_edges(train_q, times, e_pad_train)
    valid = _split_edges(valid_q, times, e_pad_eval)
    test = _split_edges(test_q, times, e_pad_eval)

    active = np.zeros((T, num_ents), bool)
    order = np.argsort(total_q[:, 3], kind="stable")
    tq = total_q[order]
    bounds = np.append(np.searchsorted(tq[:, 3], times), len(tq))
    for i in range(T):
        rows = tq[bounds[i]:bounds[i + 1]]
        active[i, rows[:, 0]] = True
        active[i, rows[:, 2]] = True

    train_tail, train_head = _filter_tables(train_q, times, num_rels,
                                            edge_pad_multiple)
    total_tail, total_head = _filter_tables(total_q, times, num_rels,
                                            edge_pad_multiple)

    max_active = max(1, int(active.sum(axis=1).max()))
    a_pad = _round_up(max_active, min(edge_pad_multiple, 128))
    # padding slots hold the out-of-range id num_ents, so they can never
    # alias a real entity row
    act_idx = np.full((T, a_pad), num_ents, np.int32)
    act_mask = np.zeros((T, a_pad), bool)
    src_loc = np.zeros((T, e_pad_train), np.int32)
    dst_loc = np.zeros((T, e_pad_train), np.int32)
    for i in range(T):
        ids = np.nonzero(active[i])[0]
        act_idx[i, :len(ids)] = ids
        act_mask[i, :len(ids)] = True
        inv = np.zeros(num_ents, np.int32)
        inv[ids] = np.arange(len(ids), dtype=np.int32)
        k = int(train.n_edges[i])
        src_loc[i, :k] = inv[train.src[i, :k]]
        dst_loc[i, :k] = inv[train.dst[i, :k]]

    return TKGData(
        train=train, valid=valid, test=test,
        active=active, times=times.astype(np.int32),
        act_idx=act_idx, act_mask=act_mask,
        train_src_loc=src_loc, train_dst_loc=dst_loc,
        train_tail=train_tail, train_head=train_head,
        total_tail=total_tail, total_head=total_head,
        num_ents=num_ents, num_rels=num_rels, num_times=T,
    )


def make_synthetic(
    num_ents: int = 40,
    num_rels: int = 5,
    num_times: int = 12,
    edges_per_time: int = 30,
    seed: int = 0,
    edge_pad_multiple: int = 16,
) -> TKGData:
    """Random TKG drawn from `seed` with numpy's RandomState: the same
    quadruples as the JAX package's ``make_synthetic`` for the same seed."""
    return build_tkg_data_from_quads(
        *synthetic_quads(num_ents, num_rels, num_times, edges_per_time, seed),
        num_ents, num_rels, edge_pad_multiple)


def synthetic_quads(num_ents: int, num_rels: int, num_times: int,
                    edges_per_time: int, seed: int = 0):
    """``make_synthetic``'s (train, valid, test) quadruples, int64 [M, 4]
    each."""
    rng = np.random.RandomState(seed)

    def sample(n):
        h = rng.randint(0, num_ents, n)
        r = rng.randint(0, num_rels, n)
        t = rng.randint(0, num_ents, n)
        tm = np.repeat(np.arange(num_times), n // num_times)
        tm = np.concatenate([tm, rng.randint(0, num_times, n - len(tm))])
        return np.stack([h, r, t, tm], 1).astype(np.int64)

    train_q = sample(edges_per_time * num_times)
    valid_q = sample(edges_per_time * num_times // 4)
    test_q = sample(edges_per_time * num_times // 4)
    return train_q, valid_q, test_q


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".data_cache")
_CACHE_VERSION = "torch-v1"


def build_tkg_data(cfg, cache: bool = True,
                   cache_dir: str = CACHE_DIR) -> TKGData:
    """Load ``cfg.dataset_path`` (stat.txt and train/valid/test.txt) into
    TKGData, through an npz cache of the packed arrays in `cache_dir`
    (keyed by path, dataset_dir, edge_pad_multiple and this package's
    version key). Extrapolation datasets carry both edge directions, the
    reverse with relation id rel + num_rels, and icews14's dev split there
    is its test split, as in the reference. A ring edge partition
    regroups the result (``ring_layout``); the cache holds the arrays
    before that."""
    path = cfg.dataset_path
    num_ents, num_rels, _ = load_stat(path)
    key = hashlib.md5(
        f"{path}:{cfg.dataset_dir}:{cfg.edge_pad_multiple}:{_CACHE_VERSION}"
        .encode()).hexdigest()[:16]
    cache_file = os.path.join(
        cache_dir, f"tkg_torch_{os.path.basename(path)}_{key}.npz")
    if cache and os.path.exists(cache_file):
        with np.load(cache_file) as z:
            return ring_layout(cfg, _from_npz(z, num_ents, num_rels))

    train_q, _ = load_quadruples(path, "train.txt")
    valid_q, _ = load_quadruples(path, "valid.txt")
    test_q, _ = load_quadruples(path, "test.txt")
    if cfg.dataset_dir == "extrapolation":
        if cfg.dataset == "icews14":
            valid_q = test_q.copy()
        train_q = add_reverse_edges(train_q, num_rels)
        valid_q = add_reverse_edges(valid_q, num_rels)
        test_q = add_reverse_edges(test_q, num_rels)
    data = build_tkg_data_from_quads(train_q, valid_q, test_q, num_ents,
                                     num_rels, cfg.edge_pad_multiple)
    if cache:
        # concurrent processes each write a private file and rename it in,
        # so a reader never sees a half-written cache
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{cache_file}.{os.getpid()}.tmp.npz"
        try:
            np.savez_compressed(tmp, **_to_npz(data))
            os.replace(tmp, cache_file)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ring_layout(cfg, data)


def ring_layout(cfg, data: TKGData) -> TKGData:
    """The edges grouped by destination owner, for the ring and boundary
    edge-partition modes with more than one rank (``ring_regroup_data``),
    as the JAX package lays them out in ``build_tkg_data``: everything
    downstream (the history tables, the answer lists) is built from this
    one layout. Then the static tables of the train snapshots in that
    layout, built here once rather than in every call: K1's (one rank,
    ``TKGData.spmm``, ``ring_data``), which every unpartitioned SpMM
    walks; for "ring_pallas" K13's (``TKGData.ring``); for "boundary" the
    exchange tables (``bnd_c``, ``bnd_g``, the JAX package's
    ``boundary_tables``) and K1's tables of each rank's edge slice
    (``TKGData.ring``, ``boundary_data``)."""
    mode = cfg.edge_partition_mode
    if cfg.partitioned and mode in ("ring", "ring_pallas", "boundary"):
        m = int(cfg.mp_size)
        data = ring_regroup_data(data, m)
        if mode == "ring_pallas":
            data = dataclasses.replace(data, ring=ring_data(data, m))
        elif mode == "boundary":
            data = dataclasses.replace(data, ring=boundary_data(data, m))
    return dataclasses.replace(data, spmm=ring_data(data, 1))


_SPLITS = ("train", "valid", "test")
_TABLES = ("train_tail", "train_head", "total_tail", "total_head")

_EDGE_FIELDS = ("src", "rel", "dst", "emask", "n_edges")
_PLAIN = ("times", "active", "act_idx", "act_mask", "train_src_loc",
          "train_dst_loc")


def _to_npz(d: TKGData) -> Dict[str, np.ndarray]:
    out = {k: np.asarray(getattr(d, k)) for k in _PLAIN}
    out["num_times"] = np.int64(d.num_times)
    for name in _SPLITS:
        for f in _EDGE_FIELDS:
            out[f"{name}_{f}"] = np.asarray(getattr(getattr(d, name), f))
    for name in _TABLES:
        t = getattr(d, name)
        out[f"{name}_grp"] = np.asarray(t.grp)
        out[f"{name}_val"] = np.asarray(t.val)
    return out


def _from_npz(z, num_ents: int, num_rels: int) -> TKGData:
    return TKGData(
        **{name: SplitEdges(**{f: z[f"{name}_{f}"] for f in _EDGE_FIELDS})
           for name in _SPLITS},
        **{name: FilterTable(grp=z[f"{name}_grp"], val=z[f"{name}_val"])
           for name in _TABLES},
        **{k: z[k] for k in _PLAIN},
        num_ents=num_ents, num_rels=num_rels, num_times=int(z["num_times"]))
