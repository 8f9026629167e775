"""Edge-partitioned (model-parallel) training and eval: the data layout of
the ring and boundary modes and the wrapper that partitions a model's
SpMMs.

``ring_geometry``, ``ring_regroup_data``, ``boundary_tables`` and
``group_edges_by_dst_owner`` are the JAX package's host-side layout
helpers on numpy, giving equal arrays. ``ring_tables`` sorts a regrouped
edge set into the CSR tables that kernel K13 walks (``RingTables``);
``data.snapshots.ring_layout`` builds them once for every train snapshot
(``ring_data``), and for the boundary exchange K1's tables of each rank's
edge slice with the exchange tables (``boundary_data``).
``EdgePartitionedModel`` runs a model's ``loss`` and ``eval_ranks`` with
every ``rel_spmm`` partitioned over the model axis of a mesh
(``parallel/mesh.py``): in the ring modes each rank owns a row shard of the
entity states and the edges whose destination it owns, and the shards
rotate around the ring (``ops/segment.py``, kernel K13 in
``parallel/ring_spmm.py``); in the boundary mode each rank owns the same
edges and reads only the cut rows other ranks send it (K1 a rank). A data
axis splits the batch of target times into shards, each with its own
draws. The rest of the model runs once, on the controller.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from temp_tpu_torch.parallel.mesh import Mesh, manual_partition


def ring_geometry(num_ents: int, m: int, align: int = 128) -> int:
    """Rows of a ring shard: ceil(num_ents / m) rounded up to `align`; the
    owner of row v is v // rows, in the data layout and in the SpMM
    alike."""
    rows = -(-num_ents // m)
    return max(align, -(-rows // align) * align)


def ring_regroup_data(data, m: int, align: int = 128):
    """The ring layout of a TKGData (the JAX package's
    ``ring_regroup_data``): slice i of every train edge row holds exactly
    the edges whose dst entity ring shard i owns (padded to e_cap), and
    slice i of every compact active row holds the active entities shard i
    owns (padded to a_cap, a multiple of `align`), so an edge's compact
    owner dst_loc // a_cap equals its global owner dst // rows. Padding
    edges keep their destination inside their shard in both spaces.
    Reordering edges changes only the order of sums."""
    rows = ring_geometry(data.num_ents, m, align)
    T = data.num_times
    src = np.asarray(data.train.src)
    dst = np.asarray(data.train.dst)
    rel = np.asarray(data.train.rel)
    emask = np.asarray(data.train.emask)
    active = np.asarray(data.active)

    act_lists = [[np.nonzero(active[t, i * rows:(i + 1) * rows])[0] + i * rows
                  if i * rows < data.num_ents else np.zeros(0, np.int64)
                  for i in range(m)] for t in range(T)]
    edge_lists = [[np.nonzero((dst[t] // rows == i) & emask[t])[0]
                   for i in range(m)] for t in range(T)]
    a_cap = max(align, -(-max(len(a) for row in act_lists for a in row)
                         // align) * align)
    e_cap = max(8, -(-max(1, max(len(e) for row in edge_lists for e in row))
                     // 8) * 8)

    A_new, E_new = m * a_cap, m * e_cap
    act_idx = np.full((T, A_new), data.num_ents, np.int32)
    act_mask = np.zeros((T, A_new), bool)
    n_src, n_dst, n_rel, n_srcl, n_dstl = (np.zeros((T, E_new), np.int32)
                                           for _ in range(5))
    n_em = np.zeros((T, E_new), bool)
    for t in range(T):
        # global id -> compact slot (slot = shard * a_cap + rank in shard)
        g2l = np.full(data.num_ents + 1, A_new, np.int64)
        for i in range(m):
            ids = act_lists[t][i]
            s = i * a_cap
            act_idx[t, s:s + len(ids)] = ids
            act_mask[t, s:s + len(ids)] = True
            g2l[ids] = s + np.arange(len(ids))
        for i in range(m):
            e = edge_lists[t][i]
            s = i * e_cap
            n_src[t, s:s + len(e)] = src[t, e]
            n_dst[t, s:s + len(e)] = dst[t, e]
            n_rel[t, s:s + len(e)] = rel[t, e]
            n_em[t, s:s + len(e)] = True
            n_srcl[t, s:s + len(e)] = g2l[src[t, e]]
            n_dstl[t, s:s + len(e)] = g2l[dst[t, e]]
            n_dst[t, s + len(e):s + e_cap] = min(i * rows, data.num_ents - 1)
            n_dstl[t, s + len(e):s + e_cap] = i * a_cap

    train = dataclasses.replace(data.train, src=n_src, dst=n_dst, rel=n_rel,
                                emask=n_em)
    # the static tables of the old layout no longer describe these edges
    return dataclasses.replace(data, train=train, act_idx=act_idx,
                               act_mask=act_mask, train_src_loc=n_srcl,
                               train_dst_loc=n_dstl, ring=None, spmm=None)


@dataclass
class RingTables:
    """The edges of T snapshots in the ring layout of m ranks, sorted once
    for kernel K13 (``parallel/ring_spmm.py``), or with m = 1 for kernel K1
    (``ops/spmm.py``: ``fwd`` is then the table by destination), in one id
    space whose row shards have `rows` rows. Rank r owns edge slots
    [r * cap, (r + 1) * cap) of each snapshot (E = m * cap); its edges are
    sorted three ways, each ordering a row pointer over its keys and the
    edges' three ints in that order (positions relative to the rank's
    block of cap). Only the slots of the static mask enter; the others,
    and the padding, sort past the last row, so a call's mask (always a
    subset) is read per edge.

    - ``fwd``: by (source owner, local dst), the forward's owner segments;
      edges (src, rel, slot);
    - ``src``: by source row (owner * rows + local src), the backward's
      dh; edges (dst, rel, slot);
    - ``rel``: by relation, the backward's dw; edges (src, dst, slot).

    src and dst are ids of the space, slot the edge's index in [0, E)."""

    rows: int
    fwd_ptr: Any   # [T, m, m * rows + 1] int32
    fwd_edge: Any  # [T, m, cap, 3] int32
    src_ptr: Any   # [T, m, m * rows + 1] int32
    src_edge: Any  # [T, m, cap, 3] int32
    rel_ptr: Any   # [T, m, n_rels + 1] int32
    rel_edge: Any  # [T, m, cap, 3] int32


@dataclass
class RingData:
    """The tables of a dataset's train snapshots (K13's, or with m = 1
    K1's) in both id spaces: the final step's global ids (rows =
    ring_geometry(num_ents, m)) and the window's compact slots (rows =
    a_cap)."""

    glob: RingTables
    comp: RingTables


def ring_tables(src, dst, rel, keep, m: int, rows: int,
                n_rels: int) -> RingTables:
    """``RingTables`` of T edge lists [T, E] (torch tensors, on their
    device) in the ring layout: one stable sort an ordering for all
    snapshots and ranks, keyed by (snapshot, rank, key), so the sorted
    edges of rank r of snapshot t are positions [(t * m + r) * cap, +cap)
    and keep their slot order within a key. Slots where `keep` is False
    sort past the last key. A kept edge's destination is clipped into its
    rank's shard in all three orderings, as the plain ring and its
    transpose clip it. The data's tables (``ring_data``) and the in-call
    routes of ``parallel/ring_spmm.py`` and (m = 1) ``ops/spmm.py`` all
    come from here."""
    dev = src.device
    T, E = src.shape
    cap = E // m
    src, dst, rel, keep = src.long(), dst.long(), rel.long(), keep.bool()
    rank = torch.arange(E, device=dev) // cap
    block = torch.arange(T, device=dev)[:, None] * m + rank
    dst_l = (dst - rank * rows).clamp(0, rows - 1)
    dst_c = rank * rows + dst_l  # the clipped destination, in the space's ids
    slot = torch.arange(E, device=dev).expand(T, E)
    n_seg = m * rows

    def order(key, width, a, b):
        full = (block * (width + 1)
                + torch.where(keep, key, width)).reshape(-1)
        perm = torch.argsort(full, stable=True)
        counts = torch.bincount(full, minlength=T * m * (width + 1))
        ptr = torch.zeros(T * m, width + 1, dtype=torch.int64, device=dev)
        ptr[:, 1:] = torch.cumsum(
            counts.reshape(T * m, width + 1)[:, :width], 1)
        edge = torch.stack([a, b, slot], -1).reshape(-1, 3)[perm]
        return (ptr.reshape(T, m, width + 1).to(torch.int32),
                edge.reshape(T, m, cap, 3).to(torch.int32))

    return RingTables(rows,
                      *order(src // rows * rows + dst_l, n_seg, src, rel),
                      *order(src, n_seg, dst_c, rel),
                      *order(rel, n_rels, src, dst_c))


def ring_data(data, m: int, align: int = 128) -> RingData:
    """The tables (``ring_tables``) of the train snapshots of `data`
    (numpy, as the dataset is on the host), in the ring layout of m ranks
    (``ring_regroup_data``; m = 1: any layout, K1's tables), over the
    static mask ``data.train.emask`` and the weights' 2 * num_rels
    relations."""
    tr = data.train
    n_rels = 2 * data.num_rels
    A = np.asarray(data.act_idx).shape[1]

    def tables(src, dst, rows):
        t = ring_tables(*(torch.from_numpy(np.asarray(x)) for x in (
            src, dst, tr.rel, tr.emask)), m, rows, n_rels)
        return dataclasses.replace(t, **{
            f.name: getattr(t, f.name).numpy()
            for f in dataclasses.fields(t) if f.name != "rows"})

    return RingData(
        glob=tables(tr.src, tr.dst, ring_geometry(data.num_ents, m, align)),
        comp=tables(data.train_src_loc, data.train_dst_loc,
                    ring_geometry(A, m, align)))


def boundary_tables(data, m: int, align: int = 4):
    """The exchange tables of the "boundary" mode (the JAX package's
    ``boundary_tables``, on numpy, giving equal arrays): for every train
    snapshot t and ordered pair of ranks (owner j, consumer i), j != i,
    the sorted distinct entity rows that consumer i's edge slice reads from
    owner j's row shard, over the static mask: the graph's cut, the only
    rows that move between ranks. Needs the ring layout
    (``ring_regroup_data``). Returns (bnd_c [T, m, m, Cc] in compact slots,
    padded with A; bnd_g [T, m, m, Cg] in global ids, padded with
    num_ents), each capacity the longest list rounded up to `align`."""
    rows = ring_geometry(data.num_ents, m)
    A = np.asarray(data.act_idx).shape[1]
    a_cap = A // m
    T = data.num_times
    em = np.asarray(data.train.emask)
    E = em.shape[1]
    if E % m:
        raise ValueError("boundary_tables: apply ring_regroup_data first")
    e_cap = E // m

    def build(src_arr, owner_div, sentinel):
        src_arr = np.asarray(src_arr)
        lists = {}
        longest = 1
        for t in range(T):
            for i in range(m):
                sl = slice(i * e_cap, (i + 1) * e_cap)
                s = src_arr[t, sl][em[t, sl]]
                own = s // owner_div
                for j in np.unique(own):
                    if j == i:
                        continue
                    ids = np.unique(s[own == j])
                    lists[(t, int(j), i)] = ids
                    longest = max(longest, len(ids))
        C = max(align, -(-longest // align) * align)
        out = np.full((T, m, m, C), sentinel, np.int32)
        for (t, j, i), ids in lists.items():
            out[t, j, i, :len(ids)] = ids
        return out

    return (build(data.train_src_loc, a_cap, A),
            build(data.train.src, rows, data.num_ents))


@dataclass
class BoundaryData:
    """The data's tables of the "boundary" exchange over m ranks, in both
    id spaces (the final step's global ids, the window's compact slots):
    the exchange tables of ``boundary_tables`` (``bnd_g``, ``bnd_c``), and
    the static CSR tables that kernel K1 walks for each rank's edge slice
    (``glob``, ``comp``: ``RingTables`` of one rank over T * m blocks, the
    block of snapshot t and rank i at t * m + i, slots relative to the
    slice, rows = the space's size)."""

    glob: RingTables
    comp: RingTables
    bnd_g: Any  # [T, m, m, Cg] int32, padding num_ents
    bnd_c: Any  # [T, m, m, Cc] int32, padding A
    m: int = 1


def boundary_data(data, m: int) -> BoundaryData:
    """``BoundaryData`` of `data` (numpy, in the ring layout of m ranks):
    the exchange tables and K1's tables of every rank's slice of every
    train snapshot, sorted here once so that no call sorts its edges."""
    tr = data.train
    T, E = np.asarray(tr.src).shape
    cap = E // m
    n_rels = 2 * data.num_rels
    A = np.asarray(data.act_idx).shape[1]

    def slices(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x).reshape(T * m, cap)))

    def tables(src, dst, rows):
        t = ring_tables(*(slices(x) for x in (src, dst, tr.rel, tr.emask)),
                        1, rows, n_rels)
        return dataclasses.replace(t, **{
            f.name: getattr(t, f.name).numpy()
            for f in dataclasses.fields(t) if f.name != "rows"})

    bnd_c, bnd_g = boundary_tables(data, m)
    return BoundaryData(glob=tables(tr.src, tr.dst, data.num_ents),
                        comp=tables(data.train_src_loc, data.train_dst_loc,
                                    A),
                        bnd_g=bnd_g, bnd_c=bnd_c, m=m)


def check_ring_layout(data, m: int, align: int = 128) -> None:
    """Raise unless the train edges of `data` are in the ring layout of m
    ranks (``ring_regroup_data``): slice i of every edge row holds only
    kept edges whose destination shard i owns, by global id (the final
    step's graph, rows = ring_geometry(num_ents, m)) and by compact slot
    (the window's, rows = ring_geometry(A, m)). The ring SpMM clips a
    destination into its slice's shard, so data in another layout would
    give wrong sums rather than fail there."""
    dst = np.asarray(data.train.dst)
    keep = np.asarray(data.train.emask).astype(bool)
    dloc = np.asarray(data.train_dst_loc)
    E, A = dst.shape[1], np.asarray(data.act_idx).shape[1]
    ok = E % m == 0
    if ok:
        slot = np.arange(E) // (E // m)
        ok = bool(np.all(~keep | (dst // ring_geometry(data.num_ents, m,
                                                       align) == slot))
                  and np.all(~keep | (dloc // ring_geometry(A, m, align)
                                      == slot)))
    if not ok:
        raise ValueError(
            f"the ring and boundary edge partitions need the train edges "
            f"grouped by destination owner for {m} ranks; regroup the data "
            f"with ring_regroup_data (data.snapshots.ring_layout)")


def group_edges_by_dst_owner(src, dst, rel, emask, num_ents: int, m: int):
    """Reorder and pad one edge list so slice i of m equal slices holds
    exactly the edges whose dst row shard i (num_ents // m rows) owns;
    padding edges point at row i * rows with emask False."""
    src, dst, rel, emask = map(np.asarray, (src, dst, rel, emask))
    rows = num_ents // m
    owner = dst // rows
    buckets = [np.nonzero((owner == i) & emask)[0] for i in range(m)]
    cap = max(1, max(len(b) for b in buckets))
    out = {k: np.zeros(m * cap, np.int32) for k in ("src", "dst", "rel")}
    out["emask"] = np.zeros(m * cap, bool)
    for i, b in enumerate(buckets):
        s = i * cap
        out["src"][s:s + len(b)] = src[b]
        out["dst"][s:s + len(b)] = dst[b]
        out["rel"][s:s + len(b)] = rel[b]
        out["emask"][s:s + len(b)] = True
        out["dst"][s + len(b):s + cap] = i * rows
    return out["src"], out["dst"], out["rel"], out["emask"]


def rel_spmm_edge_partitioned(h, src, dst, rel, emask, weight, n_bases: int,
                              d_out: int, num_ents: int, mesh: Mesh,
                              kernels: bool = True):
    """The psum form of one partitioned SpMM (the JAX package's
    ``rel_spmm_edge_partitioned``): rank i aggregates chunk i of the edge
    list into a partial [N, d_out], and the partial degrees and sums are
    added over the ranks. h [N, d_in] on the controller."""
    from temp_tpu_torch.ops.segment import rel_spmm

    mp = mesh.shape["model"]
    with manual_partition("model", mp, "psum", mesh.devices[0]):
        return rel_spmm(h, src, dst, rel, emask, weight, n_bases, d_out,
                        num_ents, kernels=kernels)


def shard_generator(gen: torch.Generator, shard: int) -> torch.Generator:
    """The generator of data shard `shard`'s draws in a step whose
    generator is `gen` (freshly seeded, as ``Trainer.step_generator``
    makes it): seeded from (gen's seed, shard), on gen's device. The port's
    counterpart of the JAX package's ``fold_in(rng, axis_index("data"))``:
    each shard draws from a stream of its own."""
    seed = np.random.SeedSequence(
        [int(gen.initial_seed()), int(shard)]).generate_state(1)[0]
    return torch.Generator(device=gen.device).manual_seed(int(seed))


class EdgePartitionedModel:
    """A model (the ``loss``/``eval_ranks`` signature of
    ``models/registry.py``) whose SpMMs are partitioned over the model axis
    of `mesh` with exchange `mode`. The model's fused paths turn off inside
    (as in the JAX package), so its windows and final steps run step by
    step through ``rel_spmm``, which takes the config's hot dtype (under
    compute_dtype="bfloat16": K13's bfloat16 mode in "ring_pallas", the
    cut rows' rounding in "boundary", the block products' in the other
    modes). A data axis of dp > 1 splits the batch of B target times into
    dp shards of B / dp (B must divide), shard d partitioned over row d
    of the mesh: the loss is the sum of the shards' losses, each drawn
    from its own stream (``shard_generator``; `draws`, when given, one
    dict a shard), and the eval BCE the mean over the shards weighted by
    their elements with queries, as the JAX package's ``psum`` over the
    data axis gives them. Attributes pass through to the inner model."""

    def __init__(self, model, mesh: Mesh, axis: str = "model",
                 mode: str = "psum"):
        self.inner = model
        self.mesh = mesh
        self.axis = axis
        self.mode = mode
        self.mp = mesh.shape[axis]
        self.dp = mesh.shape["data"]

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _partition(self, shard: int = 0):
        """The partition context of data shard `shard` (the snapshots it
        runs name the data's partition tables,
        ``ops.segment.data_tables``)."""
        return manual_partition(self.axis, self.mp, self.mode,
                                self.mesh.devices[shard])

    def _shards(self, t_pos, t_valid):
        """(t_pos, t_valid) of each data shard, host arrays."""
        t_pos = np.asarray(t_pos)
        t_valid = np.asarray(t_valid, bool)
        if len(t_pos) % self.dp:
            raise ValueError(
                f"a batch of {len(t_pos)} target times does not split over "
                f"the data axis of {self.dp}")
        n = len(t_pos) // self.dp
        return [(t_pos[d * n:(d + 1) * n], t_valid[d * n:(d + 1) * n])
                for d in range(self.dp)]

    def loss(self, params, data, t_pos, t_valid, gen=None, draws=None):
        if self.dp == 1:
            with self._partition():
                return self.inner.loss(params, data, t_pos, t_valid, gen=gen,
                                       draws=draws)
        total = None
        for d, (tp, tv) in enumerate(self._shards(t_pos, t_valid)):
            with self._partition(d):
                part = self.inner.loss(
                    params, data, tp, tv,
                    gen=None if gen is None else shard_generator(gen, d),
                    draws=None if draws is None else draws[d])
            total = part if total is None else total + part
        return total

    def eval_ranks(self, params, data, t_pos, t_valid, split: str,
                   conv1_all=None):
        """The inner model's eval, shard by shard; `conv1_all` is not taken
        (the table is off under a partition, as in the JAX package)."""
        if self.dp == 1:
            with self._partition():
                return self.inner.eval_ranks(params, data, t_pos, t_valid,
                                             split)
        parts = []
        for d, (tp, tv) in enumerate(self._shards(t_pos, t_valid)):
            with self._partition(d):
                parts.append(self.inner.eval_ranks(params, data, tp, tv,
                                                   split))
        ranks = torch.cat([p[0] for p in parts])
        mask = torch.cat([p[1] for p in parts])
        n = torch.stack([p[1].any(1).sum() for p in parts]).to(
            parts[0][2].dtype)
        bce = (torch.stack([p[2] for p in parts]) * n).sum() / (
            n.sum().clamp(min=1.0))
        return ranks, mask, bce
