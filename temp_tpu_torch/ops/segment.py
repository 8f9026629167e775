"""Relational sparse message passing: the single graph primitive of the model.

Gather -> per-relation block-diagonal transform -> scatter-add by
destination, with the reference's double degree normalization. The
canonical configuration has n_bases == d (1x1 blocks: a per-relation
diagonal scale); there ``rel_spmm`` goes through kernel K1
(``ops/spmm.py``: K1f forward, K1b backward). Block-diagonal weights stay a
torch einsum, differentiated by autograd.

Inside ``parallel/mesh.py`` ``manual_partition`` every call is partitioned
over the ranks of the model axis instead, by the partition's mode (the JAX
package's dispatch): "psum" splits the edge list into chunks and adds the
ranks' partial degrees and sums; "ring" and "ring_pallas" need edges
grouped by destination owner (``parallel/edge_partition.py``
``ring_regroup_data``) and rotate row shards of h around the ranks, the
latter through kernel K13 (``parallel/ring_spmm.py``); "boundary" needs
that layout too, and each rank reads its own rows and only the cut rows
the others send it (``_rel_spmm_boundary``, kernel K1 a rank).

Outside a partition `method` picks the formulation, as the JAX
package's ``rel_spmm`` does (its names; "auto" takes the
``TEMP_TPU_SPMM_METHOD`` environment variable, read once at import, or
"segment", the JAX package's choice off a TPU). `dtype` (the hot dtype,
bfloat16) is taken by:

- "segment": none; the SpMM is K1 in float32, as the JAX package's row
  path ignores the dtype;
- "pallas": K1's bfloat16 mode (``ops/spmm.py``, the JAX package's Pallas
  kernel with ``dtype=bfloat16``); it needs diagonal weights;
- "onehot": another function in bfloat16, the JAX package's one-hot
  products of rounded rows (``_rel_spmm_onehot``): the gathered rows and
  the weights rounded, each message rounded, scaled by the rounded
  norm[dst] * em and rounded again, float32 sums, then * norm; with
  diagonal weights K1's "onehot" rounding mode (``ops/spmm.py``), with
  blocks the same roundings in torch ops. In float32 the three are K1 in
  float32 (the JAX package's Pallas and one-hot products run at
  ``HIGHEST``: the same function).

Inside a partition the method is inert, as in the JAX package, and the
dtype reaches K13's bfloat16 mode in "ring_pallas", the cut rows a rank
receives in "boundary" (rounded to it, as the JAX package's exchange
sends them), and the block products of ``rel_message`` in the other modes
and outside K13's envelope (diagonal weights take no rounding there).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from temp_tpu_torch.ops.gru import hot_round
from temp_tpu_torch.ops.spmm import (
    _Bf16Gather, _onehot_gather, flat_graph, spmm, spmm_fwd_plain,
)
from temp_tpu_torch.parallel.edge_partition import ring_geometry
from temp_tpu_torch.parallel.mesh import manual_axis, rank_devices
from temp_tpu_torch.parallel.ring_spmm import ring_spmm, ring_spmm_fwd_plain

# ``rel_spmm``'s methods (the JAX package's names)
METHODS = ("auto", "segment", "pallas", "onehot")
# the method "auto" takes where set (the JAX package's knob, of the same
# name and values)
_METHOD_OVERRIDE = os.environ.get("TEMP_TPU_SPMM_METHOD") or None


def segment_sum(data, segment_ids, num_segments: int):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def in_degree_norm(dst, emask, num_ents: int):
    """1/in-degree per entity over the masked edge set; 0 for isolated
    nodes."""
    deg = segment_sum(emask.to(torch.float32), dst, num_ents)
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg))


def rel_message(h_src, rel, weight, n_bases: int, d_in: int, d_out: int,
                dtype=None):
    """Per-edge block-diagonal relation transform. weight[r] holds n_bases
    blocks of shape (d_in/n_bases, d_out/n_bases). `dtype` rounds the
    block products' operands (and their cotangents) with float32 sums; it
    is inert for 1x1 blocks (the JAX package's ``rel_message``)."""
    si = d_in // n_bases
    so = d_out // n_bases
    w = weight[rel.long()]
    if si == 1 and so == 1:
        return h_src * w
    w = hot_round(w.reshape(-1, n_bases, si, so), dtype)
    hb = hot_round(h_src.reshape(-1, n_bases, si), dtype)
    return torch.einsum("ebi,ebio->ebo", hb, w).reshape(-1, n_bases * so)


def resolve_method(method: str, dtype, diagonal: bool) -> str:
    """The method a call outside a partition runs ("segment", "pallas" or
    "onehot"): "auto" resolved (``_METHOD_OVERRIDE``, else "segment"),
    checked against the call: "pallas" needs `diagonal` weights."""
    if method == "auto":
        method = _METHOD_OVERRIDE or "segment"
    if method not in METHODS[1:]:
        raise ValueError(f"rel_spmm: unknown method {method!r} (the "
                         f"methods: {', '.join(METHODS)})")
    if method == "pallas" and not diagonal:
        raise ValueError("rel_spmm: method 'pallas' needs diagonal relation "
                         "weights (n_bases == d_in == d_out)")
    return method


def rel_spmm(h, src, dst, rel, emask, weight, n_bases: int, d_out: int,
             num_ents: int, kernels: bool = True, t_pos=None,
             compact: bool = False, tables=None, dtype=None,
             method: str = "auto"):
    """RGCN neighbourhood aggregation with double degree normalization:

        msg_e = (h[src_e] . W[rel_e]) * norm[dst_e] * emask_e
        agg_v = (sum_{e: dst_e = v} msg_e) * norm[v]

    Returns [num_ents, d_out]; rows without in-edges are exactly 0. With
    diagonal weights this is kernel K1, differentiable in h and weight
    (``kernels=False`` runs its plain version on any device, differentiated
    by autograd). Edges [B, E] give B graphs side by side: h holds
    num_ents = B * n rows, graph b's ids index its own rows
    [b * n, (b + 1) * n). Inside ``manual_partition`` the call is
    partitioned by its mode (see the module's docstring). `tables`,
    `t_pos` and `compact` (``Snapshot``) name the train snapshots the
    graphs are: the data's static tables (``data_tables``), the graphs'
    time positions and the id space, so that K1 outside a partition and
    K13 ("ring_pallas") walk those tables rather than sort the edges.
    `dtype`: the hot dtype, taken by the partitioned modes and by the
    methods "pallas" and "onehot" (K1's bfloat16 modes); `method`: the
    formulation outside a partition (see the module's docstring). The
    models pass no `method` (``TEMP_TPU_SPMM_METHOD`` is the run's
    switch); the argument mirrors the JAX package's ``rel_spmm``
    signature, for its callers and tests. In float32 the methods are one
    function (K1 in float32).
    """
    d_in = h.shape[-1]
    named = _snapshot_tables(tables, t_pos, compact)
    part = manual_axis()
    if part is not None and part[1] > 1:
        _, m, mode = part
        B = src.shape[0] if src.dim() == 2 else 1
        h3 = h.reshape(B, num_ents // B, d_in)
        e2 = [x.reshape(B, -1) for x in (src, dst, rel, emask)]
        args = (h3, *e2, weight, n_bases, d_out, m,
                rank_devices(h.device))
        if mode in ("ring", "ring_pallas"):
            out = _rel_spmm_ring(*args, kernels=kernels,
                                 k13=mode == "ring_pallas", tables=named,
                                 dtype=dtype)
        elif mode == "psum":
            out = _rel_spmm_partitioned(*args, dtype=dtype)
        elif mode == "boundary":
            out = _rel_spmm_boundary(*args, kernels=kernels, tables=tables,
                                     t_pos=t_pos, compact=compact,
                                     dtype=dtype)
        else:
            raise ValueError(f"edge partition mode {mode!r}: not a mode")
        return out.reshape(num_ents, d_out)
    diagonal = n_bases == d_in == d_out
    method = resolve_method(method, dtype, diagonal)
    hot = dtype if method in ("pallas", "onehot") else None
    onehot = method == "onehot" and dtype is not None
    if diagonal and kernels:
        return spmm(h, src, dst, rel, emask, weight, tables=named, hot=hot,
                    onehot=onehot)
    if src.dim() == 2:
        src, dst = flat_graph(src, dst, num_ents // src.shape[0])
        rel, emask = rel.reshape(-1), emask.reshape(-1)
    if diagonal:
        return spmm_fwd_plain(h, src, dst, rel, emask, weight, hot, onehot)
    if onehot:
        return _rel_spmm_onehot_blocks(h, src, dst, rel, emask, weight,
                                       n_bases, d_out, num_ents)
    norm = in_degree_norm(dst, emask, num_ents)
    msg = rel_message(h[src.long()], rel, weight, n_bases, d_in, d_out)
    msg = msg * (norm[dst.long()] * emask.to(h.dtype))[:, None]
    return segment_sum(msg, dst, num_ents) * norm[:, None]


def data_tables(data):
    """The static tables of `data` (``RingData``) that the SpMMs of the
    running code walk: K13's (``TKGData.ring``) inside an edge partition,
    K1's (``TKGData.spmm``) outside one; None where the data has none."""
    part = manual_axis()
    return data.ring if part is not None and part[1] > 1 else data.spmm


def _snapshot_tables(tables, t_pos, compact: bool):
    """(the ``RingTables`` of the id space, t_pos [B]) for a call that
    names its snapshots in `tables` (``RingData``), else None."""
    if tables is None or t_pos is None:
        return None
    return (tables.comp if compact else tables.glob), t_pos.reshape(-1)


def _rel_spmm_ring(h, src, dst, rel, emask, weight, n_bases: int, d_out: int,
                   m: int, devices, kernels: bool = True, k13: bool = False,
                   tables=None, dtype=None):
    """The ring modes (the JAX package's ``_rel_spmm_ring``) for B graphs:
    h [B, n, d_in] on the controller, edges [B, E] grouped by destination
    owner (``ring_regroup_data``). Rank i owns rows [i * rows, (i + 1) *
    rows) of every graph, rows = ring_geometry(n, m), and edge slice i;
    the m row shards visit every rank once. `k13` ("ring_pallas") takes
    kernel K13 inside its envelope (d_in == d_out, blocks of s <= 8), as
    the JAX package takes its Pallas kernel; outside it, and in "ring"
    mode, K13's plain version runs the ring in torch ops (the JAX
    package's XLA form). ``Trainer`` checks the layout
    (``check_ring_layout``). `tables`: (the data's K13 tables of the
    edges' id space, their time positions [B]), which K13 walks in place
    of sorting the edges; None sorts them in the call. `dtype`: K13's
    bfloat16 mode inside its envelope, else ``rel_message``'s (the JAX
    package's XLA ring). Returns [B, n, d_out], the ranks' rows gathered
    on the controller."""
    n, d_in = h.shape[1:]
    rows = ring_geometry(n, m)
    h_pad = F.pad(h, (0, 0, 0, m * rows - n))
    s = d_in // n_bases if d_in % n_bases == 0 else 0
    if k13 and d_in == d_out and 1 <= s <= 8:
        return ring_spmm(h_pad, weight, src, dst, rel, emask, m, rows,
                         devices, kernels=kernels, tables=tables,
                         hot=dtype)[:, :n]
    return ring_spmm_fwd_plain(h_pad, weight, src, dst, rel, emask, m, rows,
                               devices, d_out=d_out, dtype=dtype)[0][:, :n]


def _rel_spmm_partitioned(h, src, dst, rel, emask, weight, n_bases: int,
                          d_out: int, m: int, devices, dtype=None):
    """The "psum" mode (the JAX package's ``_rel_spmm_partitioned``) for B
    graphs, h [B, n, d_in] on the controller, edges [B, E] in any order:
    rank i takes edge chunk i of ceil(E / m) slots; the ranks' partial
    in-degrees are added into the global norm, then their partial sums of
    messages (``rel_message`` in `dtype`). Returns [B, n, d_out]."""
    B, n, d_in = h.shape
    E = src.shape[1]
    chunk = -(-E // m)
    ranks, deg = [], None
    for r, dev in enumerate(devices):
        sl = slice(r * chunk, min(E, (r + 1) * chunk))
        seg = (torch.arange(B, device=dev)[:, None] * n
               + dst[:, sl].long().to(dev)).reshape(-1)
        em = emask[:, sl].to(dev).to(h.dtype).reshape(-1)
        part = segment_sum(em, seg, B * n).to(h.device)
        deg = part if deg is None else deg + part
        ranks.append((dev, sl, seg, em))
    norm = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg))
    agg = None
    for dev, sl, seg, em in ranks:
        hs = h.to(dev)[torch.arange(B, device=dev)[:, None],
                       src[:, sl].long().to(dev)].reshape(-1, d_in)
        msg = rel_message(hs, rel[:, sl].reshape(-1).to(dev), weight.to(dev),
                          n_bases, d_in, d_out, dtype)
        msg = msg * (norm.to(dev)[seg] * em)[:, None]
        part = segment_sum(msg, seg, B * n).to(h.device)
        agg = part if agg is None else agg + part
    return (agg * norm[:, None]).reshape(B, n, d_out)


def _rel_spmm_onehot_blocks(h, src, dst, rel, emask, weight, n_bases: int,
                            d_out: int, num_ents: int):
    """The method "onehot" in bfloat16 for block-diagonal weights (the
    JAX package's ``_rel_spmm_onehot`` with ``rel_message``'s einsum), on
    one graph's edges [E]: the gathered rows and the weights rounded, each
    block product summed in float32 and rounded, scaled by the rounded
    norm[dst] * em and rounded again, float32 sums, then * norm. Torch
    ops, with the JAX package's casts and its bfloat16 gather of the
    weights, so autograd is their transpose."""
    d_in = h.shape[-1]
    si, so = d_in // n_bases, d_out // n_bases
    norm = in_degree_norm(dst, emask, num_ents)
    hb = _onehot_gather(h, src).to(torch.float32)
    wb = _Bf16Gather.apply(weight, rel).to(torch.float32)
    msg = torch.einsum("ebi,ebio->ebo", hb.reshape(-1, n_bases, si),
                       wb.reshape(-1, n_bases, si, so)).reshape(
        -1, n_bases * so).to(torch.bfloat16)
    scale = (norm[dst.long()] * emask.to(torch.float32)).to(
        torch.bfloat16)[:, None]
    agg = segment_sum((msg * scale).to(torch.float32), dst, num_ents)
    return agg * norm[:, None]


def _rel_spmm_boundary(h, src, dst, rel, emask, weight, n_bases: int,
                       d_out: int, m: int, devices, kernels: bool = True,
                       tables=None, t_pos=None, compact: bool = False,
                       dtype=None):
    """The "boundary" mode (the JAX package's ``_rel_spmm_boundary``) for
    B graphs, h [B, n, d_in] on the controller, edges [B, E] grouped by
    destination owner (``ring_regroup_data``). Rank i owns rows [i * rows,
    (i + 1) * rows) of every graph (rows = ring_geometry(n, m)) and edge
    slice i: exactly the edges into its rows, so its degrees are exact
    and its output rows complete. It reads its own rows of h and the cut
    rows the other ranks send it, ``bnd[t, j, i]`` of the data's exchange
    tables (`tables`, ``BoundaryData``, at the graphs' time positions
    `t_pos`, in the compact or the global space): in bfloat16 (`dtype`)
    those arrive rounded, as the JAX package's exchange sends them
    (``send_rows.astype(dtype)``), and the cotangent of each returns
    rounded once for each (owner, consumer) pair, the transpose of its two
    casts; own rows are not rounded. Each rank's aggregation is K1 in
    float32 on its device over the data's K1 tables of its slice (no call
    sorts its edges); block-diagonal weights run ``rel_message`` in
    `dtype`. Returns [B, n, d_out], each rank's own rows assembled on the
    controller: the table every JAX device holds after its
    ``boundary_gather`` (``parallel/mesh.py``)."""
    if (tables is None or t_pos is None
            or getattr(tables, "bnd_g", None) is None):
        raise ValueError(
            "the boundary exchange needs the data's exchange tables "
            "(TKGData.ring, built by data.snapshots.ring_layout for "
            "edge_partition 'boundary') and calls that name their snapshots")
    B, n, d_in = h.shape
    E = src.shape[1]
    if E % m:
        raise ValueError(f"the boundary exchange needs edges grouped by "
                         f"destination owner (E = {E}, m = {m})")
    cap = E // m
    rows = ring_geometry(n, m)
    tab = tables.comp if compact else tables.glob
    tp = t_pos.reshape(-1).long()
    bnd = (tables.bnd_c if compact else tables.bnd_g)[tp]  # [B, m, m, C]
    diagonal = n_bases == d_in == d_out
    parts = []
    for i, dev in enumerate(devices):
        lo, hi = min(i * rows, n), min((i + 1) * rows, n)
        if lo == hi:
            continue  # a rank past the last row owns no row and no edge
        hx = h.to(dev).reshape(B * n, d_in)
        if dtype is not None:
            # the cut rows the owners send rank i, rounded; the padding id
            # n lands on a spare row that is dropped
            ids = bnd[:, :, i].to(dev).long().reshape(B, -1)
            flat = torch.where(ids < n, ids + torch.arange(
                B, device=dev)[:, None] * n, B * n).reshape(-1)
            hp = F.pad(hx, (0, 0, 0, 1))
            hx = hp.index_put((flat,), hot_round(hp[flat], dtype))[:B * n]
        s, t, r, em = (x[:, i * cap:(i + 1) * cap].to(dev)
                       for x in (src, dst, rel, emask))
        w = weight.to(dev)
        if diagonal and kernels:
            out = spmm(hx, s, t, r, em, w,
                       tables=(tab, (tp * m + i).to(dev)))
        else:
            s, t = flat_graph(s, t, n)
            r, em = r.reshape(-1), em.reshape(-1)
            if diagonal:
                out = spmm_fwd_plain(hx, s, t, r, em, w)
            else:
                norm = in_degree_norm(t, em, B * n)
                msg = rel_message(hx[s], r, w, n_bases, d_in, d_out, dtype)
                msg = msg * (norm[t] * em.to(hx.dtype))[:, None]
                out = segment_sum(msg, t, B * n) * norm[:, None]
        parts.append(out.reshape(B, n, d_out)[:, lo:hi].to(h.device))
    return torch.cat(parts, 1)
