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
latter through kernel K13 (``parallel/ring_spmm.py``).

Outside a partition `method` picks the formulation, as the JAX
package's ``rel_spmm`` does (its names; "auto" takes the
``TEMP_TPU_SPMM_METHOD`` environment variable, read once at import, or
"segment", the JAX package's choice off a TPU). `dtype` (the hot dtype,
bfloat16) is taken by:

- "segment": none; the SpMM is K1 in float32, as the JAX package's row
  path ignores the dtype;
- "pallas": K1's bfloat16 mode (``ops/spmm.py``, the JAX package's Pallas
  kernel with ``dtype=bfloat16``); it needs diagonal weights;
- "onehot": no port yet in bfloat16 (the JAX package rounds the gathered
  rows and the scaled messages there, another function): it raises. In
  float32 the three are K1 in float32 (the JAX package's Pallas and
  one-hot products run at ``HIGHEST``: the same function).

Inside a partition the method is inert, as in the JAX package, and the
dtype reaches K13's bfloat16 mode in "ring_pallas", the block products of
``rel_message`` in the other modes and outside K13's envelope (diagonal
weights take no rounding there).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from temp_tpu_torch.ops.gru import hot_round
from temp_tpu_torch.ops.spmm import flat_graph, spmm, spmm_fwd_plain
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
    checked against the call: "pallas" needs `diagonal` weights, "onehot"
    has no bfloat16 mode yet."""
    if method == "auto":
        method = _METHOD_OVERRIDE or "segment"
    if method not in METHODS[1:]:
        raise ValueError(f"rel_spmm: unknown method {method!r} (the "
                         f"methods: {', '.join(METHODS)})")
    if method == "pallas" and not diagonal:
        raise ValueError("rel_spmm: method 'pallas' needs diagonal relation "
                         "weights (n_bases == d_in == d_out)")
    if method == "onehot" and dtype is not None:
        raise NotImplementedError(
            f"rel_spmm: method 'onehot' in {dtype} (the JAX package's "
            f"one-hot products of rounded rows and messages) is not ported "
            f"yet; see ROADMAP.md")
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
    method "pallas" (K1's bfloat16 mode); `method`: the formulation
    outside a partition (see the module's docstring). The models pass no
    `method` (``TEMP_TPU_SPMM_METHOD`` is the run's switch); the argument
    mirrors the JAX package's ``rel_spmm`` signature, for its callers and
    tests. In float32 the methods are one function (K1 in float32).
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
        else:
            raise NotImplementedError(
                f"edge partition mode {mode!r} is not ported yet; see "
                f"ROADMAP.md")
        return out.reshape(num_ents, d_out)
    diagonal = n_bases == d_in == d_out
    hot = dtype if resolve_method(method, dtype, diagonal) == "pallas" \
        else None
    if diagonal and kernels:
        return spmm(h, src, dst, rel, emask, weight, tables=named, hot=hot)
    if src.dim() == 2:
        src, dst = flat_graph(src, dst, num_ents // src.shape[0])
        rel, emask = rel.reshape(-1), emask.reshape(-1)
    if diagonal:
        return spmm_fwd_plain(h, src, dst, rel, emask, weight, hot)
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
