"""Ring-exchanged relational SpMM: kernel K13, forward and backward.

The counterpart of the JAX package's ``parallel/ring_pallas.py``
(``_ring_kernel`` and its backward ``_ring_spmm_bwd``, reached through
``_rel_spmm_ring`` in ``edge_partition="ring_pallas"`` mode). The entity
states are cut into m row shards of `rows` rows; rank i owns shard i and
exactly the edges whose destination row it owns (``ring_regroup_data``),
so its degrees are local. In m steps every shard visits every rank once:
at step k rank i holds shard (i + k) % m and aggregates the messages of
its edges whose source lies there into its own rows; between steps each
shard is copied to its left neighbour's next slot (slots are never
reused). For one graph, with norm = 1 / deg,

    out[v] = norm[v]^2 * sum_{e : dst_e = v} h[src_e] . W[rel_e]

where W[r] is diagonal (s = 1) or block-diagonal with s x s blocks (s <= 8;
the weights [R, n_bases * s * s] unpacked, as ``rel_message`` takes them).
Every function takes B graphs at once: h [B, m * rows, d] and edges
[B, E], E = m * cap; rank i owns the same row range and edge slice in each.

On CUDA tensors ``ring_spmm_fwd`` launches the kernels in
``csrc/ring_spmm.cu``: one launch a ring step for all the ranks of a card
(m a call on one card), each rank walking static CSR tables of its edges
(``RingTables``) for the snapshots the call names by time position, and
reading the call's mask per edge. The data's tables are sorted once, with
the data (``data.snapshots.ring_layout``); a call without them sorts its
own edges into the same tables, one device sort an ordering for all ranks
(counted on ``ring_spmm_fwd.csr_builds``). ``ring_spmm_bwd`` is the
backward as kernels over the same tables: dh carried back round the ring
to the sources' owners (the reduce-scatter), dw per-rank partials by
relation summed in rank order. Ranks on the controller's card write
straight into its outputs; ranks on other cards run on a stream of their
card, and shards and rows move between cards by copies that PyTorch orders
between the cards' streams.

On CPU tensors the wrappers run the plain versions: ``ring_spmm_fwd_plain``,
the same ring in torch ops (also the "ring" mode's SpMM, any block shape),
and ``ring_spmm_bwd_plain``, the JAX package's transpose in torch ops.
``RingSpMM`` is K13 differentiated in h and w.

``hot=torch.bfloat16`` is the JAX kernel's bfloat16 instantiation
(``_ring_kernel`` with dtype_str "bfloat16"): each gathered source row and
relation weight rounded to bfloat16, the message formed in float32 and
rounded before the float32 sum, the degrees exact; its backward, the JAX
package's transpose on those rounded residuals (dh from the rounded
weights for s = 1, the unrounded ones for s > 1; dw from the rounded
rows), the cotangents unrounded. On the card (``csrc/ring_spmm_bf16.cu``),
when every rank sits on the controller's card (one H100: the whole-card
route, ``_ring_fwd_card`` and ``_ring_bwd_card``), one launch a forward
call and one a backward call read every shard in place from the
controller's float32 h, rounding in registers, with no rotation copy; the
sums run in the stepped route's order, so at s = 1 the outputs are its
bits. Ranks on more than one card take the stepped route
(``_ring_fwd_steps``, ``_ring_bwd_steps``): the float32 kernels compiled in
that mode, the shards rounded once before the ring's copies, which then
carry bfloat16. `dtype` of the plain version is
the other bfloat16 semantics, the JAX package's XLA ring (``rel_message``
with a dtype): block-diagonal products of rounded operands, diagonal ones
untouched.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch

from temp_tpu_torch import _build
from temp_tpu_torch.ops.gru import hot_round
from temp_tpu_torch.parallel.edge_partition import (
    RingTables, ring_tables,
)

_MAX_D = 256  # the kernels keep d / 32 <= 8 columns per lane in registers
_MAX_S = 8    # block width of block-diagonal relation weights


def _blocks(d_in: int, d_out: int, w):
    """(n_bases, si, so) of relation weights [R, n_bases * si * so] that
    take d_in columns to d_out."""
    wide = w.shape[1]
    nb = d_in * d_out // wide if wide else 0
    if nb < 1 or nb * wide != d_in * d_out or d_in % nb or d_out % nb:
        raise ValueError(f"ring_spmm: weight {tuple(w.shape)} is not "
                         f"[R, n_bases * si * so] for d_in = {d_in}, "
                         f"d_out = {d_out}")
    return nb, d_in // nb, d_out // nb


def _transform(hs, wr, si: int, so: int, dtype=None):
    """Per-edge relation transform: h rows [n, nb * si] by their weights
    [n, nb * si * so]; with `dtype` the block products' operands rounded
    to it and their cotangents too (the JAX package's ``rel_message``:
    diagonal weights take no rounding)."""
    if si == so == 1:
        return hs * wr
    nb = hs.shape[1] // si
    hs, wr = hot_round(hs, dtype), hot_round(wr, dtype)
    return torch.einsum("ebi,ebio->ebo", hs.reshape(-1, nb, si),
                        wr.reshape(-1, nb, si, so)).reshape(-1, nb * so)


class _HotMessage(torch.autograd.Function):
    """K13's bfloat16 message: (rounded h rows by rounded weights, formed
    in float32) rounded; the backward is the JAX package's transpose on
    the rounded residuals, the cotangent unrounded (``_ring_spmm_bwd``:
    dh from the rounded weights for s = 1 and the unrounded ones for
    s > 1, dw from the rounded rows)."""

    @staticmethod
    def forward(ctx, hs, we, si, so, hot):
        hr, wr = hot_round(hs, hot), hot_round(we, hot)
        ctx.save_for_backward(hr, wr if si == so == 1 else we)
        ctx.blocks = (si, so)
        return hot_round(_transform(hr, wr, si, so), hot)

    @staticmethod
    def backward(ctx, g):
        hr, wt = ctx.saved_tensors
        dh, dw = _transform_bwd(hr, g, wt, *ctx.blocks)
        return dh, dw, None, None, None


def _message(hs, we, si: int, so: int, hot=None, dtype=None):
    """The edges' messages: K13's bfloat16 ones for `hot`, else
    ``_transform`` (in `dtype`)."""
    if hot is None:
        return _transform(hs, we, si, so, dtype)
    return _HotMessage.apply(hs, we, si, so, hot)


def _rank_edges(src, dst, rel, emask, r: int, m: int, rows: int, dev):
    """Rank r's edge slice on its device: (src, local dst, rel, keep), each
    [B, cap]; padding dsts are clipped into the shard."""
    cap = src.shape[1] // m
    sl = slice(r * cap, (r + 1) * cap)
    dstl = (dst[:, sl].long() - r * rows).clamp(0, rows - 1)
    return (src[:, sl].to(dev).long(), dstl.to(dev), rel[:, sl].to(dev).long(),
            emask[:, sl].to(dev).bool())


def _check(h, w, src, dst, rel, emask, m: int, rows: int, devices,
           d_out: int):
    if h.dim() != 3 or h.shape[1] != m * rows:
        raise ValueError(f"ring_spmm: h {tuple(h.shape)} must be "
                         f"[B, {m} * {rows}, d]")
    B, E = src.shape
    if (h.shape[0] != B or E % m or dst.shape != src.shape
            or rel.shape != src.shape or emask.shape != src.shape):
        raise ValueError(f"ring_spmm: edges {tuple(src.shape)} must be "
                         f"[B, m * cap] for h {tuple(h.shape)}, m = {m}")
    if len(devices) != m:
        raise ValueError(f"ring_spmm: {len(devices)} devices for {m} ranks")
    if any(torch.device(d).type != h.device.type for d in devices):
        raise ValueError(f"ring_spmm: ranks on {devices}, h on {h.device}")
    return _blocks(h.shape[-1], d_out, w)


def ring_spmm_fwd_plain(h, w, src, dst, rel, emask, m: int, rows: int,
                        devices, d_out: int | None = None, hot=None,
                        dtype=None):
    """Plain PyTorch version of K13, and the "ring" mode's SpMM: the same
    ring, each rank's step a gather, transform and ``index_add`` of the
    edges whose source lies in the visiting shard, the shards' copies
    tensor copies. Any block shape (weights [R, n_bases * si * so], d_out
    columns out, by default h's width); differentiable by autograd in h and
    w. `hot`: K13's bfloat16 mode (``_HotMessage``); `dtype`: the "ring"
    mode's (``_transform``). Returns (out [B, m * rows, d_out], norm^2
    [B, m * rows]) on h's device."""
    B, _, d_in = h.shape
    d_out = d_in if d_out is None else d_out
    _, si, so = _check(h, w, src, dst, rel, emask, m, rows, devices, d_out)
    ranks = []
    for r, dev in enumerate(devices):
        s_l, d_l, r_l, keep = _rank_edges(src, dst, rel, emask, r, m, rows,
                                          dev)
        seg = (torch.arange(B, device=dev)[:, None] * rows + d_l)
        deg = torch.zeros(B * rows, device=dev).index_add_(
            0, seg.reshape(-1), keep.reshape(-1).to(torch.float32))
        norm = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                           torch.zeros_like(deg))
        ranks.append(dict(src=s_l, seg=seg.reshape(-1), keep=keep,
                          b=torch.arange(B, device=dev)[:, None],
                          n2=norm * norm, w_e=w.to(dev)[r_l.reshape(-1)],
                          raw=torch.zeros(B * rows, d_out, device=dev)))
    visit = [h[:, r * rows:(r + 1) * rows].to(dev)
             for r, dev in enumerate(devices)]
    for k in range(m):
        for r, rk in enumerate(ranks):
            # every edge slot gathers from the visiting shard; the messages
            # of those whose source lies elsewhere (or that are masked)
            # are scaled to 0, so no step waits on the host for a count
            owner = (r + k) % m
            sel = rk["keep"] & (rk["src"] // rows == owner)
            local = torch.where(sel, rk["src"] - owner * rows, 0)
            hs = visit[r][rk["b"], local].reshape(-1, d_in)
            msg = _message(hs, rk["w_e"], si, so, hot, dtype) * sel.reshape(
                -1, 1)
            rk["raw"] = rk["raw"].index_add(0, rk["seg"], msg)
        if k < m - 1:  # rank r receives its right neighbour's shard
            visit = [visit[(r + 1) % m].to(dev)
                     for r, dev in enumerate(devices)]
    out = torch.cat([(rk["raw"] * rk["n2"][:, None]).reshape(B, rows, d_out)
                     .to(h.device) for rk in ranks], dim=1)
    n2 = torch.cat([rk["n2"].reshape(B, rows).to(h.device) for rk in ranks],
                   dim=1)
    return out, n2


def _transform_bwd(hs, dmsg, we, si: int, so: int):
    """The cotangents of ``_transform`` at each edge: (dh rows
    [n, nb * si], dw rows [n, nb * si * so]) from the messages' cotangents
    dmsg [n, nb * so]."""
    if si == so == 1:
        return dmsg * we, dmsg * hs
    nb = hs.shape[1] // si
    w4 = we.reshape(-1, nb, si, so)
    dm = dmsg.reshape(-1, nb, so)
    dh = torch.einsum("ebio,ebo->ebi", w4, dm).reshape(-1, nb * si)
    dw = torch.einsum("ebi,ebo->ebio", hs.reshape(-1, nb, si),
                      dm).reshape(-1, nb * si * so)
    return dh, dw


def ring_spmm_bwd_plain(g, n2, h, w, src, dst, rel, emask, m: int, rows: int,
                        devices, hot=None):
    """Plain PyTorch version of K13's backward: the JAX package's
    ``_ring_spmm_bwd`` in torch ops, without a replay of the forward. g
    [B, m * rows, d_out] is the cotangent of the forward's output, n2
    [B, m * rows] its norm^2. Each rank, on its device, forms dmsg =
    g * n2 at its destinations times the mask, its dw partial by relation
    and its edges' dh contributions at their source rows (h[src] gathered
    again); the ranks' dh rows and dw partials are added on h's device in
    rank order (the reduce-scatter, and the sum of the replicated weight's
    cotangents). `hot`: the bfloat16 mode's residuals (``_HotMessage``).
    Returns (dh [B, m * rows, d_in], dw like w)."""
    B, M, d_in = h.shape
    d_out = g.shape[-1]
    _, si, so = _check(h, w, src, dst, rel, emask, m, rows, devices, d_out)
    dh, dw = torch.zeros_like(h), torch.zeros_like(w)
    for r, dev in enumerate(devices):
        s_l, d_l, r_l, keep = _rank_edges(src, dst, rel, emask, r, m, rows,
                                          dev)
        b = torch.arange(B, device=dev)[:, None]
        sl = slice(r * rows, (r + 1) * rows)
        gn2 = (g[:, sl] * n2[:, sl, None]).to(dev)
        dmsg = (gn2[b, d_l] * keep[..., None]).reshape(-1, d_out)
        hs = hot_round(h.to(dev)[b, s_l].reshape(-1, d_in), hot)
        we = w.to(dev)[r_l.reshape(-1)]
        if si == so == 1:
            we = hot_round(we, hot)
        dh_e, dw_e = _transform_bwd(hs, dmsg, we, si, so)
        contrib = torch.zeros(B * M, d_in, device=dev).index_add_(
            0, (b * M + s_l).reshape(-1), dh_e)
        part = torch.zeros(w.shape, device=dev).index_add_(
            0, r_l.reshape(-1), dw_e)
        dh = dh + contrib.reshape(B, M, d_in).to(h.device)
        dw = dw + part.to(w.device)
    return dh, dw


# -- the cards of a ring ------------------------------------------------------

class _Card(NamedTuple):
    """The ranks (in rank order) that one card runs. Outputs on a card are
    [B, n_out, rows, ...] with rank j's rows at block out_ids[j]: on the
    controller's card the controller's own outputs (n_out = m, the global
    rank), elsewhere the card's (n_out = nc). ``recv[name]`` lists, for
    the forward's ("fwd") and the backward's ("bwd") rotation, the groups
    (sender card, slots here, slots there) of what its ranks receive."""

    dev: torch.device
    ranks: tuple
    ranks_ctrl: torch.Tensor  # int64 [nc], on the controller's card
    rank_ids: torch.Tensor    # int32 [nc]
    out_ids: torch.Tensor     # int32 [nc]
    n_out: int
    stream: Optional[torch.cuda.Stream]  # None on the controller's card
    recv: dict


_PLANS: dict = {}


def _cards(devices, ctrl: torch.device) -> tuple:
    """The cards of `devices` (rank r on devices[r]), the controller's
    first; made once per device set and controller, each card other than
    the controller's with its own stream."""
    devices = tuple(_indexed(d) for d in devices)
    key = (devices, ctrl)
    if key in _PLANS:
        return _PLANS[key]
    m = len(devices)
    order = sorted(dict.fromkeys(devices), key=lambda c: c != ctrl)
    ranks = [tuple(r for r in range(m) if devices[r] == c) for c in order]
    where = {r: (ci, j) for ci, rs in enumerate(ranks)
             for j, r in enumerate(rs)}
    cards = []
    for c, rs in zip(order, ranks):
        local = c == ctrl
        recv = {}
        for name, step in (("fwd", 1), ("bwd", -1)):
            groups: dict = {}
            for j, r in enumerate(rs):
                cj, jj = where[(r + step) % m]
                groups.setdefault(cj, ([], []))
                groups[cj][0].append(j)
                groups[cj][1].append(jj)
            recv[name] = tuple(
                (cj, torch.tensor(js, device=c),
                 torch.tensor(jjs, device=order[cj]))
                for cj, (js, jjs) in groups.items())
        cards.append(_Card(
            dev=c, ranks=rs, ranks_ctrl=torch.tensor(rs, device=ctrl),
            rank_ids=torch.tensor(rs, dtype=torch.int32, device=c),
            out_ids=torch.tensor(rs if local else range(len(rs)),
                                 dtype=torch.int32, device=c),
            n_out=m if local else len(rs),
            stream=None if local else torch.cuda.Stream(device=c),
            recv=recv))
    _PLANS[key] = tuple(cards)
    return _PLANS[key]


def _indexed(dev) -> torch.device:
    """A CUDA device with its index ("cuda" is the current card)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


_COPIES: dict = {}  # (id of a static tensor, card) -> its copy there


def _on(t, dev):
    """Static `t` on card `dev`: itself, or a copy kept while `t` lives
    (the data's tables reach each card once)."""
    if t.device == dev:
        return t
    key = (id(t), dev)
    if key not in _COPIES:
        _COPIES[key] = t.to(dev)
        weakref.finalize(t, _COPIES.pop, key, None)
    return _COPIES[key]


class _Streams:
    """Each card's stream current on its card while a ring call runs:
    tensor ops and copies on a card run on its stream, and PyTorch orders
    a copy between cards after the work of both cards' streams. The
    streams start after the controller's work so far; the controller
    waits for them at the end."""

    def __init__(self, cards, ctrl_stream):
        self.streams = [c.stream for c in cards if c.stream is not None]
        self.ctrl = ctrl_stream
        self.ctx = [torch.cuda.stream(s) for s in self.streams]

    def __enter__(self):
        for s, c in zip(self.streams, self.ctx):
            s.wait_stream(self.ctrl)
            c.__enter__()
        return self

    def __exit__(self, *exc):
        for c in reversed(self.ctx):
            c.__exit__(*exc)
        for s in self.streams:
            self.ctrl.wait_stream(s)
        return False


def _launch(fn, name: str, dev, stream, *args) -> None:
    """One launcher call on `stream` of card `dev`; tensors go as their
    data pointers, None as a null pointer. `dev` is made the current card
    for the call unless it is already."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            err = fn(*args, stream.cuda_stream)
    else:
        err = fn(*args, stream.cuda_stream)
    _build.check(err, name)


def _rotate(cards, cur: list, name: str) -> list:
    """Each card's next slots [B, nc, rows, d]: every rank's slot gets
    what its neighbour held (``_Card.recv``), one copy a sending card."""
    out = []
    for ci, (card, here) in enumerate(zip(cards, cur)):
        groups = card.recv[name]
        if len(groups) == 1 and groups[0][0] == ci:
            out.append(here.index_select(1, groups[0][2]))
            continue
        nxt = torch.empty_like(here)
        for cj, js, jjs in groups:
            nxt.index_copy_(1, js, cur[cj].index_select(1, jjs).to(card.dev))
        out.append(nxt)
    return out


def _card_table(card: _Card, ptr, edge, t_pos, emask) -> tuple:
    """What a card's launches read of a table: (ptr, edge, t_pos, its
    stride, the tables' T, mask, its row stride), on the card."""
    dev = card.dev
    pos = t_pos if t_pos.device == dev else t_pos.to(dev)
    mask = emask if emask.device == dev else emask.to(dev)
    return (_on(ptr, dev), _on(edge, dev), pos, pos.stride(0), ptr.shape[0],
            mask, mask.stride(0))


def _kernel_args(h, w, emask, devices, s: int, name: str, hot=None):
    """Refuse what the kernels do not take (float32 h and weight in either
    mode, as the JAX package's caller passes them); the mask as bytes with
    rows of unit stride."""
    if h.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"{name}: kernel takes float32 h and weight, got "
                        f"{h.dtype} and {w.dtype}")
    if hot not in (None, torch.bfloat16):
        raise TypeError(f"{name}: no kernel mode for {hot}")
    if h.shape[-1] > _MAX_D:
        raise ValueError(f"{name}: d = {h.shape[-1]} > {_MAX_D}")
    if s > _MAX_S:
        raise ValueError(f"{name}: blocks of {s} > {_MAX_S}")
    if any(torch.device(d).type != "cuda" for d in devices):
        raise ValueError(f"{name}: ranks on {devices}, h on {h.device}")
    emask = emask.bool()
    return emask if emask.stride(-1) == 1 else emask.contiguous()


def _call_tables(h, w, src, dst, rel, emask, m: int, rows: int, tables):
    """(tables, t_pos [B] int64) of a call: the given ones, checked
    against the call, or the call's own edges sorted here (counted on
    ``ring_spmm_fwd.csr_builds``)."""
    B, E = src.shape
    n_rels = w.shape[0]
    if tables is None:
        ring_spmm_fwd.csr_builds += 1
        return (ring_tables(src, dst, rel, emask, m, rows, n_rels),
                torch.arange(B, device=h.device))
    tab, t_pos = tables
    t_pos = t_pos.long()
    shape = (tuple(tab.fwd_ptr.shape[1:]) + tuple(tab.fwd_edge.shape[2:])
             + (tab.rel_ptr.shape[2],))
    if tab.rows != rows or shape != (m, m * rows + 1, E // m, 3, n_rels + 1):
        raise ValueError(
            f"ring_spmm: tables of rows = {tab.rows}, "
            f"{tuple(tab.fwd_ptr.shape)}, {tuple(tab.fwd_edge.shape)}, "
            f"{tuple(tab.rel_ptr.shape)} for a call of m = {m}, rows = "
            f"{rows}, E = {E}, {n_rels} relations")
    if t_pos.shape != (B,) or tab.fwd_ptr.device != h.device or (
            t_pos.device != h.device):
        raise ValueError(f"ring_spmm: t_pos {tuple(t_pos.shape)} on "
                         f"{t_pos.device}, tables on {tab.fwd_ptr.device} "
                         f"for {B} graphs on {h.device}")
    return tab, t_pos


def _launcher(name: str, hot):
    """The float32 launcher `name`, or its bfloat16 mode's."""
    lib = _build.lib()
    return getattr(lib, name if hot is None else f"{name}_bf16")


def _whole(cards) -> bool:
    """Every rank of the ring on the controller's card."""
    return len(cards) == 1 and cards[0].stream is None


class _CardPlan(NamedTuple):
    """The static arguments of the whole-card route's launches for one
    tables: the data pointers of the forward's table (ptr, edge), of the
    backward's (by source row, then by relation), and the tables' T."""

    fwd: tuple
    bwd: tuple
    n_times: int


_CARD_PLANS: dict = {}  # id of a RingTables -> its _CardPlan, while it lives


def _card_plan(tab: RingTables) -> _CardPlan:
    key = id(tab)
    plan = _CARD_PLANS.get(key)
    if plan is None:
        plan = _CardPlan(
            fwd=(tab.fwd_ptr.data_ptr(), tab.fwd_edge.data_ptr()),
            bwd=tuple(t.data_ptr() for t in (tab.src_ptr, tab.src_edge,
                                             tab.rel_ptr, tab.rel_edge)),
            n_times=tab.fwd_ptr.shape[0])
        _CARD_PLANS[key] = plan
        weakref.finalize(tab, _CARD_PLANS.pop, key, None)
    return plan


def _vec(d: int, s: int, *tensors) -> int:
    """The whole-card kernels' lane layout: 4 columns a lane (one 16-byte
    load) where s = 1, d % 4 == 0 and every row is 16-byte aligned, else
    1."""
    ok = s == 1 and d % 4 == 0 and all(t.data_ptr() % 16 == 0
                                       for t in tensors)
    return 4 if ok else 1


def _ring_fwd_card(h, w, emask, m: int, rows: int, s: int, tab: RingTables,
                   t_pos):
    """K13 bf16 on the whole card: one launch over every rank's shard where
    it lies in the controller's h (``ring_bf16_fwd_launch``,
    csrc/ring_spmm_bf16.cu), no rotation and no bfloat16 copy of h."""
    B, M, d = h.shape
    plan = _card_plan(tab)
    h, w = h.contiguous(), w.contiguous()
    out = torch.empty(B, M, d, device=h.device)
    n2 = torch.empty(B, M, device=h.device)
    _launch(_build.lib().ring_bf16_fwd_launch, "ring_spmm_fwd", h.device,
            torch.cuda.current_stream(h.device), *plan.fwd, t_pos,
            t_pos.stride(0), plan.n_times, emask, emask.stride(0), h, w, out,
            n2, B, m, rows, emask.shape[1] // m, d, s, _vec(d, s, h, w, out))
    ring_spmm_fwd.launches += 1
    return out, n2


def _ring_fwd_cuda(h, w, emask, m: int, rows: int, devices, s: int,
                   tab: RingTables, t_pos, hot=None):
    """K13's kernels: the bfloat16 mode with every rank on the controller's
    card takes the whole-card route (``_ring_fwd_card``), any other the
    stepped route (``_ring_fwd_steps``)."""
    if hot is not None and _whole(_cards(devices, h.device)):
        return _ring_fwd_card(h, w, emask, m, rows, s, tab, t_pos)
    return _ring_fwd_steps(h, w, emask, m, rows, devices, s, tab, t_pos, hot)


def _ring_fwd_steps(h, w, emask, m: int, rows: int, devices, s: int,
                    tab: RingTables, t_pos, hot=None):
    """K13's stepped route: one launch a ring step for all ranks of a card
    (``ring_fwd_step_launch``, or its bfloat16 mode's), the shards copied
    to their left neighbours' next slots between the steps."""
    B, M, d = h.shape
    cap = emask.shape[1] // m
    fn = _launcher("ring_fwd_step_launch", hot)
    ctrl = torch.cuda.current_stream(h.device)
    cards = _cards(devices, h.device)
    w = w.contiguous()
    # the bfloat16 mode's shards rounded once, before the ring's copies
    h4 = h.to(hot or h.dtype).contiguous().view(B, m, rows, d)
    out = torch.empty(B, M, d, device=h.device)
    n2 = torch.empty(B, M, device=h.device)
    whole = _whole(cards)
    with _Streams(cards, ctrl):
        runs, slots = [], []
        for c in cards:
            nc = len(c.ranks)
            # step 0's slots: the card's ranks' own shards
            slots.append(h4 if whole else
                         h4.index_select(1, c.ranks_ctrl).to(c.dev))
            o, n = out, n2
            if c.stream is not None:
                o = torch.empty(B, nc, rows, d, device=c.dev)
                n = torch.empty(B, nc, rows, device=c.dev)
            runs.append((_card_table(c, tab.fwd_ptr, tab.fwd_edge, t_pos,
                                     emask), w.to(c.dev), o, n,
                         ctrl if c.stream is None else c.stream))
        for k in range(m):
            if k > 0:  # every shard to its left neighbour's next slot
                slots = _rotate(cards, slots, "fwd")
            for c, (tbl, w_c, o, n, st), slot in zip(cards, runs, slots):
                _launch(fn, "ring_spmm_fwd", c.dev, st, *tbl, c.rank_ids,
                        c.out_ids, slot, w_c, o, n, B, len(c.ranks), c.n_out,
                        m, rows, cap, d, s, k, int(k == 0), int(k == m - 1))
                ring_spmm_fwd.launches += 1
        for c, (_, _, o, n, _) in zip(cards, runs):
            if c.stream is not None:  # the rows of another card's ranks
                out.view(B, m, rows, d).index_copy_(1, c.ranks_ctrl,
                                                    o.to(h.device))
                n2.view(B, m, rows).index_copy_(1, c.ranks_ctrl,
                                                n.to(h.device))
    return out, n2


def _ring_bwd_card(g, n2, h, w, emask, m: int, rows: int, s: int,
                   tab: RingTables, t_pos):
    """K13b bf16 on the whole card: one launch, dw warps and dh warps, over
    every rank's tables where they lie (``ring_bf16_bwd_launch``,
    csrc/ring_spmm_bf16.cu), no accumulator rotation and no bfloat16 copy
    of h."""
    B, M, d = h.shape
    plan = _card_plan(tab)
    g, n2, h, w = (x.contiguous() for x in (g, n2, h, w))
    dh = torch.empty_like(h)
    dw = torch.empty_like(w)
    _launch(_build.lib().ring_bf16_bwd_launch, "ring_spmm_bwd", h.device,
            torch.cuda.current_stream(h.device), *plan.bwd, t_pos,
            t_pos.stride(0), plan.n_times, emask, emask.stride(0), g, n2, h,
            w, dh, dw, B, m, rows, emask.shape[1] // m, w.shape[0], d, s,
            _vec(d, s, g, h, w, dh, dw))
    ring_spmm_bwd.launches += 1
    return dh, dw


def _ring_bwd_cuda(g, n2, h, w, emask, m: int, rows: int, devices, s: int,
                   tab: RingTables, t_pos, hot=None):
    """K13b's kernels, routed as ``_ring_fwd_cuda``."""
    if hot is not None and _whole(_cards(devices, h.device)):
        return _ring_bwd_card(g, n2, h, w, emask, m, rows, s, tab, t_pos)
    return _ring_bwd_steps(g, n2, h, w, emask, m, rows, devices, s, tab,
                           t_pos, hot)


def _ring_bwd_steps(g, n2, h, w, emask, m: int, rows: int, devices, s: int,
                    tab: RingTables, t_pos, hot=None):
    """K13b's stepped route: m step launches with the accumulators passed
    round the ring between them, the dw partials by rank and their sum."""
    B, M, d = h.shape
    R, W = w.shape
    cap = emask.shape[1] // m
    lib = _build.lib()
    step_fn = _launcher("ring_bwd_step_launch", hot)
    dw_fn = _launcher("ring_dw_launch", hot)
    ctrl = torch.cuda.current_stream(h.device)
    cards = _cards(devices, h.device)
    g, n2, h, w = (x.contiguous() for x in (g, n2, h, w))
    hk = h.to(hot or h.dtype)  # dw's rows, as the kernel reads them
    dh = torch.empty_like(h)
    part = torch.empty(m, R, W, device=h.device)  # dw of each rank
    dw = torch.empty_like(w)
    with _Streams(cards, ctrl):
        runs = []
        for c in cards:
            nc = len(c.ranks)
            far = c.stream is not None
            runs.append(dict(
                by_src=_card_table(c, tab.src_ptr, tab.src_edge, t_pos,
                                   emask),
                by_rel=_card_table(c, tab.rel_ptr, tab.rel_edge, t_pos,
                                   emask),
                g=g.to(c.dev), n2=n2.to(c.dev), h=hk.to(c.dev),
                w=w.to(c.dev),
                stream=ctrl if c.stream is None else c.stream,
                dh=torch.empty(B, nc, rows, d, device=c.dev) if far else dh,
                part=torch.empty(nc, R, W, device=c.dev) if far else part))
        # dh: each shard's accumulator visits every rank once and ends at
        # its owner; received from the left neighbour before each step
        acc = [None] * len(cards)
        for k in range(m):
            last = k == m - 1
            if k > 0:
                acc = _rotate(cards, acc, "bwd")
            nxt = []
            for c, run, a in zip(cards, runs, acc):
                nc = len(c.ranks)
                o, ids, n_out = run["dh"], c.out_ids, c.n_out
                if not last:
                    o = torch.empty(B, nc, rows, d, device=c.dev)
                    ids, n_out = None, nc
                _launch(step_fn, "ring_spmm_bwd", c.dev,
                        run["stream"], *run["by_src"], c.rank_ids, ids,
                        run["g"], run["n2"], run["w"], a, o, B, nc, n_out, m,
                        rows, cap, d, s, k)
                ring_spmm_bwd.launches += 1
                nxt.append(o)
            acc = nxt
        for c, run in zip(cards, runs):
            _launch(dw_fn, "ring_spmm_bwd", c.dev,
                    run["stream"], *run["by_rel"], c.rank_ids, c.out_ids,
                    run["g"], run["n2"], run["h"], run["part"], B,
                    len(c.ranks), m, rows, cap, R, d, s)
            ring_spmm_bwd.launches += 1
            if c.stream is not None:
                dh.view(B, m, rows, d).index_copy_(1, c.ranks_ctrl,
                                                   run["dh"].to(h.device))
                part.index_copy_(0, c.ranks_ctrl, run["part"].to(h.device))
        _launch(lib.ring_dw_reduce_launch, "ring_spmm_bwd", h.device, ctrl,
                part, dw, m, R * W)
        ring_spmm_bwd.launches += 1
    return dh, dw


def _check_positions(tables, name: str) -> None:
    """Refuse time positions outside the tables' [0, T) on the CPU, where
    the plain versions read no table; on the card the kernels assert the
    same per graph, with no host sync."""
    if tables is None:
        return
    tab, t_pos = tables
    n_times = tab.fwd_ptr.shape[0]
    if bool(((t_pos < 0) | (t_pos >= n_times)).any()):
        raise ValueError(f"{name}: time positions {t_pos.tolist()} outside "
                         f"the tables' [0, {n_times})")


def _fwd(h, w, src, dst, rel, emask, m: int, rows: int, devices, tables,
         hot=None):
    """``ring_spmm_fwd``, with the tables the kernels walked (for the
    backward)."""
    _, s, _ = _check(h, w, src, dst, rel, emask, m, rows, devices,
                     h.shape[-1])
    if h.device.type == "cpu":
        _check_positions(tables, "ring_spmm_fwd")
        out, n2 = ring_spmm_fwd_plain(h, w, src, dst, rel, emask, m, rows,
                                      devices, hot=hot)
        return out, n2, tables
    if h.device.type != "cuda":
        raise ValueError(f"ring_spmm_fwd: no kernel for device {h.device}")
    emask = _kernel_args(h, w, emask, devices, s, "ring_spmm_fwd", hot)
    tables = _call_tables(h, w, src, dst, rel, emask, m, rows, tables)
    out, n2 = _ring_fwd_cuda(h, w, emask, m, rows, devices, s, *tables,
                             hot=hot)
    return out, n2, tables


def ring_spmm_fwd(h, w, src, dst, rel, emask, m: int, rows: int, devices,
                  tables=None, hot=None):
    """K13: (out [B, m * rows, d], norm^2 [B, m * rows]) on h's device. The
    kernels when h lies on a CUDA device (ranks on `devices`, all CUDA),
    the plain version when it lies on the CPU. `tables`: (``RingTables``
    of the edges' id space, t_pos [B]) when the B graphs are train
    snapshots of the data (their time positions t_pos): the kernels then
    read src, dst and rel from the tables and only the mask from the call
    (a position outside the tables' [0, T) raises on the CPU and stops the
    kernel on a device assert on the card); None sorts the call's edges
    into tables here. `hot`: None (float32) or torch.bfloat16, the
    bfloat16 mode."""
    return _fwd(h, w, src, dst, rel, emask, m, rows, devices, tables,
                hot)[:2]


ring_spmm_fwd.launches = 0
ring_spmm_fwd.csr_builds = 0  # tables sorted in a call (not the data's)


def ring_spmm_bwd(g, n2, h, w, src, dst, rel, emask, m: int, rows: int,
                  devices, tables=None, hot=None):
    """K13's backward: (dh like h, dw like w) from the cotangent g of the
    forward's output and its norm^2 n2 [B, m * rows], in the forward's
    mode `hot`. The kernels when h lies on a CUDA device (`tables` as in
    ``ring_spmm_fwd``), the plain version when it lies on the CPU."""
    _, s, _ = _check(h, w, src, dst, rel, emask, m, rows, devices,
                     h.shape[-1])
    if h.device.type == "cpu":
        _check_positions(tables, "ring_spmm_bwd")
        return ring_spmm_bwd_plain(g, n2, h, w, src, dst, rel, emask, m,
                                   rows, devices, hot=hot)
    if h.device.type != "cuda":
        raise ValueError(f"ring_spmm_bwd: no kernel for device {h.device}")
    emask = _kernel_args(h, w, emask, devices, s, "ring_spmm_bwd", hot)
    tables = _call_tables(h, w, src, dst, rel, emask, m, rows, tables)
    return _ring_bwd_cuda(g, n2, h, w, emask, m, rows, devices, s, *tables,
                          hot=hot)


ring_spmm_bwd.launches = 0


class RingSpMM(torch.autograd.Function):
    """K13 differentiated in h and w: the forward is ``ring_spmm_fwd``, the
    backward ``ring_spmm_bwd`` over the same tables (the JAX package's
    transpose: dmsg at the destinations, dw summed over the ranks, dh
    carried back round the ring to its owners), both in the mode `hot`."""

    @staticmethod
    def forward(ctx, h, w, src, dst, rel, emask, m, rows, devices, tables,
                hot):
        out, n2, tables = _fwd(h, w, src, dst, rel, emask, m, rows, devices,
                               tables, hot)
        ctx.save_for_backward(h, w, src, dst, rel, emask, n2)
        ctx.ring = (m, rows, devices, tables)
        ctx.hot = hot
        return out

    @staticmethod
    def backward(ctx, g):
        h, w, src, dst, rel, emask, n2 = ctx.saved_tensors
        dh, dw = ring_spmm_bwd(g, n2, h, w, src, dst, rel, emask, *ctx.ring,
                               hot=ctx.hot)
        return dh, dw, None, None, None, None, None, None, None, None, None


def ring_spmm(h, w, src, dst, rel, emask, m: int, rows: int, devices,
              kernels: bool = True, tables=None, hot=None):
    """K13 as a differentiable function of h [B, m * rows, d] and w
    (``kernels=False``: its plain version, on any device, differentiated
    by autograd), in the mode `hot` (None for float32, or
    torch.bfloat16). `tables` as in ``ring_spmm_fwd``."""
    if not kernels:
        return ring_spmm_fwd_plain(h, w, src, dst, rel, emask, m, rows,
                                   tuple(devices), hot=hot)[0]
    return RingSpMM.apply(h.contiguous(), w.contiguous(), src, dst, rel,
                          emask, m, rows, tuple(devices), tables, hot)
