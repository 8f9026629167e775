"""Relational SpMM for diagonal relation weights: kernels K1f and K1b.

``spmm_fwd`` computes what the JAX package's ``rel_spmm_pallas`` returns:

    out[v] = norm[v]^2 * sum_{e : dst_e = v} h[src_e] * w[rel_e] * em_e

with ``norm = 1/deg`` (0 where deg = 0) and the degree counted over the
masked edges. ``spmm_bwd`` computes its cotangents (``_spmm_bwd`` of the
JAX package): with ``dmsg_e = g[dst_e] * norm[dst_e]^2 * em_e``,

    dh[u] = sum_{e : src_e = u} dmsg_e * w[rel_e]
    dw[r] = sum_{e : rel_e = r} dmsg_e * h[src_e]

The degree and norm take no gradient. ``spmm`` is the differentiable
function (the autograd ``SpMM``: K1f forward, K1b backward).

``hot=torch.bfloat16`` is the JAX kernels' bfloat16 instantiation
(``rel_spmm_pallas`` with ``dtype=bfloat16``, reached through
``ops.segment.rel_spmm``'s method "pallas"): with r(x) x rounded to
bfloat16, each message is r(r(h[src_e]) * r(w[rel_e])) and the sums stay
float32; the backward takes dmsg_e = r(g[dst_e] * norm[dst_e]^2) * em_e
and sums r(dmsg_e * r(w[rel_e])) into dh, r(dmsg_e * r(h[src_e])) into
dw, the gradients those of the unrounded h and w. The output and the
gradients are float32; an h given in bfloat16 is read as it is. The
kernels of that mode (``csrc/spmm_bf16.cu``) read w as float32 and h as
it is given, float32 or bfloat16, and round each gathered value in
registers, as the TPU kernel's body does; the plain versions round at the same points
(``ops.gru.hot_round``), so that autograd through them is that backward.

``onehot=True`` (with ``hot=torch.bfloat16``) is the bfloat16 function
of ``ops.segment.rel_spmm``'s method "onehot" (the JAX package's
``_rel_spmm_onehot`` with ``dtype=bfloat16``, XLA ops there): with norm
= 1/deg,

    out[v] = norm[v] * sum_{e : dst_e = v} r(r(r(h[src_e]) * r(w[rel_e]))
                                             * r(norm[v] * em_e))

(float32 sums), and the backward the transpose of those casts and
products: dmsg_e = r(r(g[dst_e] * norm[dst_e]) * r(norm[dst_e] * em_e)),
dh[u] = r(sum r(dmsg_e * r(w[rel_e]))), its sum float32 and rounded once,
and dw[r] the terms r(dmsg_e * r(h[src_e])) added one by one in the
edges' order (graph by graph, slot by slot), each partial sum rounded: the
JAX package's scatter-add of the rounded weights' cotangent in bfloat16
(``spmm_fwd_plain``'s form under autograd gives the same). The kernels of that mode are the
bfloat16 build's with its launchers' onehot flag; the forward then hands
the backward norm, not norm^2.

Every wrapper takes B graphs side by side: h [B * n, d] and edges [B, E]
(src, dst, rel and the bool mask emask), graph b's ids indexing its own
rows [b * n, (b + 1) * n); edges [E] are one graph. On a CPU tensor each
wrapper runs its plain version, on the edges as one graph
(``flat_graph``). On a CUDA tensor it launches the hand-written kernel in
``csrc/spmm.cu`` or raises: one launch over static CSR tables of the
graphs' edges (``RingTables`` of one rank, ``parallel/edge_partition.py``
``ring_tables``) by destination, by source and by relation. `tables` =
(those tables, t_pos [B]) names the train snapshot each graph is, in the
tables' id space: the data's tables (``TKGData.spmm``, sorted once by
``data.snapshots.ring_layout``). The kernels then read only the call's
mask per edge, which lies inside the tables' static mask, so a call makes
no sort and no host sync; a position outside the tables' [0, T) raises on
the CPU and stops the kernel on a device assert. Without tables a call
sorts its own edges into the same tables (counted on
``spmm_fwd.csr_builds``) and runs the same kernel, bit for bit equal.
"""

from __future__ import annotations

import torch

from temp_tpu_torch import _build
from temp_tpu_torch.ops.gru import hot_round
from temp_tpu_torch.parallel.edge_partition import ring_tables

_MAX_D = 256  # the kernels keep d / 32 <= 8 columns per lane in registers


def _norm_plain(dst, em, n: int):
    deg = torch.zeros(n, dtype=em.dtype, device=em.device).index_add_(
        0, dst.long(), em)
    return torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg))


def _norm2_plain(dst, em, n: int):
    norm = _norm_plain(dst, em, n)
    return norm * norm


def _rows(x, idx, hot):
    """The rows idx of x as float32, rounded to `hot` when given (x
    widened before the gather, so that a bfloat16 x's gradient sums in
    float32 and rounds once)."""
    return hot_round(x.to(torch.float32)[idx.long()], hot)


def _onehot_gather(x, idx):
    """The rows idx of x rounded to bfloat16, as bfloat16: x rounded, then
    gathered in float32, so that the cotangents of a row sum in float32
    and round once (the transpose of the JAX package's one-hot product of
    the rounded x)."""
    bf = torch.bfloat16
    return x.to(bf).to(torch.float32)[idx.long()].to(bf)


def bf16_scatter_add(terms, idx, n_rows: int):
    """[n_rows, d] float32: the rows of terms [E, d] added into rows idx
    [E] one by one in the order of E, each partial sum rounded to
    bfloat16, as XLA's scatter-add into a bfloat16 operand adds its
    updates (the terms are bfloat16 values)."""
    idx = idx.long()
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=n_rows)
    pos = torch.empty_like(idx)
    pos[order] = (torch.arange(len(idx), device=idx.device)
                  - (torch.cumsum(counts, 0) - counts)[idx[order]])
    acc = torch.zeros((n_rows,) + tuple(terms.shape[1:]),
                      dtype=torch.float32, device=terms.device)
    for k in range(int(counts.max()) if len(idx) else 0):
        sel = torch.nonzero(pos == k)[:, 0]
        rows = idx[sel]
        acc[rows] = hot_round(acc[rows] + terms[sel].to(torch.float32),
                              torch.bfloat16)
    return acc


class _Bf16Gather(torch.autograd.Function):
    """x [R, d] rounded to bfloat16 and gathered at idx, as bfloat16 (the
    JAX package's gather of a bfloat16 table); the backward adds the
    rows' cotangents one by one in bfloat16 (``bf16_scatter_add``)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = x.shape[0], x.dtype
        return x.to(torch.bfloat16)[idx.long()]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return bf16_scatter_add(g, idx, ctx.n_rows).to(ctx.dtype), None


def _spmm_onehot_plain(h, src, dst, rel, emask, weight):
    """The "onehot" mode's plain forward (the module's docstring), written
    with the JAX package's casts and bfloat16 products, so that autograd
    through it is their transpose."""
    em = emask.to(torch.float32)
    norm = _norm_plain(dst, em, h.shape[0])
    msg = _onehot_gather(h, src) * _Bf16Gather.apply(weight, rel)
    scale = (norm[dst.long()] * em).to(torch.bfloat16)[:, None]
    raw = torch.zeros(h.shape, dtype=torch.float32,
                      device=h.device).index_add_(
        0, dst.long(), (msg * scale).to(torch.float32))
    return raw * norm[:, None]


def spmm_fwd_plain(h, src, dst, rel, emask, weight, hot=None,
                   onehot: bool = False):
    """Plain PyTorch version: h [N, d], weight [R, d], src/dst/rel/emask
    [E] -> [N, d] float32; `hot` the bfloat16 mode, `onehot` its "onehot"
    rounding (the module's docstring)."""
    if onehot:
        return _spmm_onehot_plain(h, src, dst, rel, emask, weight)
    em = emask.to(torch.float32)
    msg = hot_round(_rows(h, src, hot) * _rows(weight, rel, hot)
                    * em[:, None], hot)
    raw = torch.zeros(h.shape, dtype=torch.float32,
                      device=h.device).index_add_(0, dst.long(), msg)
    return raw * _norm2_plain(dst, em, h.shape[0])[:, None]


def spmm_bwd_plain(g, n2, h, src, dst, rel, emask, weight, hot=None,
                   onehot: bool = False):
    """Plain PyTorch version of the backward: g [N, d] the cotangent of
    out, n2 [N] norm^2 (norm in the "onehot" mode). Returns (dh [N, d],
    dw [R, d]), float32; `hot` the bfloat16 mode (g * norm^2 rounded once
    a row, before its gather), `onehot` its "onehot" rounding."""
    em = emask.to(torch.float32)
    if onehot:
        bf = torch.bfloat16
        scale = hot_round(n2[dst.long()] * em, bf)[:, None]
        dmsg = hot_round(hot_round(g * n2[:, None], bf)[dst.long()] * scale,
                         bf)
        dh = torch.zeros(h.shape, dtype=torch.float32,
                         device=h.device).index_add_(
            0, src.long(), hot_round(dmsg * _rows(weight, rel, bf), bf))
        dw = bf16_scatter_add(hot_round(dmsg * _rows(h, src, bf), bf)
                              * em[:, None], rel, weight.shape[0])
        return hot_round(dh, bf), dw
    dmsg = hot_round(g * n2[:, None], hot)[dst.long()] * em[:, None]
    dh = torch.zeros(h.shape, dtype=torch.float32,
                     device=h.device).index_add_(
        0, src.long(), hot_round(dmsg * _rows(weight, rel, hot), hot))
    dw = torch.zeros(weight.shape, dtype=torch.float32,
                     device=h.device).index_add_(
        0, rel.long(), hot_round(dmsg * _rows(h, src, hot), hot))
    return dh, dw


def build_csr(key, n_rows: int, *edge_arrays, keep=None):
    """Sort edges by `key` (stable). Returns the int32 row pointer
    [n_rows + 1] and each edge array permuted into that order. Edges where
    `keep` is False (masked edges, which add nothing to any sum) sort after
    the last row, so no row's loop visits them."""
    if keep is not None:
        key = torch.where(keep, key, torch.full_like(key, n_rows))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key.long(), minlength=n_rows + 1)[:n_rows]
    rowptr = torch.zeros(n_rows + 1, dtype=torch.int64, device=key.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    return (rowptr.to(torch.int32),) + tuple(a[order].contiguous()
                                             for a in edge_arrays)


def flat_graph(src, dst, n_rows: int):
    """Edges of B graphs [B, E] (ids < n_rows) as one block-diagonal graph
    over B * n_rows rows."""
    offs = (torch.arange(src.shape[0], device=src.device) * n_rows)[:, None]
    return (src.long() + offs).reshape(-1), (dst.long() + offs).reshape(-1)


def _graphs(name, h, src, dst, rel, emask):
    """(B, n, src, dst, rel, emask as [B, E]) of a call on h [B * n, d]."""
    if src.dim() == 1:
        src, dst, rel, emask = (x[None] for x in (src, dst, rel, emask))
    if (src.dim() != 2 or any(x.shape != src.shape for x in (dst, rel, emask))
            or src.shape[0] < 1 or h.dim() != 2
            or h.shape[0] % src.shape[0]):
        raise ValueError(f"{name}: edges {tuple(src.shape)} must be [E] or "
                         f"[B, E] of one size, h {tuple(h.shape)} [B * n, d]")
    return (src.shape[0], h.shape[0] // src.shape[0], src, dst, rel, emask)


def _check_hot(name, hot, onehot: bool = False):
    if hot not in (None, torch.bfloat16):
        raise TypeError(f"{name}: no kernel mode for {hot}")
    if onehot and hot is None:
        raise ValueError(f"{name}: the onehot rounding is a bfloat16 mode")


def _check_cuda(name, h, src, dst, rel, emask, weight, hot=None):
    dev = h.device
    for arg, t in (("src", src), ("dst", dst), ("rel", rel),
                   ("emask", emask), ("weight", weight)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, h on {dev}")
    ok = (torch.float32,) if hot is None else (torch.float32, hot)
    if h.dtype not in ok or weight.dtype != torch.float32:
        raise TypeError(f"{name}: kernel of mode {hot or torch.float32} "
                        f"takes h in {ok} and a float32 weight, got "
                        f"{h.dtype} and {weight.dtype}")
    if weight.dim() != 2 or weight.shape[1] != h.shape[1]:
        raise ValueError(f"{name}: h {tuple(h.shape)} and weight "
                         f"{tuple(weight.shape)} must be [N, d] and [R, d]")
    if not (h.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"{name}: h and weight must be contiguous")
    if h.shape[1] > _MAX_D:
        raise ValueError(f"{name}: d = {h.shape[1]} > {_MAX_D}")
    for arg, t in (("src", src), ("dst", dst), ("rel", rel)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name}: {arg} must be an integer tensor")


def _device_kind(name, t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


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


def _call_tables(name, h, weight, src, dst, rel, emask, n: int, tables):
    """(tables, t_pos [B] int64) of a CUDA call: the given ones, checked
    against the call (shapes and devices only, so no host sync), or the
    call's own edges sorted here (counted on ``spmm_fwd.csr_builds``)."""
    B, E = src.shape
    n_rels = weight.shape[0]
    if tables is None:
        spmm_fwd.csr_builds += 1
        return (ring_tables(src, dst, rel, emask, 1, n, n_rels),
                torch.arange(B, device=h.device))
    tab, t_pos = tables
    t_pos = t_pos.reshape(-1).long().contiguous()
    if (tab.fwd_ptr.shape[1:] != (1, tab.rows + 1) or tab.rows < n
            or tab.fwd_edge.shape[2:] != (E, 3)
            or tab.rel_ptr.shape[2] != n_rels + 1):
        raise ValueError(
            f"{name}: tables of rows = {tab.rows}, "
            f"{tuple(tab.fwd_ptr.shape)}, {tuple(tab.fwd_edge.shape)}, "
            f"{tuple(tab.rel_ptr.shape)} for {B} graphs of {n} rows, E = "
            f"{E}, {n_rels} relations")
    if (t_pos.shape != (B,) or t_pos.device != h.device
            or tab.fwd_ptr.device != h.device):
        raise ValueError(f"{name}: t_pos {tuple(t_pos.shape)} on "
                         f"{t_pos.device}, tables on {tab.fwd_ptr.device} "
                         f"for {B} graphs on {h.device}")
    return tab, t_pos


def _mask(emask):
    """The call's mask as bytes [B, E] with rows of unit stride."""
    return emask.bool().contiguous()


def _vec(*ts) -> int:
    """Values a lane loads at once: 4 where every row is aligned to four
    of its values (16 bytes of float32, 8 of bfloat16)."""
    d = ts[0].shape[1]
    return 4 if d % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in ts) else 1


def _launcher(name: str, hot):
    """The float32 launcher `name`, or its bfloat16 mode's."""
    lib = _build.lib()
    return getattr(lib, name if hot is None else f"{name}_bf16")


def _h_bf16(h) -> int:
    """The launchers' h_bf16: 1 for a bfloat16 h."""
    return int(h.dtype == torch.bfloat16)


def _spmm_fwd(h, src, dst, rel, emask, weight, tables=None, hot=None,
              onehot: bool = False):
    """K1f returning (out, norm^2 (norm for `onehot`), the tables it
    walked): the kernel on CUDA tensors, the plain version on CPU tensors
    (given `tables`), in the mode `hot` (None, or torch.bfloat16) and
    `onehot`'s rounding."""
    kind = _device_kind("spmm_fwd", h)
    _check_hot("spmm_fwd", hot, onehot)
    B, n, src, dst, rel, emask = _graphs("spmm_fwd", h, src, dst, rel, emask)
    if kind == "cpu":
        _check_positions(tables, "spmm_fwd")
        s, t = flat_graph(src, dst, n)
        em = emask.reshape(-1)
        norm = (_norm_plain if onehot else _norm2_plain)(
            t, em.to(torch.float32), h.shape[0])
        return (spmm_fwd_plain(h, s, t, rel.reshape(-1), em, weight, hot,
                               onehot), norm, tables)
    _check_cuda("spmm_fwd", h, src, dst, rel, emask, weight, hot)
    mask = _mask(emask)
    tab, t_pos = _call_tables("spmm_fwd", h, weight, src, dst, rel, mask, n,
                              tables)
    out = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    n2 = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    err = _launcher("spmm_fwd_launch", hot)(
        tab.fwd_ptr.data_ptr(), tab.fwd_edge.data_ptr(), t_pos.data_ptr(),
        tab.fwd_ptr.shape[0], mask.data_ptr(), h.data_ptr(),
        weight.data_ptr(), out.data_ptr(), n2.data_ptr(), B, n, tab.rows,
        src.shape[1], h.shape[1], _vec(h, weight), _h_bf16(h), int(onehot),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "spmm_fwd")
    spmm_fwd.launches += 1
    if hot is not None:
        spmm_fwd.launches_bf16 += 1
    if onehot:
        spmm_fwd.launches_onehot += 1
    return out, n2, (tab, t_pos)


def spmm_fwd(h, src, dst, rel, emask, weight, tables=None, hot=None,
             onehot: bool = False):
    """K1f: the kernel on CUDA tensors, the plain version on CPU tensors.
    `tables`: (the data's ``RingTables`` of the edges' id space, t_pos
    [B]) for graphs that are train snapshots; None sorts the call's
    edges. `hot`: None (float32) or torch.bfloat16, the bfloat16 mode;
    `onehot`: its "onehot" rounding (the module's docstring)."""
    return _spmm_fwd(h, src, dst, rel, emask, weight, tables, hot,
                     onehot)[0]


spmm_fwd.launches = 0       # every launch, in any mode
spmm_fwd.launches_bf16 = 0  # the bfloat16 modes'
spmm_fwd.launches_onehot = 0  # the "onehot" rounding's (among them)
spmm_fwd.csr_builds = 0  # tables sorted in a call (not the data's)


def spmm_bwd(g, n2, h, src, dst, rel, emask, weight, tables=None, hot=None,
             onehot: bool = False):
    """K1b: (dh, dw) for the cotangent g of ``spmm_fwd``'s output and the
    forward's norm^2 n2 [B * n] (norm for `onehot`). The kernel on CUDA
    tensors (one launch), the plain version on CPU tensors; `tables`,
    `hot` and `onehot` as in ``spmm_fwd``. dh and dw are float32."""
    kind = _device_kind("spmm_bwd", g)
    _check_hot("spmm_bwd", hot, onehot)
    B, n, src, dst, rel, emask = _graphs("spmm_bwd", h, src, dst, rel, emask)
    if kind == "cpu":
        _check_positions(tables, "spmm_bwd")
        s, t = flat_graph(src, dst, n)
        return spmm_bwd_plain(g, n2, h, s, t, rel.reshape(-1),
                              emask.reshape(-1), weight, hot, onehot)
    _check_cuda("spmm_bwd", h, src, dst, rel, emask, weight, hot)
    if g.shape != h.shape or g.dtype != torch.float32 or g.device != h.device:
        raise ValueError(f"spmm_bwd: g {tuple(g.shape)} {g.dtype} must be "
                         f"float32 of h's shape {tuple(h.shape)} on "
                         f"{h.device}")
    if n2.shape != (h.shape[0],) or n2.dtype != torch.float32:
        raise ValueError("spmm_bwd: n2 must be float32 [N]")
    mask = _mask(emask)
    tab, t_pos = _call_tables("spmm_bwd", h, weight, src, dst, rel, mask, n,
                              tables)
    g, n2 = g.contiguous(), n2.contiguous()
    dh = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    dw = torch.empty(weight.shape, dtype=torch.float32, device=h.device)
    p = lambda t: t.data_ptr()  # noqa: E731
    err = _launcher("spmm_bwd_launch", hot)(
        p(tab.src_ptr), p(tab.src_edge), p(tab.rel_ptr), p(tab.rel_edge),
        p(t_pos), tab.fwd_ptr.shape[0], p(mask), p(g), p(n2), p(h),
        p(weight), p(dh), p(dw), B, n, tab.rows, src.shape[1],
        weight.shape[0], h.shape[1], _vec(g, h, weight),
        _h_bf16(h), int(onehot),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "spmm_bwd")
    spmm_bwd.launches += 1
    if hot is not None:
        spmm_bwd.launches_bf16 += 1
    if onehot:
        spmm_bwd.launches_onehot += 1
    return dh, dw


spmm_bwd.launches = 0
spmm_bwd.launches_bf16 = 0
spmm_bwd.launches_onehot = 0


class SpMM(torch.autograd.Function):
    """Differentiable K1: ``spmm_fwd`` forward, ``spmm_bwd`` backward over
    the tables the forward walked (sorted once where the call gave none)
    and the h and w it read (in the bfloat16 mode `hot` the backward
    rounds them again, as the forward did); gradients flow to h and weight
    only, float32 (autograd casts dh to a bfloat16 h's dtype)."""

    @staticmethod
    def forward(ctx, h, weight, src, dst, rel, emask, tables, hot, onehot):
        out, n2, tables = _spmm_fwd(h, src, dst, rel, emask, weight, tables,
                                    hot, onehot)
        ctx.save_for_backward(h, weight, src, dst, rel, emask, n2)
        ctx.tables, ctx.hot, ctx.onehot = tables, hot, onehot
        return out

    @staticmethod
    def backward(ctx, g):
        h, weight, src, dst, rel, emask, n2 = ctx.saved_tensors
        dh, dw = spmm_bwd(g.contiguous(), n2, h, src, dst, rel, emask, weight,
                          tables=ctx.tables, hot=ctx.hot, onehot=ctx.onehot)
        return dh, dw, None, None, None, None, None, None, None


def spmm(h, src, dst, rel, emask, weight, tables=None, hot=None,
         onehot: bool = False):
    """K1 as a differentiable function of h and weight; `tables`, `hot`
    and `onehot` as in ``spmm_fwd``."""
    return SpMM.apply(h.contiguous(), weight.contiguous(), src, dst, rel,
                      emask, tables, hot, onehot)
