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
from temp_tpu_torch.parallel.edge_partition import ring_tables

_MAX_D = 256  # the kernels keep d / 32 <= 8 columns per lane in registers


def _norm2_plain(dst, em, n: int):
    deg = torch.zeros(n, dtype=em.dtype, device=em.device).index_add_(
        0, dst.long(), em)
    norm = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg))
    return norm * norm


def spmm_fwd_plain(h, src, dst, rel, emask, weight):
    """Plain PyTorch version: h [N, d], weight [R, d], src/dst/rel/emask
    [E] -> [N, d]."""
    em = emask.to(h.dtype)
    msg = h[src.long()] * weight[rel.long()] * em[:, None]
    raw = torch.zeros_like(h).index_add_(0, dst.long(), msg)
    return raw * _norm2_plain(dst, em, h.shape[0])[:, None]


def spmm_bwd_plain(g, n2, h, src, dst, rel, emask, weight):
    """Plain PyTorch version of the backward: g [N, d] the cotangent of
    out, n2 [N] norm^2. Returns (dh [N, d], dw [R, d])."""
    em = emask.to(g.dtype)
    dmsg = (g * n2[:, None])[dst.long()] * em[:, None]
    dh = torch.zeros_like(h).index_add_(0, src.long(),
                                        dmsg * weight[rel.long()])
    dw = torch.zeros_like(weight).index_add_(0, rel.long(),
                                             dmsg * h[src.long()])
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


def _check_cuda(name, h, src, dst, rel, emask, weight):
    dev = h.device
    for arg, t in (("src", src), ("dst", dst), ("rel", rel),
                   ("emask", emask), ("weight", weight)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, h on {dev}")
    if h.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"{name}: kernel takes float32 h and weight, got "
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
    """Floats a lane loads at once: 4 where every row is 16-byte aligned."""
    d = ts[0].shape[1]
    return 4 if d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts) else 1


def _spmm_fwd(h, src, dst, rel, emask, weight, tables=None):
    """K1f returning (out, norm^2, the tables it walked): the kernel on
    CUDA tensors, the plain version on CPU tensors (given `tables`)."""
    kind = _device_kind("spmm_fwd", h)
    B, n, src, dst, rel, emask = _graphs("spmm_fwd", h, src, dst, rel, emask)
    if kind == "cpu":
        _check_positions(tables, "spmm_fwd")
        s, t = flat_graph(src, dst, n)
        em = emask.reshape(-1)
        return (spmm_fwd_plain(h, s, t, rel.reshape(-1), em, weight),
                _norm2_plain(t, em.to(h.dtype), h.shape[0]), tables)
    _check_cuda("spmm_fwd", h, src, dst, rel, emask, weight)
    mask = _mask(emask)
    tab, t_pos = _call_tables("spmm_fwd", h, weight, src, dst, rel, mask, n,
                              tables)
    out = torch.empty_like(h)
    n2 = torch.empty(h.shape[0], dtype=torch.float32, device=h.device)
    err = _build.lib().spmm_fwd_launch(
        tab.fwd_ptr.data_ptr(), tab.fwd_edge.data_ptr(), t_pos.data_ptr(),
        tab.fwd_ptr.shape[0], mask.data_ptr(), h.data_ptr(),
        weight.data_ptr(), out.data_ptr(), n2.data_ptr(), B, n, tab.rows,
        src.shape[1], h.shape[1], _vec(h, weight),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "spmm_fwd")
    spmm_fwd.launches += 1
    return out, n2, (tab, t_pos)


def spmm_fwd(h, src, dst, rel, emask, weight, tables=None):
    """K1f: the kernel on CUDA tensors, the plain version on CPU tensors.
    `tables`: (the data's ``RingTables`` of the edges' id space, t_pos
    [B]) for graphs that are train snapshots; None sorts the call's
    edges."""
    return _spmm_fwd(h, src, dst, rel, emask, weight, tables)[0]


spmm_fwd.launches = 0
spmm_fwd.csr_builds = 0  # tables sorted in a call (not the data's)


def spmm_bwd(g, n2, h, src, dst, rel, emask, weight, tables=None):
    """K1b: (dh, dw) for the cotangent g of ``spmm_fwd``'s output and the
    forward's norm^2 n2 [B * n]. The kernel on CUDA tensors (one launch),
    the plain version on CPU tensors; `tables` as in ``spmm_fwd``."""
    kind = _device_kind("spmm_bwd", g)
    B, n, src, dst, rel, emask = _graphs("spmm_bwd", h, src, dst, rel, emask)
    if kind == "cpu":
        _check_positions(tables, "spmm_bwd")
        s, t = flat_graph(src, dst, n)
        return spmm_bwd_plain(g, n2, h, s, t, rel.reshape(-1),
                              emask.reshape(-1), weight)
    _check_cuda("spmm_bwd", h, src, dst, rel, emask, weight)
    if g.shape != h.shape or g.dtype != torch.float32 or g.device != h.device:
        raise ValueError(f"spmm_bwd: g {tuple(g.shape)} {g.dtype} must match "
                         f"h {tuple(h.shape)} float32 on {h.device}")
    if n2.shape != (h.shape[0],) or n2.dtype != torch.float32:
        raise ValueError("spmm_bwd: n2 must be float32 [N]")
    mask = _mask(emask)
    tab, t_pos = _call_tables("spmm_bwd", h, weight, src, dst, rel, mask, n,
                              tables)
    g, n2 = g.contiguous(), n2.contiguous()
    dh = torch.empty_like(h)
    dw = torch.empty_like(weight)
    p = lambda t: t.data_ptr()  # noqa: E731
    err = _build.lib().spmm_bwd_launch(
        p(tab.src_ptr), p(tab.src_edge), p(tab.rel_ptr), p(tab.rel_edge),
        p(t_pos), tab.fwd_ptr.shape[0], p(mask), p(g), p(n2), p(h),
        p(weight), p(dh), p(dw), B, n, tab.rows, src.shape[1],
        weight.shape[0], h.shape[1], _vec(g, h, weight),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "spmm_bwd")
    spmm_bwd.launches += 1
    return dh, dw


spmm_bwd.launches = 0


class SpMM(torch.autograd.Function):
    """Differentiable K1: ``spmm_fwd`` forward, ``spmm_bwd`` backward over
    the tables the forward walked (sorted once where the call gave none);
    gradients flow to h and weight only."""

    @staticmethod
    def forward(ctx, h, weight, src, dst, rel, emask, tables):
        out, n2, tables = _spmm_fwd(h, src, dst, rel, emask, weight, tables)
        ctx.save_for_backward(h, weight, src, dst, rel, emask, n2)
        ctx.tables = tables
        return out

    @staticmethod
    def backward(ctx, g):
        h, weight, src, dst, rel, emask, n2 = ctx.saved_tensors
        dh, dw = spmm_bwd(g.contiguous(), n2, h, src, dst, rel, emask, weight,
                          tables=ctx.tables)
        return dh, dw, None, None, None, None, None


def spmm(h, src, dst, rel, emask, weight, tables=None):
    """K1 as a differentiable function of h and weight; `tables` as in
    ``spmm_fwd``."""
    return SpMM.apply(h.contiguous(), weight.contiguous(), src, dst, rel,
                      emask, tables)
