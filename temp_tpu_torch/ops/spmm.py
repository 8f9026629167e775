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

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the hand-written kernel in ``csrc/spmm.cu`` (one warp per output
row over a CSR built here) or raises.
"""

from __future__ import annotations

import torch

from temp_tpu_torch import _build

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


def _check_cuda(name, h, src, dst, rel, emask, weight):
    dev = h.device
    for arg, t in (("src", src), ("dst", dst), ("rel", rel),
                   ("emask", emask), ("weight", weight)):
        if t.device != dev:
            raise ValueError(f"{name}: {arg} on {t.device}, h on {dev}")
    if h.dtype != torch.float32 or weight.dtype != torch.float32:
        raise TypeError(f"{name}: kernel takes float32 h and weight, got "
                        f"{h.dtype} and {weight.dtype}")
    if h.dim() != 2 or weight.dim() != 2 or weight.shape[1] != h.shape[1]:
        raise ValueError(f"{name}: h {tuple(h.shape)} and weight "
                         f"{tuple(weight.shape)} must be [N, d] and [R, d]")
    if not (h.is_contiguous() and weight.is_contiguous()):
        raise ValueError(f"{name}: h and weight must be contiguous")
    if h.shape[1] > _MAX_D:
        raise ValueError(f"{name}: d = {h.shape[1]} > {_MAX_D}")
    e = src.shape
    if src.dim() != 1 or dst.shape != e or rel.shape != e or emask.shape != e:
        raise ValueError(f"{name}: src/dst/rel/emask must be [E] of one size")
    for arg, t in (("src", src), ("dst", dst), ("rel", rel)):
        if t.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"{name}: {arg} must be an integer tensor")


def _device_kind(name, t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def _spmm_fwd(h, src, dst, rel, emask, weight):
    """K1f returning (out, norm^2): the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if _device_kind("spmm_fwd", h) == "cpu":
        return (spmm_fwd_plain(h, src, dst, rel, emask, weight),
                _norm2_plain(dst, emask.to(h.dtype), h.shape[0]))
    _check_cuda("spmm_fwd", h, src, dst, rel, emask, weight)
    n, d = h.shape
    em = emask.to(torch.float32)
    rowptr, s_src, s_rel, s_em = build_csr(
        dst, n, src.to(torch.int32), rel.to(torch.int32), em, keep=em > 0)
    out = torch.empty_like(h)
    n2 = torch.empty(n, dtype=torch.float32, device=h.device)
    err = _build.lib().spmm_fwd_launch(
        rowptr.data_ptr(), s_src.data_ptr(), s_rel.data_ptr(),
        s_em.data_ptr(), h.data_ptr(), weight.data_ptr(), out.data_ptr(),
        n2.data_ptr(), n, d, torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "spmm_fwd")
    spmm_fwd.launches += 1
    return out, n2


def spmm_fwd(h, src, dst, rel, emask, weight):
    """K1f: the kernel on CUDA tensors, the plain version on CPU tensors."""
    return _spmm_fwd(h, src, dst, rel, emask, weight)[0]


spmm_fwd.launches = 0


def spmm_bwd(g, n2, h, src, dst, rel, emask, weight):
    """K1b: (dh, dw) for the cotangent g of ``spmm_fwd``'s output and the
    forward's norm^2 n2 [N]. The kernel on CUDA tensors (one launch), the
    plain version on CPU tensors."""
    if _device_kind("spmm_bwd", g) == "cpu":
        return spmm_bwd_plain(g, n2, h, src, dst, rel, emask, weight)
    _check_cuda("spmm_bwd", h, src, dst, rel, emask, weight)
    if g.shape != h.shape or g.dtype != torch.float32 or g.device != h.device:
        raise ValueError(f"spmm_bwd: g {tuple(g.shape)} {g.dtype} must match "
                         f"h {tuple(h.shape)} float32 on {h.device}")
    if n2.shape != (h.shape[0],) or n2.dtype != torch.float32:
        raise ValueError("spmm_bwd: n2 must be float32 [N]")
    n, d = h.shape
    n_rels = weight.shape[0]
    src32, dst32 = src.to(torch.int32), dst.to(torch.int32)
    rel32, em = rel.to(torch.int32), emask.to(torch.float32)
    s_ptr, s_dst, s_rel, s_em = build_csr(src32, n, dst32, rel32, em,
                                          keep=em > 0)
    r_ptr, r_src, r_dst, r_em = build_csr(rel32, n_rels, src32, dst32, em,
                                          keep=em > 0)
    g, n2 = g.contiguous(), n2.contiguous()
    dh = torch.empty_like(h)
    dw = torch.empty_like(weight)
    p = lambda t: t.data_ptr()  # noqa: E731
    err = _build.lib().spmm_bwd_launch(
        p(s_ptr), p(s_dst), p(s_rel), p(s_em), p(r_ptr), p(r_src), p(r_dst),
        p(r_em), p(g), p(n2), p(h), p(weight), p(dh), p(dw), n, n_rels, d,
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "spmm_bwd")
    spmm_bwd.launches += 1
    return dh, dw


spmm_bwd.launches = 0


class SpMM(torch.autograd.Function):
    """Differentiable K1: ``spmm_fwd`` forward, ``spmm_bwd`` backward;
    gradients flow to h and weight only."""

    @staticmethod
    def forward(ctx, h, weight, src, dst, rel, emask):
        out, n2 = _spmm_fwd(h, src, dst, rel, emask, weight)
        ctx.save_for_backward(h, weight, src, dst, rel, emask, n2)
        return out

    @staticmethod
    def backward(ctx, g):
        h, weight, src, dst, rel, emask, n2 = ctx.saved_tensors
        dh, dw = spmm_bwd(g.contiguous(), n2, h, src, dst, rel, emask, weight)
        return dh, dw, None, None, None, None


def spmm(h, src, dst, rel, emask, weight):
    """K1 as a differentiable function of h and weight."""
    return SpMM.apply(h.contiguous(), weight.contiguous(), src, dst, rel,
                      emask)
