"""Relational sparse message passing: the single graph primitive of the model.

Gather -> per-relation block-diagonal transform -> scatter-add by
destination, with the reference's double degree normalization. The
canonical configuration has n_bases == d (1x1 blocks: a per-relation
diagonal scale); there ``rel_spmm`` goes through kernel K1
(``ops/spmm.py``: K1f forward, K1b backward). Block-diagonal weights stay a
torch einsum, differentiated by autograd.
"""

from __future__ import annotations

import torch

from temp_tpu_torch.ops.spmm import spmm, spmm_fwd_plain


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


def rel_message(h_src, rel, weight, n_bases: int, d_in: int, d_out: int):
    """Per-edge block-diagonal relation transform. weight[r] holds n_bases
    blocks of shape (d_in/n_bases, d_out/n_bases)."""
    si = d_in // n_bases
    so = d_out // n_bases
    w = weight[rel.long()]
    if si == 1 and so == 1:
        return h_src * w
    w = w.reshape(-1, n_bases, si, so)
    hb = h_src.reshape(-1, n_bases, si)
    return torch.einsum("ebi,ebio->ebo", hb, w).reshape(-1, n_bases * so)


def rel_spmm(h, src, dst, rel, emask, weight, n_bases: int, d_out: int,
             num_ents: int, kernels: bool = True):
    """RGCN neighbourhood aggregation with double degree normalization:

        msg_e = (h[src_e] . W[rel_e]) * norm[dst_e] * emask_e
        agg_v = (sum_{e: dst_e = v} msg_e) * norm[v]

    Returns [num_ents, d_out]; rows without in-edges are exactly 0. With
    diagonal weights this is kernel K1, differentiable in h and weight
    (``kernels=False`` runs its plain version on any device, differentiated
    by autograd).
    """
    d_in = h.shape[-1]
    if n_bases == d_in == d_out:
        fn = spmm if kernels else spmm_fwd_plain
        return fn(h, src, dst, rel, emask, weight)
    norm = in_degree_norm(dst, emask, num_ents)
    msg = rel_message(h[src.long()], rel, weight, n_bases, d_in, d_out)
    msg = msg * (norm[dst.long()] * emask.to(h.dtype))[:, None]
    return segment_sum(msg, dst, num_ents) * norm[:, None]
