"""The dense final step and the exact-softmax loss: kernels K3, K4 and K5;
and the fused filtered eval, kernel K11.

For a batch of B target snapshots, ``fused_final_fwd`` (K3) computes what
the JAX package's ``fused_final_loss`` returns for each element: the
two-layer RGCN+GRU step over all N entities against the decayed history
(``_Final.encoder``), the optional ``use_embed_for_non_active`` select, the
ComplEx queries of the snapshot's edges in both directions, their scores
against the whole table with the other true answers masked out, and the
tail+head cross-entropy averaged over the positives. It returns the loss of
each element, [B], and what the backward needs (the table and layer 1's
output, as the JAX kernel saves them).

The backward runs as the JAX package's ``_fused_final_bwd`` does:
``fused_final_bwd_loss`` (K4) takes the saved table to the cotangents of
the table and the relation embeddings, ``select_bwd`` splits the table's
cotangent between layer 2's output and the input embeddings, and
``fused_final_bwd_layer`` (K5) runs once for layer 2 and once for layer 1,
giving each layer's input, history and weight cotangents. ``FusedFinal`` is
the autograd function made of them.

On a CPU tensor each wrapper runs its plain version: the forward in plain
PyTorch (differentiable by autograd), K4 and K5 as the JAX kernels' own
backward formulas written in PyTorch. On a CUDA tensor it launches the
hand-written kernels in ``csrc/fused_final.cu`` or raises: K3 four launches
(layer 1, layer 2, the score partials, the loss), K4 four (the query
cotangent partials, their sum per edge, the table cotangent, the relation
sum), K5 five a layer.

The plain forward masks the true answers through the per-time filter
tables (``ops/membership.py``, as ``train_loss_single`` does); the kernels
read the same answers as one sorted list per edge slot
(``data/snapshots.py`` ``AnswerLists``), built once with the model from the
data.

``hot=torch.bfloat16`` is the JAX kernels' bfloat16 instantiation of K3-K5:
the encoder's products and SpMM as K2's bfloat16 mode (``ops/fused_window``
``hot_mm``, ``spmm_hot_plain``), the history read from bfloat16; K3 gathers
the loss's subject, object and relation rows as a high and a low bfloat16
part (about 16 significant bits, ``_hilo``; the JAX docstring records that
plainly rounded rows trained about one MRR point low) and scores in
bfloat16; K4 recomputes the queries from the table rounded to bfloat16 (the
JAX kernel's residual table is stored so) and rounds the score and row
cotangents where the JAX kernel casts them; K5 is K2b's bfloat16 layer. On
the card the same launches of the kernels in their bfloat16 mode
(``csrc/fused_final_bf16.cu``): K3's score launch then scores both query
sets (the forward's, and the backward's from the rounded table, whose
log-sum-exp K4 reads), so the launch counts stay those of float32; K3's
layer launches are K2f's native bfloat16 kernel at one step and K5's
K2b's, to which the wrappers hand each layer's input and the weights
rounded once (``ops/fused_window`` ``operand``, ``layer_operands``; K3
rounds layer 1's output into layer 2's input between its two launches),
so K5 recomputes the conv output and the gates of K3's layers bit for
bit.

``fused_eval_ranks`` (K11) computes what the JAX package's
``fused_eval_ranks`` returns for each of B eval targets: the final step in
eval mode (K3's two layer launches: no dropout, the full edge mask), the
ComplEx scores of the split's query slots against the whole table in both
directions with the other true answers of the TOTAL filter table at -1e7,
the filtered ranks (1 + the count of strictly greater scores) and the BCE of
the positives; ``table_ranks`` is its ranking half (two launches). Its
plain version, ``fused_eval_ranks_plain``, is the port's unfused eval
arithmetic (``eval_ranks_single``) batched over B. Its bfloat16 mode
(``hot``) is the JAX kernel's: the final step's encoder as K3's bfloat16
layers (the histories in bfloat16, the float32 table), then the ranks and
the BCE in float32 on that table, as the JAX kernel upcasts the table and
scores at HIGHEST ("eval scoring is f32 end to end"): K3's two bfloat16
layer launches, then the float32 rank and reduce launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from temp_tpu_torch import _build
from temp_tpu_torch.ops.fused_window import (
    _device, _gru_t, _lib_fn, hot_mm, kernel_operands, layer_operands,
    operand, spmm_hot_plain,
)
from temp_tpu_torch.ops.gru import hot_round
from temp_tpu_torch.ops.membership import true_answer_mask
from temp_tpu_torch.ops.ranking import filtered_ranks
from temp_tpu_torch.ops.scores import complex_all, complex_single
from temp_tpu_torch.ops.spmm import (
    _norm2_plain, build_csr, spmm_bwd_plain, spmm_fwd_plain,
)

_MAX_D = 128       # K5 reuses K2b's GRU launch, which takes d <= 128
_N_SPLIT = 8       # K3/K4 cut the entity columns into this many ranges
# K5's (and K9+K10's) weight launch cuts the B*N rows into this many
# ranges. At B*N = 57,024 and d = 128: 112 ring slots of 32 rows a range,
# 16 x 28 tiles of 64 x 64 = 448 blocks (K9+K10: 16 x 53), one wave of the
# H100's 132 SMs at four 128-thread blocks an SM; 32 ranges took two waves
_WGRAD_SPLIT = 16
# K5's weight cotangents as its weight launch lays them out in one buffer
_WGRAD_LAYOUT = ("dwih", "dbih", "dwhh", "dbhh", "dloop")
_NEG = -1e9        # the score of a masked column (JAX: jnp.where(bad, -1e9))


class FinalGraph(NamedTuple):
    """The inputs of the final step that take no gradient, for B elements.

    src/dst/rel [B, E] int32: the final snapshot's edge slots (global
    entity ids); emf [B, E] float: the encoder's edge subsample; posm
    [B, E] float: the positives of the loss; dt [B, N]: steps since each
    entity's last window state; active [B, N] float (the select's mask) or
    None; m1/m2 [B, N, d] the self-loop dropout masks over keep, or None.
    The true answers of every edge slot's query: as filter tables (the
    plain version; *_grp/*_val [B, F]) and as lists (the kernels;
    *_ptr [B, E + 1] into *_ans). lam: the decay rate; r2: 2 * num_rels.
    """

    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    emf: torch.Tensor
    posm: torch.Tensor
    dt: torch.Tensor
    active: Optional[torch.Tensor]
    m1: Optional[torch.Tensor]
    m2: Optional[torch.Tensor]
    tail_grp: torch.Tensor
    tail_val: torch.Tensor
    head_grp: torch.Tensor
    head_val: torch.Tensor
    tail_ptr: torch.Tensor
    tail_ans: torch.Tensor
    head_ptr: torch.Tensor
    head_ans: torch.Tensor
    lam: float
    r2: int


# -- ComplEx queries (the JAX module's _qhat_* helpers) ----------------------

def _halves(x):
    d2 = x.shape[-1] // 2
    return x[..., :d2], x[..., d2:]


def _qhat_tail(s, r):
    s_re, s_im = _halves(s)
    r_re, r_im = _halves(r)
    return torch.cat([s_re * r_re - s_im * r_im, s_re * r_im + s_im * r_re],
                     -1)


def _qhat_head(o, r):
    o_re, o_im = _halves(o)
    r_re, r_im = _halves(r)
    return torch.cat([r_re * o_re + r_im * o_im, r_re * o_im - r_im * o_re],
                     -1)


def _qhat_tail_bwd(dq, s, r):
    dq_re, dq_im = _halves(dq)
    s_re, s_im = _halves(s)
    r_re, r_im = _halves(r)
    d_s = torch.cat([dq_re * r_re + dq_im * r_im,
                     -dq_re * r_im + dq_im * r_re], -1)
    d_r = torch.cat([dq_re * s_re + dq_im * s_im,
                     -dq_re * s_im + dq_im * s_re], -1)
    return d_s, d_r


def _qhat_head_bwd(dq, o, r):
    dq_re, dq_im = _halves(dq)
    o_re, o_im = _halves(o)
    r_re, r_im = _halves(r)
    d_o = torch.cat([dq_re * r_re - dq_im * r_im,
                     dq_re * r_im + dq_im * r_re], -1)
    d_r = torch.cat([dq_re * o_re + dq_im * o_im,
                     dq_re * o_im - dq_im * o_re], -1)
    return d_o, d_r


# -- plain versions ----------------------------------------------------------

def _flat(gr: FinalGraph, n: int):
    """The B final graphs as one block-diagonal graph over B * n rows."""
    offs = (torch.arange(gr.src.shape[0], device=gr.src.device) * n)[:, None]
    return ((gr.src.long() + offs).reshape(-1),
            (gr.dst.long() + offs).reshape(-1), gr.rel.reshape(-1),
            gr.emf.reshape(-1))


def _conv_plain(x, gr: FinalGraph, w, loop, mask, hot=None):
    """Relational SpMM with double degree norm plus the (dropped) self-loop
    over the final graphs; x [B, N, d]; in the mode `hot` (K2's
    ``spmm_hot_plain`` and ``hot_mm`` for bfloat16)."""
    B, N, d = x.shape
    edges = (x.reshape(B * N, d), *_flat(gr, N), w)
    agg = (spmm_fwd_plain(*edges) if hot is None
           else spmm_hot_plain(*edges, hot))
    lp = hot_mm(x, loop, hot)
    if mask is not None:
        lp = lp * mask
    return agg.reshape(B, N, d) + lp


def _gru_dict(wih_t, whh_t, bih, bhh):
    return {"wih_t": wih_t, "whh_t": whh_t, "bih": bih, "bhh": bhh}


def _encoder_plain(h0, hist1, hist2, gr: FinalGraph, wrel, loop1, loop2, g1,
                   g2, hot=None):
    """(table, out1), each [B, N, d] (``_Final.encoder``), in the mode
    `hot`; the histories in any float dtype."""
    B, N, d = hist1.shape
    dec = torch.exp(-gr.lam * gr.dt)[..., None]
    x = h0.expand(B, N, d)
    out1 = _gru_t(_conv_plain(x, gr, wrel[:, :d], loop1, gr.m1, hot),
                  hist1 * dec, g1, hot)
    out2 = _gru_t(_conv_plain(out1, gr, wrel[:, d:], loop2, gr.m2, hot),
                  hist2 * dec, g2, hot)
    if gr.active is None:
        return out2, out1
    return torch.where(gr.active[..., None] > 0, out2, x), out1


def _hilo(x):
    """x as the sum of its bfloat16 rounding and the bfloat16 rounding of
    the rest: about 16 significant bits (the JAX kernel's
    ``_Final._gather_rows`` in bfloat16)."""
    hi = hot_round(x, torch.bfloat16)
    return hi + hot_round(x - hi, torch.bfloat16)


def _loss_side(table, rtab, gr: FinalGraph, hot=None, residual=False):
    """Per direction: (qhat, positive rows, masked scores [B, E, N], the
    positives' scores, lse), and (s_rows, o_rows, remb). In the mode `hot`
    the scores' operands are rounded to it, and the rows are gathered as
    the JAX kernels gather them: the subject, object and relation rows as
    ``_hilo`` parts (K3), or with `residual` (K4) the subject and object
    rows of the table rounded to `hot`, the relation rows as ``_hilo``
    parts."""
    N = table.shape[1]
    bidx = torch.arange(table.shape[0], device=table.device)[:, None]
    src, dst, rel = gr.src.long(), gr.dst.long(), gr.rel.long()
    if hot is not None and residual:
        table = hot_round(table, hot)
    s_rows, o_rows, remb = table[bidx, src], table[bidx, dst], rtab[rel]
    if hot is not None:
        remb = _hilo(remb)
        if not residual:
            s_rows, o_rows = _hilo(s_rows), _hilo(o_rows)
    out = []
    for qhat, pos_rows, q_grp, grp, val in (
            (_qhat_tail(s_rows, remb), o_rows, src * gr.r2 + rel,
             gr.tail_grp, gr.tail_val),
            (_qhat_head(o_rows, remb), s_rows, dst * gr.r2 + rel,
             gr.head_grp, gr.head_val)):
        sc = hot_round(qhat, hot) @ hot_round(table, hot).transpose(1, 2)
        sc = sc.masked_fill(true_answer_mask(grp, val, q_grp, N), _NEG)
        sc_pos = torch.sum(qhat * pos_rows, -1)
        m = torch.maximum(sc.max(-1).values, sc_pos)
        lse = m + torch.log(torch.exp(sc_pos - m)
                            + torch.exp(sc - m[..., None]).sum(-1))
        out.append((qhat, pos_rows, sc, sc_pos, lse))
    return out, (s_rows, o_rows, remb)


def _count(gr: FinalGraph):
    return gr.posm.sum(-1).clamp(min=1.0)


def _loss_plain(table, rtab, gr: FinalGraph, hot=None):
    """Each element's tail+head cross-entropy summed over its positives,
    over their count: [B]."""
    dirs, _ = _loss_side(table, rtab, gr, hot)
    ce = sum(((lse - sc_pos) * gr.posm).sum(-1)
             for _, _, _, sc_pos, lse in dirs)
    return ce / _count(gr)


def fused_final_fwd_plain(h0, hist1, hist2, gr: FinalGraph, wrel, loop1,
                          loop2, g1, g2, rtab, hot=None):
    """Plain version of K3: (loss [B], table [B, N, d], out1 [B, N, d]).
    Arguments as in ``fused_final_fwd``. Differentiable by autograd (in
    float32 that is K4 and K5's plain version; in bfloat16 they round where
    the forward does not: ``FusedFinal`` with ``plain``)."""
    table, out1 = _encoder_plain(h0, hist1, hist2, gr, wrel, loop1, loop2,
                                 g1, g2, hot)
    return _loss_plain(table, rtab, gr, hot), table, out1


def fused_final_bwd_loss_plain(table, rtab, gr: FinalGraph, g, hot=None):
    """Plain version of K4 (``_bwd_loss_kernel``): from the saved table
    [B, N, d] and the cotangent g [B] of each element's loss, (d_table
    [B, N, d], d_rtab [R2, d]). In bfloat16 the table's rows and scores are
    recomputed from the table rounded to bfloat16 and the score, row and
    relation cotangents rounded before their products and sums, as the JAX
    kernel's."""
    B, N, d = table.shape
    w = gr.posm * (g / _count(gr))[:, None]                      # [B, E]
    dirs, (s_rows, o_rows, remb) = _loss_side(table, rtab, gr, hot,
                                              residual=True)
    tb = hot_round(table, hot)
    d_table = torch.zeros_like(table)
    d_s = torch.zeros_like(s_rows)
    d_o = torch.zeros_like(o_rows)
    d_remb = torch.zeros_like(remb)
    for mode, (qhat, pos_rows, sc, sc_pos, lse) in zip(("tail", "head"),
                                                       dirs):
        d_sc = w[..., None] * torch.exp(sc - lse[..., None])  # masked ~ 0
        d_sc_pos = w * (torch.exp(sc_pos - lse) - 1.0)
        d_scr = hot_round(d_sc, hot)
        d_table = d_table + d_scr.transpose(1, 2) @ hot_round(qhat, hot)
        d_qhat = d_scr @ tb + d_sc_pos[..., None] * pos_rows
        d_pos = d_sc_pos[..., None] * qhat
        if mode == "tail":
            ds, dr = _qhat_tail_bwd(d_qhat, s_rows, remb)
            d_s, d_o = d_s + ds, d_o + d_pos
        else:
            do, dr = _qhat_head_bwd(d_qhat, o_rows, remb)
            d_o, d_s = d_o + do, d_s + d_pos
        d_remb = d_remb + dr
    src, dst, _, _ = _flat(gr, N)
    flat = d_table.reshape(B * N, d)
    flat = flat.index_add(0, src, hot_round(d_s, hot).reshape(-1, d))
    flat = flat.index_add(0, dst, hot_round(d_o, hot).reshape(-1, d))
    d_rtab = torch.zeros_like(rtab).index_add_(
        0, gr.rel.reshape(-1).long(), hot_round(d_remb, hot).reshape(-1, d))
    return flat.reshape(B, N, d), d_rtab


def select_bwd(d_table, active):
    """Backward of the ``use_embed_for_non_active`` select: (the cotangent
    of layer 2's output, that of the input rows, or None without the
    select)."""
    if active is None:
        return d_table, None
    a = active[..., None] > 0
    zero = torch.zeros_like(d_table)
    return torch.where(a, d_table, zero), torch.where(a, zero, d_table)


def _bwd_layer_hot(h_in, prev, gr: FinalGraph, mask, wrel, col: int, loop,
                   g, d_out, hot):
    """K5's plain version in the mode `hot`: autograd through the layer's
    forward built of K2's cast points (``hot_mm``, ``spmm_hot_plain``),
    whose backward is the JAX kernel's, as K2b's plain version is. Result
    as ``fused_final_bwd_layer_plain``'s; d_prev in float32."""
    B, N, d = prev.shape
    leaves = [t.detach().to(torch.float32).requires_grad_(True) for t in (
        h_in.expand(B, N, d), prev, wrel, loop, g["wih_t"], g["whh_t"],
        g["bih"], g["bhh"])]
    x, pv, w, lp, wih, whh, bih, bhh = leaves
    dec = torch.exp(-gr.lam * gr.dt)[..., None]
    with torch.enable_grad():
        conv = _conv_plain(x, gr, w[:, col:col + d], lp, mask, hot)
        out = _gru_t(conv, pv * dec, _gru_dict(wih, whh, bih, bhh), hot)
        grads = torch.autograd.grad(out, leaves, d_out)
    return (grads[0], grads[1], grads[2][:, col:col + d]) + grads[3:]


def fused_final_bwd_layer_plain(h_in, prev, gr: FinalGraph, mask, wrel,
                                col: int, loop, g, d_out, hot=None):
    """Plain version of K5 (``_bwd_layer_kernel``) for one layer; arguments
    as in ``fused_final_bwd_layer``. Returns (d_h, d_prev, d_wrel [R, d],
    d_loop, d_wih_t, d_whh_t, d_bih, d_bhh)."""
    if hot is not None:
        return _bwd_layer_hot(h_in, prev, gr, mask, wrel, col, loop, g,
                              d_out, hot)
    B, N, d = prev.shape
    w = wrel[:, col:col + d]
    x = h_in.expand(B, N, d)
    flat = _flat(gr, N)
    # recompute the layer forward
    xf = x.reshape(B * N, d)
    agg = spmm_fwd_plain(xf, *flat, w).reshape(B, N, d)
    lp = x @ loop
    if mask is not None:
        lp = lp * mask
    conv = agg + lp
    dec = torch.exp(-gr.lam * gr.dt)[..., None]
    h0g = prev * dec
    gi = conv @ g["wih_t"] + g["bih"]
    gh = h0g @ g["whh_t"] + g["bhh"]
    r = torch.sigmoid(gi[..., :d] + gh[..., :d])
    z = torch.sigmoid(gi[..., d:2 * d] + gh[..., d:2 * d])
    ghn = gh[..., 2 * d:]
    n = torch.tanh(gi[..., 2 * d:] + r * ghn)
    # GRU backward
    d_z = d_out * (h0g - n)
    d_n = d_out * (1.0 - z)
    d_pre_n = d_n * (1.0 - n * n)
    d_r = d_pre_n * ghn
    d_pre_r = d_r * r * (1.0 - r)
    d_pre_z = d_z * z * (1.0 - z)
    d_gi = torch.cat([d_pre_r, d_pre_z, d_pre_n], -1)
    d_gh = torch.cat([d_pre_r, d_pre_z, d_pre_n * r], -1)
    d_conv = d_gi @ g["wih_t"].t()
    d_h0g = d_out * z + d_gh @ g["whh_t"].t()
    rows = B * N
    d_wih = conv.reshape(rows, d).t() @ d_gi.reshape(rows, 3 * d)
    d_whh = h0g.reshape(rows, d).t() @ d_gh.reshape(rows, 3 * d)
    d_bih = d_gi.reshape(rows, 3 * d).sum(0)
    d_bhh = d_gh.reshape(rows, 3 * d).sum(0)
    # conv backward: the SpMM's transpose and the dropped self-loop
    n2 = _norm2_plain(flat[1], flat[3].to(torch.float32), rows)
    d_h, d_w = spmm_bwd_plain(d_conv.reshape(rows, d), n2, xf, *flat, w)
    d_lp = d_conv if mask is None else d_conv * mask
    d_h = d_h.reshape(B, N, d) + d_lp @ loop.t()
    d_loop = xf.t() @ d_lp.reshape(rows, d)
    return (d_h, d_h0g * dec, d_w, d_loop, d_wih, d_whh, d_bih, d_bhh)


# -- the kernels' wrappers ---------------------------------------------------

def _check(name, tensors: dict, shapes: dict, ints=(), stored=(),
           hot=None):
    """Device, dtype, shape and contiguity of the kernels' operands: int32
    for `ints`, the store dtype (`hot`, or float32) for `stored`, float32
    for the rest."""
    dev = None
    for key, t in tensors.items():
        if t is None:
            continue
        dev = dev or t.device
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, expected {dev}")
        want = (torch.int32 if key in ints else
                hot if hot is not None and key in stored else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, the kernel takes "
                            f"{want}")
        if key in shapes and tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[key])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned (the "
                             f"kernels copy its rows 16 bytes at a time)")


_GRAPH_INTS = ("src", "dst", "rel", "tail_ptr", "tail_ans", "head_ptr",
               "head_ans")


def _check_graph(name, gr: FinalGraph, B, N, E, d):
    shapes = {"src": (B, E), "dst": (B, E), "rel": (B, E), "emf": (B, E),
              "posm": (B, E), "dt": (B, N), "active": (B, N),
              "m1": (B, N, d), "m2": (B, N, d), "tail_ptr": (B, E + 1),
              "head_ptr": (B, E + 1)}
    named = {k: getattr(gr, k) for k in shapes}
    named.update(tail_ans=gr.tail_ans, head_ans=gr.head_ans)
    _check(name, named, shapes, _GRAPH_INTS)
    if d > _MAX_D or d % 16:
        raise ValueError(f"{name}: d = {d}; the kernels take multiples of 16 "
                         f"up to {_MAX_D}")


def _check_weights(name, h0, hist1, hist2, wrel, loop1, loop2, g1, g2, rtab,
                   hot=None):
    B, N, d = hist1.shape
    t = {"h0": h0, "hist1": hist1, "hist2": hist2, "wrel": wrel,
         "loop1": loop1, "loop2": loop2, "rtab": rtab}
    s = {"h0": (N, d), "hist2": (B, N, d), "loop1": (d, d), "loop2": (d, d)}
    for i, g in ((1, g1), (2, g2)):
        for k in ("wih_t", "whh_t", "bih", "bhh"):
            t[f"{k}{i}"] = g[k]
            s[f"{k}{i}"] = (3 * d,) if k.startswith("b") else (d, 3 * d)
    _check(name, t, s, stored=("hist1", "hist2"), hot=hot)
    if wrel.dim() != 2 or wrel.shape[1] != 2 * d:
        raise ValueError(f"{name}: wrel must be [R, 2d]")
    if rtab.dim() != 2 or rtab.shape[1] != d:
        raise ValueError(f"{name}: rtab must be [R2, d]")


def _p(t):
    return None if t is None else t.data_ptr()


def final_csr(gr: FinalGraph, N: int, n_rels: int):
    """CSRs of the B final graphs, masked edges in no row. Over the
    encoder's subsample: by (element, destination) for the forward SpMM, by
    (element, source) with the edge's flat index for its transpose, and by
    relation (row pointer, flat edge index) for the layer's relation
    cotangent. Over the loss's positives: by relation, for the relation
    embeddings' cotangent. n_rels covers both relation ranges."""
    B, E = gr.src.shape
    b = (torch.arange(B, device=gr.src.device, dtype=torch.int32) * N)[:, None]
    keep = gr.emf.reshape(-1) > 0
    eid = torch.arange(B * E, device=gr.src.device, dtype=torch.int32)
    rel = gr.rel.reshape(-1)
    by_dst = build_csr((gr.dst + b).reshape(-1), B * N, gr.src.reshape(-1),
                       rel, gr.emf.reshape(-1), keep=keep)
    by_src = build_csr((gr.src + b).reshape(-1), B * N, gr.dst.reshape(-1),
                       rel, gr.emf.reshape(-1), eid, keep=keep)
    # both CSRs by relation from one sort: the subsample's edges under keys
    # [0, n_rels), the positives' under [n_rels, 2 n_rels); the second
    # row pointer is the tail of the first, into the same edge list
    r_ptr, r_eid = build_csr(
        torch.cat([rel, rel + n_rels]), 2 * n_rels, torch.cat([eid, eid]),
        keep=torch.cat([keep, gr.posm.reshape(-1) > 0]))
    return by_dst, by_src, (r_ptr[:n_rels + 1], r_eid), (r_ptr[n_rels:], r_eid)


def _layer_operands(h0x, loop1, loop2, g1, g2, out1, hot=None) -> tuple:
    """What K3's layer launches (and K11's) read of the layers' inputs and
    weights: (x1, x2, w1, w2), x1 and w1/w2 ``kernel_operands``' (in the
    bfloat16 mode h0x and the weights rounded once), x2 layer 2's input:
    out1 itself in float32, in the bfloat16 mode a buffer that
    ``_layer_launches`` fills with out1 rounded once between the launches
    (the JAX kernel reads layer 2's input only as ``astype(bfloat16)``)."""
    x1, w1, w2 = kernel_operands(h0x, loop1, loop2, g1, g2, hot)
    x2 = out1 if hot is None else torch.empty_like(out1, dtype=hot)
    return x1, x2, w1, w2


def _layer_launches(lib, stream, launched, h0x, hist1, hist2, gr: FinalGraph,
                    by_dst, wrel, ops, g1, g2, out1, table, hot=None):
    """The final step's two encoder layers as two launches of
    ``final_layer_kernel`` (K3's, and K11's encoder): layer 1 into out1,
    layer 2 from out1 into table, with the select (of h0x's rows) where
    gr.active is given; `by_dst` is the SpMM's CSR (``final_csr``'s first);
    `ops` the inputs and weights as the kernels read them
    (``_layer_operands``; g1/g2 give the biases); `launched(err, what)`
    checks and counts each launch; `hot` picks the kernel's mode (bfloat16:
    the histories in bfloat16)."""
    B, N, d = hist1.shape
    rowptr, s_src, s_rel, s_em = by_dst
    x1, x2, w1, w2 = ops
    p = _p
    launch = _lib_fn(lib, "final_layer_launch", hot)

    def layer(x, col, w, m, g, prev, sel, out):
        launched(launch(
            p(x), p(rowptr), p(s_src), p(s_rel), p(s_em), p(wrel), 2 * d,
            col, p(w["loop"]), p(m), p(w["wih_t"]), p(w["whh_t"]),
            p(g["bih"]), p(g["bhh"]), p(gr.dt), float(gr.lam), p(prev),
            p(h0x if sel is not None else None), p(sel), p(out), B, N, d,
            stream), f"layer {1 + col // d}")

    layer(x1, 0, w1, gr.m1, g1, hist1, None, out1)
    if x2 is not out1:
        x2.copy_(out1)
    layer(x2, d, w2, gr.m2, g2, hist2, gr.active, table)


def fused_final_fwd(h0, hist1, hist2, gr: FinalGraph, wrel, loop1, loop2, g1,
                    g2, rtab, hot=None):
    """K3 for B elements. h0 [N, d] the input embeddings; hist1/hist2
    [B, N, d] the densified window states (in the store dtype: float32, or
    `hot`); gr the FinalGraph; wrel [R, 2d] both layers' diagonal relation
    weights side by side; loop1/loop2 [d, d]; g1/g2 GRU weights as dicts of
    wih_t/whh_t [d, 3d] and bih/bhh [3d]; rtab [R2, d] the relation
    embeddings; hot None (float32) or torch.bfloat16 (the bfloat16 mode).

    Returns (loss [B], saved): the mean tail+head cross-entropy over each
    element's positives, and what ``fused_final_bwd_loss`` and
    ``fused_final_bwd_layer`` need (a dict; "table" and "out1" on every
    device)."""
    if _device("fused_final_fwd", hist1) == "cpu":
        loss, table, out1 = fused_final_fwd_plain(h0, hist1, hist2, gr, wrel,
                                                  loop1, loop2, g1, g2, rtab,
                                                  hot)
        return loss, {"table": table, "out1": out1}
    layers, scores, reduce, saved = _fwd_prepare(
        h0, hist1, hist2, gr, wrel, loop1, loop2, g1, g2, rtab, hot)
    layers()
    scores()
    reduce()
    return saved.pop("loss"), saved


def fused_final_fwd_launchers(h0, hist1, hist2, gr: FinalGraph, wrel, loop1,
                              loop2, g1, g2, rtab, hot=None):
    """K3's two layer launches and its score launch apart, on operands
    prepared as ``fused_final_fwd`` prepares them (arguments as there, CUDA
    tensors only): two functions of no arguments, the first making the two
    layer launches, the second the score launch on their output (each
    counted on ``fused_final_fwd.launches``), so that their times can be
    taken apart."""
    if _device("fused_final_fwd", hist1) != "cuda":
        raise ValueError("fused_final_fwd_launchers: K3 runs on a CUDA "
                         "tensor only")
    layers, scores, _, _ = _fwd_prepare(h0, hist1, hist2, gr, wrel, loop1,
                                        loop2, g1, g2, rtab, hot)
    return layers, scores


def _fwd_prepare(h0, hist1, hist2, gr: FinalGraph, wrel, loop1, loop2, g1,
                 g2, rtab, hot=None):
    """K3 on the card: the checked operands, CSRs and outputs, and its
    launches as three functions of no arguments (the two layers, the
    scores, the loss) with the dict they fill (``fused_final_fwd``'s saved
    dict and the loss). In the bfloat16 mode the score launch scores two
    query sets (variant 0 the loss's, variant 1 the backward's), so its
    partials and positive scores have a leading dimension of 2; the saved
    queries, positive scores and log-sum-exps are variant 1's."""
    B, N, d = hist1.shape
    E = gr.src.shape[1]
    _check_weights("fused_final_fwd", h0, hist1, hist2, wrel, loop1, loop2,
                   g1, g2, rtab, hot)
    _check_graph("fused_final_fwd", gr, B, N, E, d)
    dev = hist1.device
    f32 = dict(device=dev, dtype=torch.float32)
    csr = final_csr(gr, N, max(wrel.shape[0], rtab.shape[0]))
    h0x = h0.expand(B, N, d).contiguous()
    out1 = torch.empty(B, N, d, **f32)
    table = torch.empty(B, N, d, **f32)
    ops = _layer_operands(h0x, loop1, loop2, g1, g2, out1, hot)
    variants = () if hot is None else (2,)
    part_m = torch.empty(*variants, B, 2, _N_SPLIT, E, **f32)
    part_s = torch.empty(*variants, B, 2, _N_SPLIT, E, **f32)
    qhat = torch.empty(B, 2, E, d, **f32)
    scpos_all = torch.empty(*variants, B, 2, E, **f32)
    scpos = scpos_all if hot is None else scpos_all[1]
    lse = torch.empty(B, 2, E, **f32)
    cnt = torch.empty(B, **f32)
    loss = torch.empty(B, **f32)
    lib = _build.lib()
    fn = {n: _lib_fn(lib, n, hot) for n in ("final_scores_launch",
                                            "final_loss_reduce_launch")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _p

    def launched(err, what):
        _build.check(err, f"fused_final_fwd ({what})")
        fused_final_fwd.launches += 1

    def layers():
        _layer_launches(lib, stream, launched, h0x, hist1, hist2, gr, csr[0],
                        wrel, ops, g1, g2, out1, table, hot)

    answers = (p(gr.tail_ptr), p(gr.tail_ans), p(gr.head_ptr),
               p(gr.head_ans))

    def scores():
        launched(fn["final_scores_launch"](
            p(table), p(rtab), p(gr.src), p(gr.dst), p(gr.rel), p(gr.posm),
            *answers, p(part_m), p(part_s), p(qhat), p(scpos_all), B, N, E,
            d, _N_SPLIT, stream), "scores")

    def reduce():
        launched(fn["final_loss_reduce_launch"](
            p(part_m), p(part_s), p(scpos_all), p(gr.posm), p(lse), p(cnt),
            p(loss), B, E, _N_SPLIT, stream), "loss")

    return layers, scores, reduce, {
        "loss": loss, "table": table, "out1": out1, "h0x": h0x,
        "qhat": qhat, "scpos": scpos, "lse": lse, "cnt": cnt, "csr": csr}


fused_final_fwd.launches = 0


def fused_final_bwd_loss(saved: dict, rtab, gr: FinalGraph, g, hot=None):
    """K4: (d_table [B, N, d], d_rtab [R2, d]) from ``fused_final_fwd``'s
    saved dict and g [B], the cotangent of each element's loss, in the mode
    `hot` of the forward that saved them."""
    table = saved["table"]
    if _device("fused_final_bwd_loss", table) == "cpu":
        return fused_final_bwd_loss_plain(table, rtab, gr, g, hot)
    B, N, d = table.shape
    E = gr.src.shape[1]
    R2 = rtab.shape[0]
    _check_graph("fused_final_bwd_loss", gr, B, N, E, d)
    _check("fused_final_bwd_loss", {"table": table, "rtab": rtab, "g": g},
           {"g": (B,), "rtab": (R2, d)})
    dev = table.device
    f32 = dict(device=dev, dtype=torch.float32)
    part_dq = torch.empty(B, 2, _N_SPLIT, E, d, **f32)
    d_s = torch.empty(B, E, d, **f32)
    d_o = torch.empty(B, E, d, **f32)
    d_remb = torch.empty(B, E, d, **f32)
    d_table = torch.empty(B, N, d, **f32)
    d_rtab = torch.empty(R2, d, **f32)
    lib = _build.lib()
    fn = {n: _lib_fn(lib, n, hot) for n in (
        "final_dq_launch", "final_dq_finish_launch", "final_dtable_launch")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _p
    qhat, lse, scpos, cnt = (saved[k] for k in ("qhat", "lse", "scpos",
                                                "cnt"))
    answers = (p(gr.tail_ptr), p(gr.tail_ans), p(gr.head_ptr),
               p(gr.head_ans))

    def launched(err, what):
        _build.check(err, f"fused_final_bwd_loss ({what})")
        fused_final_bwd_loss.launches += 1

    # the count and the cotangent: the bfloat16 mode weighs each query's
    # probabilities by its loss weight before rounding them, as the JAX
    # kernel does
    launched(fn["final_dq_launch"](
        p(table), p(qhat), p(lse), p(gr.posm), *answers, p(cnt), p(g),
        p(part_dq), B, N, E, d, _N_SPLIT, stream), "dq")
    launched(fn["final_dq_finish_launch"](
        p(table), p(rtab), p(gr.src), p(gr.dst), p(gr.rel), p(gr.posm),
        p(qhat), p(scpos), p(lse), p(cnt), p(g), p(part_dq), p(d_s), p(d_o),
        p(d_remb), B, N, E, d, _N_SPLIT, stream), "dq finish")
    launched(fn["final_dtable_launch"](
        p(table), p(qhat), p(lse), p(gr.posm), p(cnt), p(g), p(gr.src),
        p(gr.dst), *answers, p(d_s), p(d_o), p(d_table), B, N, E, d, stream),
        "table")
    r_ptr, r_eid = saved["csr"][3]
    if r_ptr.numel() < R2 + 1:
        raise ValueError(f"fused_final_bwd_loss: the saved CSR by relation "
                         f"has {r_ptr.numel() - 1} rows, rtab {R2}")
    launched(lib.final_rel_grad_launch(
        p(r_ptr), p(r_eid), p(d_remb), p(d_rtab), R2, d, stream),
        "relations")
    return d_table, d_rtab


fused_final_bwd_loss.launches = 0


def fused_final_bwd_layer(h_in, prev, gr: FinalGraph, mask, wrel, col: int,
                          loop, g, d_out, csr=None, hot=None):
    """K5: the backward of one encoder layer of the final step. h_in
    [B, N, d] the layer's input (layer 2: the saved out1; layer 1: the input
    embeddings, [N, d] or expanded); prev [B, N, d] its history; mask its
    self-loop dropout mask over keep, or None; wrel [R, 2d] with this
    layer's weights at column `col`; loop [d, d]; g the GRU weights (dict
    of wih_t/whh_t [d, 3d], bih/bhh [3d]); d_out [B, N, d] the cotangent of
    the layer's output; csr ``final_csr(gr, N, R)`` when known; hot None
    (float32) or torch.bfloat16 (the bfloat16 mode: prev in bfloat16).

    Returns (d_h [B, N, d], d_prev [B, N, d], d_wrel [R, d], d_loop [d, d],
    d_wih_t, d_whh_t [d, 3d], d_bih, d_bhh [3d]): cotangents of the inputs,
    the history and the weights (summed over the batch), all float32."""
    if _device("fused_final_bwd_layer", prev) == "cpu":
        return fused_final_bwd_layer_plain(h_in, prev, gr, mask, wrel, col,
                                           loop, g, d_out, hot)
    B, N, d = prev.shape
    E = gr.src.shape[1]
    R = wrel.shape[0]
    x = h_in.expand(B, N, d).contiguous()
    _check_graph("fused_final_bwd_layer", gr, B, N, E, d)
    _check("fused_final_bwd_layer",
           {"h_in": x, "prev": prev, "mask": mask, "wrel": wrel, "loop": loop,
            "d_out": d_out, **g},
           {"mask": (B, N, d), "loop": (d, d), "d_out": (B, N, d),
            "wih_t": (d, 3 * d), "whh_t": (d, 3 * d), "bih": (3 * d,),
            "bhh": (3 * d,), "wrel": (R, 2 * d)}, stored=("prev",), hot=hot)
    if col not in (0, d):
        raise ValueError(f"fused_final_bwd_layer: col = {col}, not 0 or d")
    dev = prev.device
    f32 = dict(device=dev, dtype=torch.float32)
    ((rowptr, s_src, s_rel, s_em), (sp, sp_dst, sp_rel, sp_em, sp_eid),
     (r_ptr, r_eid), _) = final_csr(gr, N, R) if csr is None else csr
    if r_ptr.numel() < R + 1:
        raise ValueError(f"fused_final_bwd_layer: the CSR by relation has "
                         f"{r_ptr.numel() - 1} rows, wrel {R}")
    rows = B * N
    n2 = torch.empty(rows, **f32)
    # the scratch the weight launch reads only rounded: bfloat16 in that mode
    xs = dict(device=dev, dtype=torch.float32 if hot is None else hot)
    scr = {k: torch.empty(rows * (3 * d if k.startswith("dg") else d),
                          **(xs if k in ("conv", "h0g") else f32))
           for k in ("conv", "h0g", "dgi", "dgh", "dconv", "dlp")}
    d_h = torch.empty(B, N, d, **f32)
    d_prev = torch.empty(B, N, d, **f32)
    ewg = torch.empty(B * E, d, **f32)
    d_wrel = torch.empty(R, d, **f32)
    shapes = {"dwih": (d, 3 * d), "dbih": (3 * d,), "dwhh": (d, 3 * d),
              "dbhh": (3 * d,), "dloop": (d, d)}
    sizes = [torch.Size(shapes[n]).numel() for n in _WGRAD_LAYOUT]
    wpart = torch.zeros(_WGRAD_SPLIT, sum(sizes), **f32)
    wsum = torch.empty(sum(sizes), **f32)
    # the layer's input and the weights as the kernels read them: in the
    # bfloat16 mode each rounded once (the JAX kernel reads them only so)
    x = operand(x, hot)
    w = layer_operands(loop, g, hot, bwd=True)
    lib = _build.lib()
    fn = {n: _lib_fn(lib, n, hot) for n in (
        "final_bwd_gru_launch", "final_bwd_input_launch",
        "final_wgrad_launch")}
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _p

    def launched(err, what):
        _build.check(err, f"fused_final_bwd_layer ({what})")
        fused_final_bwd_layer.launches += 1

    launched(fn["final_bwd_gru_launch"](
        p(x), p(rowptr), p(s_src), p(s_rel), p(s_em), p(wrel), 2 * d, col,
        p(w["loop"]), p(mask), p(w["wih_t"]), p(w["whh_t"]), p(g["bih"]),
        p(g["bhh"]), p(w["wih"]), p(w["whh"]), p(gr.dt), float(gr.lam),
        p(prev), p(d_out), p(d_prev), p(n2), p(scr["conv"]), p(scr["h0g"]),
        p(scr["dgi"]), p(scr["dgh"]), p(scr["dconv"]), p(scr["dlp"]), B, N, d,
        stream), "gru")
    launched(fn["final_bwd_input_launch"](
        p(sp), p(sp_dst), p(sp_rel), p(sp_em), p(sp_eid), p(n2),
        p(scr["dconv"]), p(scr["dlp"]), p(wrel), 2 * d, col, p(w["loop_t"]),
        p(x), p(ewg), p(d_h), B, N, d, stream), "input")
    launched(fn["final_wgrad_launch"](
        p(scr["conv"]), p(scr["dgi"]), p(scr["h0g"]), p(scr["dgh"]), p(x),
        p(scr["dlp"]), p(wpart), _WGRAD_SPLIT, B, N, d, stream), "weights")
    launched(lib.final_wgrad_reduce_launch(p(wpart), _WGRAD_SPLIT,
                                           wsum.numel(), p(wsum), stream),
             "weight sum")
    launched(lib.final_rel_grad_launch(
        p(r_ptr), p(r_eid), p(ewg), p(d_wrel), R, d, stream), "relations")
    dw = {n: t.view(shapes[n]) for n, t in
          zip(_WGRAD_LAYOUT, torch.split(wsum, sizes))}
    return (d_h, d_prev, d_wrel, dw["dloop"], dw["dwih"], dw["dwhh"],
            dw["dbih"], dw["dbhh"])


fused_final_bwd_layer.launches = 0


class FusedFinal(torch.autograd.Function):
    """Differentiable K3-K5: ``fused_final_fwd`` forward; backward K4, the
    select's backward, K5 for layer 2, K5 for layer 1, as the JAX package's
    ``_fused_final_bwd``, in the mode `hot`. `gr` (a FinalGraph) takes no
    gradient. With `plain` every part runs its plain version on whatever
    device the tensors lie on (the bfloat16 plain path: autograd through
    the plain forward would not round where the kernels' backward does)."""

    @staticmethod
    def forward(ctx, gr, hot, plain, h0, hist1, hist2, wrel, loop1, loop2,
                wih1, whh1, bih1, bhh1, wih2, whh2, bih2, bhh2, rtab):
        g1 = _gru_dict(wih1, whh1, bih1, bhh1)
        g2 = _gru_dict(wih2, whh2, bih2, bhh2)
        if plain:
            loss, table, out1 = fused_final_fwd_plain(
                h0, hist1, hist2, gr, wrel, loop1, loop2, g1, g2, rtab, hot)
            saved = {"table": table, "out1": out1}
        else:
            loss, saved = fused_final_fwd(h0, hist1, hist2, gr, wrel, loop1,
                                          loop2, g1, g2, rtab, hot)
        ctx.gr, ctx.saved, ctx.hot, ctx.plain = gr, saved, hot, plain
        ctx.save_for_backward(h0, hist1, hist2, wrel, loop1, loop2, wih1,
                              whh1, bih1, bhh1, wih2, whh2, bih2, bhh2, rtab)
        return loss

    @staticmethod
    def backward(ctx, g):
        (h0, hist1, hist2, wrel, loop1, loop2, wih1, whh1, bih1, bhh1, wih2,
         whh2, bih2, bhh2, rtab) = ctx.saved_tensors
        gr, saved, hot = ctx.gr, ctx.saved, ctx.hot
        g1 = _gru_dict(wih1, whh1, bih1, bhh1)
        g2 = _gru_dict(wih2, whh2, bih2, bhh2)
        d = h0.shape[1]
        if ctx.plain:
            d_table, d_rtab = fused_final_bwd_loss_plain(
                saved["table"], rtab, gr, g.contiguous(), hot)
        else:
            d_table, d_rtab = fused_final_bwd_loss(saved, rtab, gr,
                                                   g.contiguous(), hot)
        d_out2, d_h0_sel = select_bwd(d_table, gr.active)
        csr = saved.get("csr")

        def layer(h_in, prev, mask, col, loop, gw, d_out):
            if ctx.plain:
                return fused_final_bwd_layer_plain(h_in, prev, gr, mask, wrel,
                                                   col, loop, gw, d_out, hot)
            return fused_final_bwd_layer(h_in, prev, gr, mask, wrel, col,
                                         loop, gw, d_out, csr, hot)

        (d_out1, d_hist2, d_wrel2, d_loop2, d_wih2, d_whh2, d_bih2,
         d_bhh2) = layer(saved["out1"], hist2, gr.m2, d, loop2, g2, d_out2)
        (d_h0, d_hist1, d_wrel1, d_loop1, d_wih1, d_whh1, d_bih1,
         d_bhh1) = layer(saved.get("h0x", h0), hist1, gr.m1, 0, loop1, g1,
                         d_out1)
        if d_h0_sel is not None:
            d_h0 = d_h0 + d_h0_sel
        # the histories' cotangents come back in their dtype (autograd
        # rounds float32 ones to a bfloat16 history's, as the JAX
        # package's convert does)
        return (None, None, None, d_h0.sum(0), d_hist1, d_hist2,
                torch.cat([d_wrel1, d_wrel2], 1), d_loop1, d_loop2, d_wih1,
                d_whh1, d_bih1, d_bhh1, d_wih2, d_whh2, d_bih2, d_bhh2,
                d_rtab)


def fused_final_supported(cfg, base: str, activation2=None) -> bool:
    """Config-only envelope of K3-K5 (and of their plain versions): the
    JAX package's ``fused_final_supported`` without its VMEM model (plain
    GRRGCN final step, diagonal relation weights, fixed decay, no time
    embedding, ComplEx, negative_pool "all"), with no ReLU on layer 2 (the
    GRRGCN of ``DynamicRGCNModel`` never sets it) and a width the kernels
    take."""
    return (fused_eval_supported(cfg, base, activation2)
            and cfg.negative_pool == "all")


def fused_eval_supported(cfg, base: str, activation2=None) -> bool:
    """Config-only envelope of K11 (and of its plain version): the JAX
    package's ``fused_eval_supported`` without its VMEM bounds (plain GRRGCN
    final step, diagonal relation weights, fixed decay, no time embedding,
    ComplEx), with no ReLU on layer 2 and a width K3's layer launch takes
    (d a multiple of 16, at most 128)."""
    d = cfg.embed_size
    return (base == "GRRGCN"
            and not cfg.rec_only_last_layer
            and not cfg.type1
            and cfg.num_layers == 1
            and not cfg.learnable_lambda
            and not cfg.use_time_embedding
            and cfg.n_bases == d == cfg.hidden_size
            and d % 16 == 0 and d <= _MAX_D
            and cfg.score_function == "complex"
            and not cfg.impute
            and activation2 is None)


def final_graph(data, answers, t_pos, draws, last_pos, lam: float,
                rate: float, length: int, use_noact: bool) -> FinalGraph:
    """The FinalGraph of the targets t_pos [B] (a tensor on the data's
    device): their final snapshots' edges and true-answer lists (`answers`,
    the AnswerLists on that device), the draws of ``draw_train`` ("edges",
    "pos", "fin1", "fin2") and last_pos [B, N] from ``pre_forward``."""
    tp = t_pos.long()
    tr = data.train
    i32 = torch.int32
    keep = 1.0 - rate
    m1, m2 = (None, None) if draws["fin1"] is None else (
        draws["fin1"].to(torch.float32) / keep,
        draws["fin2"].to(torch.float32) / keep)
    return FinalGraph(
        src=tr.src[tp].to(i32).contiguous(),
        dst=tr.dst[tp].to(i32).contiguous(),
        rel=tr.rel[tp].to(i32).contiguous(),
        emf=draws["edges"].to(torch.float32).contiguous(),
        posm=draws["pos"].to(torch.float32).contiguous(),
        dt=((length - 1) - last_pos).to(torch.float32).contiguous(),
        active=(data.active[tp].to(torch.float32).contiguous()
                if use_noact else None),
        m1=m1, m2=m2,
        tail_grp=data.train_tail.grp[tp], tail_val=data.train_tail.val[tp],
        head_grp=data.train_head.grp[tp], head_val=data.train_head.val[tp],
        tail_ptr=answers.tail_ptr[tp].to(i32).contiguous(),
        tail_ans=answers.tail_val.to(i32).contiguous(),
        head_ptr=answers.head_ptr[tp].to(i32).contiguous(),
        head_ans=answers.head_val.to(i32).contiguous(),
        lam=float(lam), r2=2 * data.num_rels)


def final_weights(params):
    """(h0, wrel, loop1, loop2, g1, g2, rtab) of the model's parameters, in
    the kernels' layout (torch's [3d, d] GRU weights transposed)."""
    enc = params["encoder"]
    p1, p2 = enc["layer1"], enc["layer2"]

    def gru(p):
        g = p["gru"][0]
        return _gru_dict(g["w_ih"].t().contiguous(),
                         g["w_hh"].t().contiguous(), g["b_ih"].contiguous(),
                         g["b_hh"].contiguous())

    return (params["ent_embeds"].contiguous(),
            torch.cat([p1["weight"], p2["weight"]], 1).contiguous(),
            p1["loop_weight"].contiguous(), p2["loop_weight"].contiguous(),
            gru(p1), gru(p2), params["rel_embeds"].contiguous())


def fused_final_loss(params, gr: FinalGraph, hist1, hist2,
                     kernels: bool = True, hot=None):
    """The loss of each of the B elements, [B]: K3 with K4/K5 as its
    backward, in the mode `hot` (``kernels=False``: the plain forward,
    differentiated by autograd in float32, and with the plain K4/K5 in
    bfloat16). Mirrors the JAX package's ``fused_final_loss``, batched."""
    h0, wrel, loop1, loop2, g1, g2, rtab = final_weights(params)
    hist1, hist2 = hist1.contiguous(), hist2.contiguous()
    if not kernels and hot is None:
        return fused_final_fwd_plain(h0, hist1, hist2, gr, wrel, loop1,
                                     loop2, g1, g2, rtab)[0]
    return FusedFinal.apply(
        gr, hot, not kernels, h0, hist1, hist2, wrel, loop1, loop2,
        g1["wih_t"], g1["whh_t"], g1["bih"], g1["bhh"], g2["wih_t"],
        g2["whh_t"], g2["bih"], g2["bhh"], rtab)


# -- K11: the fused filtered eval --------------------------------------------

class EvalQueries(NamedTuple):
    """The eval split's query slots of B elements (K11's ranks).

    src/dst/rel [B, Q] int32 and mask [B, Q] float (1 for a real query,
    0 for a padded slot). The true answers of each slot's tail and head
    query from the TOTAL filter tables (the facts of all splits at t): as
    the tables (the plain version; *_grp/*_val [B, F]) and as lists (the
    kernels; *_ptr [B, Q + 1] into *_ans). r2: 2 * num_rels."""

    src: torch.Tensor
    dst: torch.Tensor
    rel: torch.Tensor
    mask: torch.Tensor
    tail_grp: torch.Tensor
    tail_val: torch.Tensor
    head_grp: torch.Tensor
    head_val: torch.Tensor
    tail_ptr: torch.Tensor
    tail_ans: torch.Tensor
    head_ptr: torch.Tensor
    head_ans: torch.Tensor
    r2: int


def final_graph_eval(data, answers, t_pos, last_pos, lam: float, length: int,
                     use_noact: bool, split: str):
    """(FinalGraph, EvalQueries) of the eval targets t_pos [B] (a tensor on
    the data's device): the encoder runs on the final snapshots' train
    edges under their full mask (no subsample, no dropout) with dt =
    (length - 1) - last_pos (last_pos [B, N] from ``pre_forward``) and, with
    `use_noact`, the select's active rows; the fields of the graph that only
    the training loss reads are None. The queries are the slots of `split`
    with their true-answer lists `answers` (``build_answer_lists(data,
    split)`` on that device)."""
    tp = t_pos.long()
    tr, ev = data.train, getattr(data, split)
    i32, f32 = torch.int32, torch.float32
    gr = FinalGraph(
        src=tr.src[tp].to(i32).contiguous(),
        dst=tr.dst[tp].to(i32).contiguous(),
        rel=tr.rel[tp].to(i32).contiguous(),
        emf=tr.emask[tp].to(f32).contiguous(), posm=None,
        dt=((length - 1) - last_pos).to(f32).contiguous(),
        active=(data.active[tp].to(f32).contiguous() if use_noact
                else None),
        m1=None, m2=None, tail_grp=None, tail_val=None, head_grp=None,
        head_val=None, tail_ptr=None, tail_ans=None, head_ptr=None,
        head_ans=None, lam=float(lam), r2=2 * data.num_rels)
    q = EvalQueries(
        src=ev.src[tp].to(i32).contiguous(),
        dst=ev.dst[tp].to(i32).contiguous(),
        rel=ev.rel[tp].to(i32).contiguous(),
        mask=ev.emask[tp].to(f32).contiguous(),
        tail_grp=data.total_tail.grp[tp], tail_val=data.total_tail.val[tp],
        head_grp=data.total_head.grp[tp], head_val=data.total_head.val[tp],
        tail_ptr=answers.tail_ptr[tp].to(i32).contiguous(),
        tail_ans=answers.tail_val.to(i32).contiguous(),
        head_ptr=answers.head_ptr[tp].to(i32).contiguous(),
        head_ans=answers.head_val.to(i32).contiguous(),
        r2=2 * data.num_rels)
    return gr, q


def table_ranks_plain(table, rtab, q: EvalQueries):
    """Plain version of K11's ranking half: the port's ``eval_ranks_single``
    batched over B. From the table [B, N, d] and the relation embeddings
    rtab [R2, d]: (ranks [B, 2Q] int32 in the [head, tail] layout, mask
    [B, 2Q] bool, bce [B])."""
    bidx = torch.arange(table.shape[0], device=table.device)[:, None]
    src, dst, rel = q.src.long(), q.dst.long(), q.rel.long()
    s_rows, o_rows, remb = table[bidx, src], table[bidx, dst], rtab[rel]
    ranks_tail = filtered_ranks(complex_all(s_rows, remb, table, "tail"), dst,
                                q.tail_grp, q.tail_val, src * q.r2 + rel)
    ranks_head = filtered_ranks(complex_all(o_rows, remb, table, "head"), src,
                                q.head_grp, q.head_val, dst * q.r2 + rel)
    m = (q.mask > 0).to(table.dtype)
    sp = torch.nn.functional.softplus(-complex_single(s_rows, remb, o_rows))
    bce = (sp * m).sum(-1) / m.sum(-1).clamp(min=1.0)
    mask = q.mask > 0
    return (torch.cat([ranks_head, ranks_tail], -1),
            torch.cat([mask, mask], -1), bce)


def fused_eval_ranks_plain(h0, hist1, hist2, gr: FinalGraph, q: EvalQueries,
                           wrel, loop1, loop2, g1, g2, rtab, hot=None):
    """Plain version of K11: ``_encoder_plain`` in eval mode (in the mode
    `hot`), then ``table_ranks_plain`` in float32. Arguments and result as
    in ``fused_eval_ranks``."""
    table, _ = _encoder_plain(h0, hist1, hist2, gr, wrel, loop1, loop2, g1,
                              g2, hot)
    return table_ranks_plain(table, rtab, q)


def _check_queries(name, q: EvalQueries, B, Q):
    shapes = {"src": (B, Q), "dst": (B, Q), "rel": (B, Q), "mask": (B, Q),
              "tail_ptr": (B, Q + 1), "head_ptr": (B, Q + 1)}
    named = {k: getattr(q, k) for k in shapes}
    named.update(tail_ans=q.tail_ans, head_ans=q.head_ans)
    _check(name, named, shapes, _GRAPH_INTS)


def table_ranks(table, rtab, q: EvalQueries):
    """K11's ranking half, from the table [B, N, d]: the rank and reduce
    launches, counted on ``fused_eval_ranks`` (on a CPU tensor the plain
    version). Result as in ``fused_eval_ranks``."""
    if _device("table_ranks", table) == "cpu":
        return table_ranks_plain(table, rtab, q)
    ranks, reduce, out = _ranks_prepare(table, rtab, q)
    ranks()
    reduce()
    return out


def _ranks_prepare(table, rtab, q: EvalQueries):
    """K11's ranking half on the card: the checked operands and outputs,
    and its launches as two functions of no arguments (the rank launch,
    the reduction) with the result they fill."""
    B, N, d = table.shape
    Q = q.src.shape[1]
    _check_queries("table_ranks", q, B, Q)
    _check("table_ranks", {"table": table, "rtab": rtab},
           {"rtab": (rtab.shape[0], d)})
    if rtab.dim() != 2 or d > _MAX_D or d % 16:
        raise ValueError(f"table_ranks: rtab must be [R2, d] and d a "
                         f"multiple of 16 up to {_MAX_D}, d = {d}")
    dev = table.device
    part = torch.empty(B, 2, _N_SPLIT, Q, device=dev, dtype=torch.int32)
    tgt = torch.empty(B, Q, device=dev, dtype=torch.float32)
    ranks = torch.empty(B, 2 * Q, device=dev, dtype=torch.int32)
    bce = torch.empty(B, device=dev, dtype=torch.float32)
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _p

    def rank():
        _build.check(lib.final_ranks_launch(
            p(table), p(rtab), p(q.src), p(q.dst), p(q.rel), p(q.mask),
            p(q.tail_ptr), p(q.tail_ans), p(q.head_ptr), p(q.head_ans),
            p(part), p(tgt), B, N, Q, d, _N_SPLIT, stream),
            "fused_eval_ranks (ranks)")
        fused_eval_ranks.launches += 1

    def reduce():
        _build.check(lib.final_rank_reduce_launch(
            p(part), p(tgt), p(q.mask), p(ranks), p(bce), B, Q, _N_SPLIT,
            stream), "fused_eval_ranks (reduce)")
        fused_eval_ranks.launches += 1

    mask = q.mask > 0
    return rank, reduce, (ranks, torch.cat([mask, mask], -1), bce)


def fused_eval_ranks(h0, hist1, hist2, gr: FinalGraph, q: EvalQueries, wrel,
                     loop1, loop2, g1, g2, rtab, hot=None):
    """K11 for B elements: what the JAX package's ``fused_eval_ranks``
    returns for each. h0 [N, d], hist1/hist2 [B, N, d] (in the store
    dtype: float32, or `hot`), gr the eval graph and q the queries of
    ``final_graph_eval``, the weights as ``final_weights`` gives them; hot
    None (float32) or torch.bfloat16 (the bfloat16 mode).

    Returns (ranks [B, 2Q] int32, the filtered ranks of every query slot in
    the [head, tail] layout, 1 at a padded slot; mask [B, 2Q] bool, the real
    queries; bce [B], each element's mean BCE of its positives). On a CPU
    tensor the plain version; on a CUDA tensor K3's two layer launches and
    ``table_ranks``' two, four in all."""
    if _device("fused_eval_ranks", hist1) == "cpu":
        return fused_eval_ranks_plain(h0, hist1, hist2, gr, q, wrel, loop1,
                                      loop2, g1, g2, rtab, hot)
    layers, rank, reduce, out, _ = _eval_prepare(
        h0, hist1, hist2, gr, q, wrel, loop1, loop2, g1, g2, rtab, hot)
    layers()
    rank()
    reduce()
    return out


def fused_eval_ranks_launchers(h0, hist1, hist2, gr: FinalGraph,
                               q: EvalQueries, wrel, loop1, loop2, g1, g2,
                               rtab, hot=None):
    """K11's two layer launches and its rank launch apart, on operands
    prepared as ``fused_eval_ranks`` prepares them (arguments as there, CUDA
    tensors only): two functions of no arguments, the first making the two
    layer launches, the second the rank launch on their output (each
    counted on ``fused_eval_ranks.launches``), so that their times can be
    taken apart, and the table [B, N, d] the layer launches write."""
    if _device("fused_eval_ranks", hist1) != "cuda":
        raise ValueError("fused_eval_ranks_launchers: K11 runs on a CUDA "
                         "tensor only")
    layers, rank, _, _, table = _eval_prepare(h0, hist1, hist2, gr, q, wrel,
                                              loop1, loop2, g1, g2, rtab, hot)
    return layers, rank, table


def _eval_prepare(h0, hist1, hist2, gr: FinalGraph, q: EvalQueries, wrel,
                  loop1, loop2, g1, g2, rtab, hot=None):
    """K11 on the card: the checked operands, the CSR and the outputs, and
    its launches as three functions of no arguments (the two layers, in
    the mode `hot`; the ranks; the reduction) with the result they fill,
    and the table the layers write."""
    B, N, d = hist1.shape
    E = gr.src.shape[1]
    _check_weights("fused_eval_ranks", h0, hist1, hist2, wrel, loop1, loop2,
                   g1, g2, rtab, hot)
    _check("fused_eval_ranks",
           {k: getattr(gr, k) for k in ("src", "dst", "rel", "emf", "dt",
                                        "active")},
           {"src": (B, E), "dst": (B, E), "rel": (B, E), "emf": (B, E),
            "dt": (B, N), "active": (B, N)}, _GRAPH_INTS)
    if d > _MAX_D or d % 16 or gr.m1 is not None or gr.m2 is not None:
        raise ValueError(f"fused_eval_ranks: d = {d} (the kernels take "
                         f"multiples of 16 up to {_MAX_D}) or dropout masks "
                         f"given (eval has none)")
    dev = hist1.device
    nb = (torch.arange(B, device=dev, dtype=torch.int32) * N)[:, None]
    by_dst = build_csr((gr.dst + nb).reshape(-1), B * N, gr.src.reshape(-1),
                       gr.rel.reshape(-1), gr.emf.reshape(-1),
                       keep=gr.emf.reshape(-1) > 0)
    h0x = h0.expand(B, N, d).contiguous()
    out1 = torch.empty(B, N, d, device=dev, dtype=torch.float32)
    table = torch.empty(B, N, d, device=dev, dtype=torch.float32)
    ops = _layer_operands(h0x, loop1, loop2, g1, g2, out1, hot)
    rank, reduce, out = _ranks_prepare(table, rtab, q)
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launched(err, what):
        _build.check(err, f"fused_eval_ranks ({what})")
        fused_eval_ranks.launches += 1

    def layers():
        _layer_launches(lib, stream, launched, h0x, hist1, hist2, gr, by_dst,
                        wrel, ops, g1, g2, out1, table, hot)

    return layers, rank, reduce, out, table


fused_eval_ranks.launches = 0
