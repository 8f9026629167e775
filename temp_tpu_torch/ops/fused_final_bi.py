"""The flagship's final step and loss (BiGRRGCN with imputation): kernels
K6-K10, with K4 reused.

For a batch of B target snapshots, ``fused_final_bi_fwd`` computes what the
JAX package's ``fused_final_bi_loss`` returns for each element: layer 1 over
all N entities (the relational SpMM over the encoder's edge subsample plus
the dropped self-loop, then GRU_f and GRU_b from the decayed histories of
the two windows, summed), layer 2 over layer 1's output (the same with a
ReLU on its conv output and, on the snapshot's inactive rows, the impute
blend of the conv output with both windows' local rows feeding the GRUs),
the optional ``use_embed_for_non_active`` select, and the exact-softmax
tail+head cross-entropy over the positives from that table.

- ``bi_layer_fwd`` (K6+K7): one layer, the edge part and the row part in
  one launch (the TPU's two programs per layer were a VMEM artefact);
- ``bi_loss_fwd`` (K8): the loss from the table, on K3's score and
  reduction launches; it saves what ``fused_final_bwd_loss`` (K4) reads;
- ``bi_layer_bwd`` (K9+K10): one layer's backward, giving the cotangents of
  its input, both histories, both local tables, the four impute scalars,
  the relation and self-loop weights and both GRUs' weights.

``bi_relu_pattern`` gives the ReLU's pattern that K9+K10 take from their
recomputed conv output, for holding them to their plain version
(``bi_layer_bwd_plain``'s `relu_mask`); ``bi_bwd_gru_launcher`` their GRU
launch alone, for timing it; ``bi_gru_input`` the GRU input that K6+K7
form (the conv output after the ReLU and the blend), for holding it to
K9+K10's recompute.

``FusedFinalBi`` is the autograd function made of them: K4, the select's
backward, the layer-2 backward, the layer-1 backward, as the JAX package's
``_fused_final_bi_bwd``. On a CPU tensor each wrapper runs its plain
version: the forward in plain PyTorch (differentiable by autograd), the
backward as the JAX kernels' own formulas in PyTorch. On a CUDA tensor it
launches the hand-written kernels (``csrc/fused_final_bi.cu``, and K3-K5's
launches in ``csrc/fused_final.cu``) or raises: ``bi_layer_fwd`` one launch,
``bi_loss_fwd`` two, ``bi_layer_bwd`` five.

``hot=torch.bfloat16`` is the JAX kernels' bfloat16 instantiation of
K6-K10: the edge part and the GRUs' products as K2's bfloat16 mode
(``ops/fused_window`` ``hot_mm``, ``spmm_hot_plain``), both windows'
histories and local tables read from bfloat16 (K2's buffers), the blend,
the decay and the impute terms in float32, the layer's output and its
table in float32 (the TPU programs' outputs are); K8 is K3's bfloat16 loss
(``ops/fused_final`` ``_loss_plain``) and K4 its bfloat16 mode on the bi
table. The backward's plain version in bfloat16 is autograd through the
forward built of those cast points, whose backward is the JAX kernels'.
On the card the same launches of the kernels in their bfloat16 mode
(``csrc/fused_final_bi_bf16.cu``, ``csrc/fused_final_bf16.cu``), the same
number of launches; K6+K7's and K9+K10's are native bfloat16 kernels on
K2b's routines, to which the wrappers hand the layer's input and the
weights rounded once (``ops/fused_window`` ``operand``, ``gru_operands``),
so K9+K10 recompute the GRU input and the gates of K6+K7 bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from temp_tpu_torch import _build
from temp_tpu_torch.ops.fused_final import (
    _N_SPLIT, _WGRAD_SPLIT, FinalGraph, _check, _check_graph, _conv_plain,
    _device, _flat, _gru_dict, _loss_plain, _p, final_csr, final_graph,
    fused_final_bwd_loss, fused_final_bwd_loss_plain, select_bwd,
)
from temp_tpu_torch.ops.fused_window import (
    _gru_t, _lib_fn, gru_operands, operand,
)
from temp_tpu_torch.ops.spmm import _norm2_plain, spmm_bwd_plain

_MAX_D = 128   # the layer tiles run d / 16 warps, two blocks an SM
_GRUS = ("1f", "1b", "2f", "2b")   # layer and direction
_GRU_PARTS = ("wih_t", "whh_t", "bih", "bhh")
# the layer backward's weight cotangents as its weight launch lays them out
_WGRAD_LAYOUT = ("dwih_f", "dbih_f", "dwhh_f", "dbhh_f", "dwih_b", "dbih_b",
                 "dwhh_b", "dbhh_b", "dloop", "dimp")


class BiGraph(NamedTuple):
    """The flagship's final-step inputs that take no gradient: ``gr`` as for
    K3-K5, its ``dt`` the forward window's steps since each entity's last
    state and its ``active`` [B, N] float always set (the impute blend's
    mask); ``dt_b`` [B, N] the backward window's; ``act2`` the ReLU on layer
    2's conv output; ``noact`` the ``use_embed_for_non_active`` select."""

    gr: FinalGraph
    dt_b: torch.Tensor
    act2: bool
    noact: bool


def final_graph_bi(data, answers, t_pos, draws, lp_f, lp_b, lam: float,
                   rate: float, length: int, act2: bool,
                   noact: bool) -> BiGraph:
    """The BiGraph of the targets t_pos [B]: ``final_graph`` with the
    forward window's last positions lp_f, and the backward window's lp_b
    [B, N]."""
    gr = final_graph(data, answers, t_pos, draws, lp_f, lam, rate, length,
                     True)
    dt_b = ((length - 1) - lp_b).to(torch.float32).contiguous()
    return BiGraph(gr=gr, dt_b=dt_b, act2=bool(act2), noact=bool(noact))


def bi_weights(params):
    """(h0, wrel [R, 2d], loop1, loop2, grus, rtab, imp [4]) of the
    flagship's parameters in the kernels' layout: grus maps "1f", "1b",
    "2f", "2b" (layer, direction) to the GRU weights transposed; imp is
    (impute_w_fwd, impute_b_fwd, impute_w_bwd, impute_b_bwd)."""
    enc = params["encoder"]
    p1, p2 = enc["layer1"], enc["layer2"]

    def gru(p, key):
        g = p[key][0]
        return _gru_dict(g["w_ih"].t().contiguous(),
                         g["w_hh"].t().contiguous(), g["b_ih"].contiguous(),
                         g["b_hh"].contiguous())

    grus = {"1f": gru(p1, "gru_fwd"), "1b": gru(p1, "gru_bwd"),
            "2f": gru(p2, "gru_fwd"), "2b": gru(p2, "gru_bwd")}
    imp = torch.stack([enc["impute_w_fwd"], enc["impute_b_fwd"],
                       enc["impute_w_bwd"], enc["impute_b_bwd"]])
    return (params["ent_embeds"].contiguous(),
            torch.cat([p1["weight"], p2["weight"]], 1).contiguous(),
            p1["loop_weight"].contiguous(), p2["loop_weight"].contiguous(),
            grus, params["rel_embeds"].contiguous(),
            imp.to(torch.float32).contiguous())


# -- plain versions ----------------------------------------------------------

def _decay(lam: float, dt):
    return torch.exp(-lam * dt)[..., None]


def _impute_w(imp, i: int, dt):
    """exp(-max(imp[i] * dt + imp[i + 1], 0)) / 2, [B, N, 1]."""
    return torch.exp(-torch.relu(imp[i] * dt + imp[i + 1]))[..., None] * 0.5


def _rows_plain(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int, loop,
                relu: bool, hl, imp, hot=None, relu_mask=None):
    """One layer's conv output (after the ReLU), GRU input (after the
    blend) and both decayed previous states, each [B, N, d] in float32 (the
    histories and local rows in any float dtype); the conv in the mode
    `hot`. relu_mask [B, N, d] (1 where it passes), when given, stands for
    the ReLU's pattern in the derivative (the value is the ReLU's)."""
    gr = bg.gr
    B, N, d = prev_f.shape
    conv = _conv_plain(x.expand(B, N, d), gr, wrel[:, col:col + d], loop,
                       mask, hot)
    if relu:
        r = torch.relu(conv)
        if relu_mask is not None:
            r = conv * relu_mask + (r - conv * relu_mask).detach()
        conv = r
    gin = conv
    if hl is not None:
        wf, wb = _impute_w(imp, 0, gr.dt), _impute_w(imp, 2, bg.dt_b)
        blended = wf * hl[0] + wb * hl[1] + (1.0 - wf - wb) * conv
        gin = torch.where(gr.active[..., None] > 0, conv, blended)
    return (conv, gin, prev_f * _decay(gr.lam, gr.dt),
            prev_b * _decay(gr.lam, bg.dt_b))


def bi_layer_fwd_plain(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int,
                       loop, gf, gb, relu: bool = False, hl=None, imp=None,
                       sel=None, hot=None):
    """Plain version of K6+K7 for one layer; arguments as in
    ``bi_layer_fwd``. Differentiable by autograd (in bfloat16 that is
    K9+K10's plain version: ``bi_layer_bwd_plain``)."""
    _, gin, h0f, h0b = _rows_plain(x, prev_f, prev_b, bg, mask, wrel, col,
                                   loop, relu, hl, imp, hot)
    out = _gru_t(gin, h0f, gf, hot) + _gru_t(gin, h0b, gb, hot)
    if sel is not None:
        out = torch.where(bg.gr.active[..., None] > 0, out,
                          sel.expand_as(out))
    return out


def fused_final_bi_fwd_plain(h0, hists, bg: BiGraph, wrel, loop1, loop2,
                             grus, rtab, imp, hot=None):
    """Plain version of the flagship's final step and loss: (loss [B],
    table [B, N, d], out1 [B, N, d]); arguments as in
    ``fused_final_bi_fwd``. Differentiable by autograd (in float32 that is
    K4 and K9+K10's plain version; in bfloat16 they round where the
    forward does not: ``FusedFinalBi`` with ``plain``)."""
    h1f, h2f, hlf, h1b, h2b, hlb = hists
    gr, d = bg.gr, h0.shape[1]
    out1 = bi_layer_fwd_plain(h0, h1f, h1b, bg, gr.m1, wrel, 0, loop1,
                              grus["1f"], grus["1b"], hot=hot)
    table = bi_layer_fwd_plain(out1, h2f, h2b, bg, gr.m2, wrel, d, loop2,
                               grus["2f"], grus["2b"], relu=bg.act2,
                               hl=(hlf, hlb), imp=imp,
                               sel=h0 if bg.noact else None, hot=hot)
    return _loss_plain(table, rtab, gr, hot), table, out1


def _gru_bwd_plain(d_out, x, h0g, g):
    """Backward through one GRU cell (torch gate order): (d_x, d_h0g,
    (d_wih_t, d_whh_t, d_bih, d_bhh)), the weights' summed over all rows."""
    d = h0g.shape[-1]
    gi = x @ g["wih_t"] + g["bih"]
    gh = h0g @ g["whh_t"] + g["bhh"]
    r = torch.sigmoid(gi[..., :d] + gh[..., :d])
    z = torch.sigmoid(gi[..., d:2 * d] + gh[..., d:2 * d])
    ghn = gh[..., 2 * d:]
    n = torch.tanh(gi[..., 2 * d:] + r * ghn)
    d_pre_n = d_out * (1.0 - z) * (1.0 - n * n)
    d_pre_r = d_pre_n * ghn * r * (1.0 - r)
    d_pre_z = d_out * (h0g - n) * z * (1.0 - z)
    d_gi = torch.cat([d_pre_r, d_pre_z, d_pre_n], -1)
    d_gh = torch.cat([d_pre_r, d_pre_z, d_pre_n * r], -1)
    rows = x.numel() // d
    grads = (x.reshape(rows, d).t() @ d_gi.reshape(rows, 3 * d),
             h0g.reshape(rows, d).t() @ d_gh.reshape(rows, 3 * d),
             d_gi.reshape(rows, 3 * d).sum(0),
             d_gh.reshape(rows, 3 * d).sum(0))
    return d_gi @ g["wih_t"].t(), d_out * z + d_gh @ g["whh_t"].t(), grads


def _bi_layer_bwd_hot(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int,
                      loop, gf, gb, d_out, relu, hl, imp, relu_mask, hot):
    """K9+K10's plain version in the mode `hot`: autograd through the
    layer's forward built of K2's cast points (``hot_mm``,
    ``spmm_hot_plain``), whose backward is the JAX kernels', as K5's
    (``ops/fused_final`` ``_bwd_layer_hot``). Result as
    ``bi_layer_bwd_plain``'s, every cotangent float32."""
    B, N, d = prev_f.shape

    def leaf(t):
        return (None if t is None
                else t.detach().to(torch.float32).requires_grad_(True))

    xx, pf, pb, w, lw, ip = (leaf(t) for t in (
        x.expand(B, N, d), prev_f, prev_b, wrel, loop, imp))
    hf, hb = (None, None) if hl is None else (leaf(hl[0]), leaf(hl[1]))
    g = [{k: leaf(q[k]) for k in _GRU_PARTS} for q in (gf, gb)]
    leaves = [xx, pf, pb, hf, hb, ip, w, lw] + [q[k] for q in g
                                                for k in _GRU_PARTS]
    used = [t for t in leaves if t is not None]
    with torch.enable_grad():
        _, gin, h0f, h0b = _rows_plain(
            xx, pf, pb, bg, mask, w, col, lw, relu,
            None if hl is None else (hf, hb), ip, hot, relu_mask)
        out = _gru_t(gin, h0f, g[0], hot) + _gru_t(gin, h0b, g[1], hot)
        grads = iter(torch.autograd.grad(out, used, d_out,
                                         allow_unused=True))
    res = []
    for t in leaves:
        q = None if t is None else next(grads)
        res.append(torch.zeros_like(t) if t is not None and q is None else q)
    res[6] = res[6][:, col:col + d]
    return tuple(res)


def bi_layer_bwd_plain(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int,
                       loop, gf, gb, d_out, relu: bool = False, hl=None,
                       imp=None, relu_mask=None, hot=None):
    """Plain version of K9+K10 (the JAX package's ``_gru_bwd_bi_kernel``
    and ``_conv_bwd_bi_kernel``) for one layer; arguments and result as in
    ``bi_layer_bwd``. relu_mask [B, N, d], when given, stands for the
    ReLU's pattern (``bi_relu_pattern``: the kernels', whose conv output
    differs from this one by rounding). In bfloat16 (`hot`) autograd
    through the plain forward (``_bi_layer_bwd_hot``)."""
    if hot is not None:
        return _bi_layer_bwd_hot(x, prev_f, prev_b, bg, mask, wrel, col, loop,
                                 gf, gb, d_out, relu, hl, imp, relu_mask, hot)
    gr = bg.gr
    B, N, d = prev_f.shape
    conv, gin, h0f, h0b = _rows_plain(x, prev_f, prev_b, bg, mask, wrel, col,
                                      loop, relu, hl, imp)
    dx_f, dh0f, grads_f = _gru_bwd_plain(d_out, gin, h0f, gf)
    dx_b, dh0b, grads_b = _gru_bwd_plain(d_out, gin, h0b, gb)
    d_gin = dx_f + dx_b
    d_hlf = d_hlb = d_imp = None
    if hl is not None:
        act = gr.active[..., None] > 0
        wf, wb = _impute_w(imp, 0, gr.dt), _impute_w(imp, 2, bg.dt_b)
        d_blend = torch.where(act, torch.zeros_like(d_gin), d_gin)
        d_conv = torch.where(act, d_gin, (1.0 - wf - wb) * d_gin)
        d_hlf, d_hlb = wf * d_blend, wb * d_blend
        # w_dir = exp(-max(a, 0)) / 2, so dw/da = -w where a > 0
        a_f = imp[0] * gr.dt + imp[1]
        a_b = imp[2] * bg.dt_b + imp[3]
        d_af = -wf[..., 0] * (a_f > 0) * (d_blend * (hl[0] - conv)).sum(-1)
        d_ab = -wb[..., 0] * (a_b > 0) * (d_blend * (hl[1] - conv)).sum(-1)
        d_imp = torch.stack([(d_af * gr.dt).sum(), d_af.sum(),
                             (d_ab * bg.dt_b).sum(), d_ab.sum()])
    else:
        d_conv = d_gin
    if relu:
        d_conv = d_conv * ((conv > 0) if relu_mask is None else relu_mask)
    # the edge part: the SpMM's transpose and the dropped self-loop
    rows = B * N
    xf = x.expand(B, N, d).reshape(rows, d)
    flat = _flat(gr, N)
    n2 = _norm2_plain(flat[1], flat[3].to(torch.float32), rows)
    d_h, d_w = spmm_bwd_plain(d_conv.reshape(rows, d), n2, xf, *flat,
                              wrel[:, col:col + d])
    d_lp = d_conv if mask is None else d_conv * mask
    d_h = d_h.reshape(B, N, d) + d_lp @ loop.t()
    d_loop = xf.t() @ d_lp.reshape(rows, d)
    return ((d_h, dh0f * _decay(gr.lam, gr.dt),
             dh0b * _decay(gr.lam, bg.dt_b), d_hlf, d_hlb, d_imp, d_w,
             d_loop) + grads_f + grads_b)


# -- the kernels' wrappers ---------------------------------------------------

def _expand(name, x, B: int, N: int, d: int):
    """x [N, d] or [B, N, d] as a contiguous [B, N, d]."""
    if x is None:
        return None
    if tuple(x.shape) not in ((N, d), (B, N, d)):
        raise ValueError(f"{name}: rows of shape {tuple(x.shape)}, expected "
                         f"{(B, N, d)} or {(N, d)}")
    return x.expand(B, N, d).contiguous()


def _check_layer(name, bg: BiGraph, x, prev_f, prev_b, mask, wrel, loop, gf,
                 gb, hl, imp, more=None, hot=None):
    """Device, dtype, shape and contiguity of one layer's operands: both
    histories and local tables in the store dtype (`hot`, or float32)."""
    B, N, d = prev_f.shape
    E = bg.gr.src.shape[1]
    _check_graph(name, bg.gr, B, N, E, d)
    if bg.gr.active is None:
        raise ValueError(f"{name}: the graph's active mask is not set")
    if d > _MAX_D:
        raise ValueError(f"{name}: d = {d} > {_MAX_D}")
    if (hl is None) != (imp is None):
        raise ValueError(f"{name}: the impute blend needs both hl and imp")
    if wrel.dim() != 2 or wrel.shape[1] != 2 * d:
        raise ValueError(f"{name}: wrel must be [R, 2d]")
    act = (B, N, d)
    t = {"x": x, "prev_f": prev_f, "prev_b": prev_b, "mask": mask,
         "wrel": wrel, "loop": loop, "dt_b": bg.dt_b, "imp": imp,
         "hl_f": None if hl is None else hl[0],
         "hl_b": None if hl is None else hl[1], **(more or {})}
    s = {"x": act, "prev_f": act, "prev_b": act, "mask": act, "loop": (d, d),
         "dt_b": (B, N), "imp": (4,), "hl_f": act, "hl_b": act,
         "d_out": act, "sel": act}
    for tag, g in (("f", gf), ("b", gb)):
        for k in _GRU_PARTS:
            t[f"{k}_{tag}"] = g[k]
            s[f"{k}_{tag}"] = (3 * d,) if k.startswith("b") else (d, 3 * d)
    _check(name, t, s, stored=("prev_f", "prev_b", "hl_f", "hl_b"), hot=hot)


def bi_layer_fwd(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int, loop,
                 gf, gb, relu: bool = False, hl=None, imp=None, sel=None,
                 csr=None, hot=None):
    """K6+K7: one layer of the flagship's final step for B elements.

    x [B, N, d] (or [N, d], expanded) the layer's input; prev_f/prev_b
    [B, N, d] the two windows' histories of this layer; mask [B, N, d] its
    self-loop dropout mask over keep, or None; wrel [R, 2d] with this
    layer's relation weights at column `col`; loop [d, d]; gf/gb the GRU
    weights of the two directions (dicts of wih_t/whh_t [d, 3d], bih/bhh
    [3d]); `relu` the ReLU on the conv output; hl (hl_f, hl_b) [B, N, d]
    the windows' local rows and imp [4] the impute scalars, for the blend
    on inactive rows (None: no blend); sel [B, N, d] (or [N, d]) the rows
    the select keeps on inactive rows, or None; csr ``final_csr`` when
    known; hot None (float32) or torch.bfloat16 (the bfloat16 mode: the
    histories and local rows in bfloat16). Returns the layer's output
    [B, N, d], float32."""
    if _device("bi_layer_fwd", prev_f) == "cpu":
        return bi_layer_fwd_plain(x, prev_f, prev_b, bg, mask, wrel, col,
                                  loop, gf, gb, relu, hl, imp, sel, hot)
    return _bi_layer_launch(x, prev_f, prev_b, bg, mask, wrel, col, loop, gf,
                            gb, relu, hl, imp, sel, csr, None, hot)


def _bi_layer_launch(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int,
                     loop, gf, gb, relu: bool, hl, imp, sel, csr, gin,
                     hot=None):
    """K6+K7's one launch on the card (arguments as ``bi_layer_fwd``),
    counted on ``bi_layer_fwd.launches``; with `gin` [B, N, d] the launch
    also writes the GRU input there. Returns the layer's output."""
    gr = bg.gr
    B, N, d = prev_f.shape
    xx = _expand("bi_layer_fwd", x, B, N, d)
    sel_x = _expand("bi_layer_fwd", sel, B, N, d)
    _check_layer("bi_layer_fwd", bg, xx, prev_f, prev_b, mask, wrel, loop,
                 gf, gb, hl, imp, {"sel": sel_x}, hot)
    if col not in (0, d):
        raise ValueError(f"bi_layer_fwd: col = {col}, not 0 or d")
    (rowptr, s_src, s_rel, s_em), _, _, _ = (
        final_csr(gr, N, wrel.shape[0]) if csr is None else csr)
    out = torch.empty(B, N, d, device=prev_f.device, dtype=torch.float32)
    hl_f, hl_b = (None, None) if hl is None else hl
    # the layer's input and the weights as the kernel reads them: in the
    # bfloat16 mode each rounded once (the JAX kernels read them only so)
    xk, loopk = operand(xx, hot), operand(loop, hot)
    wf, wb = gru_operands(gf, hot), gru_operands(gb, hot)
    p = _p
    err = _lib_fn(_build.lib(), "bi_layer_launch", hot)(
        p(xk), p(rowptr), p(s_src), p(s_rel), p(s_em), p(wrel), 2 * d, col,
        p(loopk), p(mask), int(relu),
        *(p(t) for g, w in ((gf, wf), (gb, wb))
          for t in (w["wih_t"], w["whh_t"], g["bih"], g["bhh"])),
        p(gr.dt), p(bg.dt_b), float(gr.lam), p(prev_f), p(prev_b),
        p(gr.active), p(hl_f), p(hl_b), p(imp), p(sel_x), p(out), p(gin),
        B, N, d, torch.cuda.current_stream(prev_f.device).cuda_stream)
    _build.check(err, "bi_layer_fwd")
    bi_layer_fwd.launches += 1
    return out


def bi_gru_input(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int, loop,
                 gf, gb, relu: bool = False, hl=None, imp=None, csr=None,
                 hot=None):
    """The GRU input [B, N, d] of one layer (arguments as in
    ``bi_layer_fwd``): its conv output after the ReLU and, on the inactive
    rows, the impute blend, float32. On the card as K6+K7's launch forms it
    (one launch, counted on ``bi_layer_fwd.launches``), which K9+K10's
    recompute must equal bit for bit (in the bfloat16 mode, rounded to
    bfloat16 as K9+K10 store it); on the CPU the plain version's."""
    if _device("bi_layer_fwd", prev_f) == "cpu":
        return _rows_plain(x, prev_f, prev_b, bg, mask, wrel, col, loop,
                           relu, hl, imp, hot)[1]
    gin = torch.empty_like(prev_f, dtype=torch.float32)
    _bi_layer_launch(x, prev_f, prev_b, bg, mask, wrel, col, loop, gf, gb,
                     relu, hl, imp, None, csr, gin, hot)
    return gin


bi_layer_fwd.launches = 0


def bi_loss_fwd(table, rtab, gr: FinalGraph, csr=None, hot=None):
    """K8: the exact-softmax tail+head cross-entropy of each element over
    its positives, from the table [B, N, d] and the relation embeddings
    rtab [R2, d], in the mode `hot`. Returns (loss [B], saved): what
    ``fused_final_bwd_loss`` (K4) reads ("table" on every device; on the
    card also the queries, their log-sum-exps and positive scores, the
    positive counts and the CSRs, `csr` or ``final_csr(gr, N, R2)``). In the
    bfloat16 mode the score launch scores two query sets, as K3's (variant
    0 the loss's, variant 1 the backward's, whose queries, positive scores
    and log-sum-exps are saved)."""
    if _device("bi_loss_fwd", table) == "cpu":
        return _loss_plain(table, rtab, gr, hot), {"table": table}
    B, N, d = table.shape
    E = gr.src.shape[1]
    R2 = rtab.shape[0]
    _check_graph("bi_loss_fwd", gr, B, N, E, d)
    _check("bi_loss_fwd", {"table": table, "rtab": rtab}, {"rtab": (R2, d)})
    csr = final_csr(gr, N, R2) if csr is None else csr
    if csr[3][0].numel() < R2 + 1:
        raise ValueError(f"bi_loss_fwd: the CSR by relation has "
                         f"{csr[3][0].numel() - 1} rows, rtab {R2}")
    dev = table.device
    f32 = dict(device=dev, dtype=torch.float32)
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _p
    answers = (p(gr.tail_ptr), p(gr.tail_ans), p(gr.head_ptr),
               p(gr.head_ans))
    _build.check(_lib_fn(lib, "final_scores_launch", hot)(
        p(table), p(rtab), p(gr.src), p(gr.dst), p(gr.rel), p(gr.posm),
        *answers, p(part_m), p(part_s), p(qhat), p(scpos_all), B, N, E, d,
        _N_SPLIT, stream), "bi_loss_fwd (scores)")
    bi_loss_fwd.launches += 1
    _build.check(_lib_fn(lib, "final_loss_reduce_launch", hot)(
        p(part_m), p(part_s), p(scpos_all), p(gr.posm), p(lse), p(cnt),
        p(loss), B, E, _N_SPLIT, stream), "bi_loss_fwd (loss)")
    bi_loss_fwd.launches += 1
    return loss, {"table": table, "qhat": qhat, "scpos": scpos, "lse": lse,
                  "cnt": cnt, "csr": csr}


bi_loss_fwd.launches = 0


def _bi_bwd_prepare(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int,
                    loop, gf, gb, d_out, relu: bool, hl, imp, csr,
                    pattern: bool = False, hot=None):
    """(st, gru): the checked operands, CSRs, outputs and scratch of one
    ``bi_layer_bwd`` call on the card, and a function of no arguments that
    makes its GRU launch (``bi_bwd_gru_kernel``) into them; with `pattern`
    the launch also writes the ReLU's pattern into st["relu"]."""
    gr = bg.gr
    B, N, d = prev_f.shape
    R = wrel.shape[0]
    xx = _expand("bi_layer_bwd", x, B, N, d)
    _check_layer("bi_layer_bwd", bg, xx, prev_f, prev_b, mask, wrel, loop,
                 gf, gb, hl, imp, {"d_out": d_out}, hot)
    if col not in (0, d):
        raise ValueError(f"bi_layer_bwd: col = {col}, not 0 or d")
    csr = final_csr(gr, N, R) if csr is None else csr
    (rowptr, s_src, s_rel, s_em), _, (r_ptr, _), _ = csr
    if r_ptr.numel() < R + 1:
        raise ValueError(f"bi_layer_bwd: the CSR by relation has "
                         f"{r_ptr.numel() - 1} rows, wrel {R}")
    dev = prev_f.device
    f32 = dict(device=dev, dtype=torch.float32)
    # the scratch the weight launch reads only rounded: bfloat16 in that mode
    xs = dict(device=dev, dtype=torch.float32 if hot is None else hot)
    rows = B * N
    impute = hl is not None
    # the layer's input and the weights as the kernels read them: in the
    # bfloat16 mode each rounded once (the JAX kernels read them only so)
    w = {"loop": operand(loop, hot), "loop_t": operand(loop.t(), hot),
         "f": gru_operands(gf, hot, bwd=True),
         "b": gru_operands(gb, hot, bwd=True)}
    st = {"xx": operand(xx, hot), "w": w, "csr": csr,
          "n2": torch.empty(rows, **f32),
          "scr": {k: torch.empty(rows * (3 * d if k.startswith("dg") else d),
                                 **(xs if k in ("gin", "h0f", "h0b")
                                    else f32))
                  for k in ("gin", "h0f", "h0b", "dgi_f", "dgh_f", "dgi_b",
                            "dgh_b", "dconv", "dlp")},
          "d_prev_f": torch.empty(B, N, d, **f32),
          "d_prev_b": torch.empty(B, N, d, **f32),
          "d_hl": ((torch.empty(B, N, d, **f32), torch.empty(B, N, d, **f32))
                   if impute else (None, None)),
          "dimp_rows": torch.empty(rows, 4, **f32) if impute else None,
          "relu": torch.empty(B, N, d, **f32) if pattern else None}
    hl_f, hl_b = (None, None) if hl is None else hl
    scr, p = st["scr"], _p
    args = (
        p(st["xx"]), p(rowptr), p(s_src), p(s_rel), p(s_em), p(wrel), 2 * d,
        col, p(w["loop"]), p(mask), int(relu),
        p(w["f"]["wih_t"]), p(w["f"]["whh_t"]), p(gf["bih"]), p(gf["bhh"]),
        p(w["b"]["wih_t"]), p(w["b"]["whh_t"]), p(gb["bih"]), p(gb["bhh"]),
        *(p(w[t][k]) for t in "fb" for k in ("wih", "whh")),
        p(gr.dt), p(bg.dt_b), float(gr.lam), p(prev_f), p(prev_b),
        p(gr.active), p(hl_f), p(hl_b), p(imp), p(d_out), p(st["d_prev_f"]),
        p(st["d_prev_b"]), p(st["d_hl"][0]), p(st["d_hl"][1]),
        p(st["dimp_rows"]), p(st["n2"]),
        *(p(scr[k]) for k in ("gin", "h0f", "h0b", "dgi_f", "dgh_f", "dgi_b",
                              "dgh_b", "dconv", "dlp")),
        p(st["relu"]), B, N, d)

    # the launch holds the tensors behind its pointers (st, the weights' too),
    # so that a caller may keep the function alone; st holds no reference
    # back, so the scratch goes when both are gone
    def gru(_keep=st):
        _build.check(_lib_fn(_build.lib(), "bi_bwd_gru_launch", hot)(
            *args, torch.cuda.current_stream(dev).cuda_stream),
            "bi_layer_bwd (gru)")
        bi_layer_bwd.launches += 1

    return st, gru


def bi_bwd_gru_launcher(x, prev_f, prev_b, bg: BiGraph, mask, wrel,
                        col: int, loop, gf, gb, d_out, relu: bool = False,
                        hl=None, imp=None, csr=None, hot=None):
    """K9+K10's GRU launch alone, on operands prepared as ``bi_layer_bwd``
    prepares them (arguments as there, CUDA tensors only): a function of no
    arguments that makes that one launch (counted on
    ``bi_layer_bwd.launches``), so that its time can be taken apart from
    the layer backward's other four launches."""
    if _device("bi_layer_bwd", prev_f) != "cuda":
        raise ValueError("bi_bwd_gru_launcher: the GRU launch runs on a "
                         "CUDA tensor only")
    return _bi_bwd_prepare(x, prev_f, prev_b, bg, mask, wrel, col, loop, gf,
                           gb, d_out, relu, hl, imp, csr, hot=hot)[1]


def bi_relu_pattern(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int,
                    loop, gf, gb, d_out, relu: bool = False, hl=None,
                    imp=None, csr=None, hot=None):
    """The ReLU's pattern [B, N, d] (1 where it passes) as the GRU launch of
    ``bi_layer_bwd`` (arguments as there) takes it from its recomputed conv
    output, or None on the CPU, where the plain version takes its own: the
    pattern that ``bi_layer_bwd_plain``'s `relu_mask` needs to hold the
    kernels to it where the conv output lies within rounding of 0. One
    launch, counted on ``bi_layer_bwd.launches``."""
    if _device("bi_layer_bwd", prev_f) == "cpu":
        return None
    st, gru = _bi_bwd_prepare(x, prev_f, prev_b, bg, mask, wrel, col, loop,
                              gf, gb, d_out, relu, hl, imp, csr,
                              pattern=True, hot=hot)
    gru()
    return st["relu"]


def bi_layer_bwd(x, prev_f, prev_b, bg: BiGraph, mask, wrel, col: int, loop,
                 gf, gb, d_out, relu: bool = False, hl=None, imp=None,
                 csr=None, hot=None):
    """K9+K10: the backward of one layer of the flagship's final step;
    arguments as in ``bi_layer_fwd`` and d_out [B, N, d] the cotangent of
    its output (before the select), float32.

    Returns (d_h [B, N, d], d_prev_f, d_prev_b [B, N, d], d_hl_f, d_hl_b
    [B, N, d] or None, d_imp [4] or None, d_wrel [R, d], d_loop [d, d],
    d_wih_t_f, d_whh_t_f, d_bih_f, d_bhh_f, then the same for gb): the
    weights' summed over the batch; None where the layer has no blend; all
    float32."""
    if _device("bi_layer_bwd", prev_f) == "cpu":
        return bi_layer_bwd_plain(x, prev_f, prev_b, bg, mask, wrel, col,
                                  loop, gf, gb, d_out, relu, hl, imp,
                                  hot=hot)
    B, N, d = prev_f.shape
    E = bg.gr.src.shape[1]
    R = wrel.shape[0]
    st, gru = _bi_bwd_prepare(x, prev_f, prev_b, bg, mask, wrel, col, loop,
                              gf, gb, d_out, relu, hl, imp, csr, hot=hot)
    xx, scr, n2, dimp_rows = st["xx"], st["scr"], st["n2"], st["dimp_rows"]
    _, (sp, sp_dst, sp_rel, sp_em, sp_eid), (r_ptr, r_eid), _ = st["csr"]
    dev = prev_f.device
    f32 = dict(device=dev, dtype=torch.float32)
    d_h = torch.empty(B, N, d, **f32)
    ewg = torch.empty(B * E, d, **f32)
    d_wrel = torch.empty(R, d, **f32)
    shapes = {n: ((d, d) if n == "dloop" else (4,) if n == "dimp"
                  else (3 * d,) if n.startswith("db") else (d, 3 * d))
              for n in _WGRAD_LAYOUT}
    sizes = [torch.Size(shapes[n]).numel() for n in _WGRAD_LAYOUT]
    wpart = torch.zeros(_WGRAD_SPLIT, sum(sizes), **f32)
    wsum = torch.empty(sum(sizes), **f32)
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _p

    def launched(err, what):
        _build.check(err, f"bi_layer_bwd ({what})")
        bi_layer_bwd.launches += 1

    gru()
    launched(_lib_fn(lib, "final_bwd_input_launch", hot)(
        p(sp), p(sp_dst), p(sp_rel), p(sp_em), p(sp_eid), p(n2),
        p(scr["dconv"]), p(scr["dlp"]), p(wrel), 2 * d, col,
        p(st["w"]["loop_t"]), p(xx), p(ewg), p(d_h), B, N, d, stream),
        "input")
    launched(_lib_fn(lib, "bi_wgrad_launch", hot)(
        *(p(scr[k]) for k in ("gin", "h0f", "h0b", "dgi_f", "dgh_f", "dgi_b",
                              "dgh_b")),
        p(xx), p(scr["dlp"]), p(dimp_rows), p(wpart), _WGRAD_SPLIT, B, N, d,
        stream), "weights")
    launched(lib.final_wgrad_reduce_launch(p(wpart), _WGRAD_SPLIT,
                                           wsum.numel(), p(wsum), stream),
             "weight sum")
    launched(lib.final_rel_grad_launch(
        p(r_ptr), p(r_eid), p(ewg), p(d_wrel), R, d, stream), "relations")
    w = {n: t.view(shapes[n]) for n, t in
         zip(_WGRAD_LAYOUT, torch.split(wsum, sizes))}
    d_hl = st["d_hl"]
    return (d_h, st["d_prev_f"], st["d_prev_b"], d_hl[0], d_hl[1],
            w["dimp"] if hl is not None else None, d_wrel, w["dloop"],
            w["dwih_f"], w["dwhh_f"], w["dbih_f"], w["dbhh_f"],
            w["dwih_b"], w["dwhh_b"], w["dbih_b"], w["dbhh_b"])


bi_layer_bwd.launches = 0


def fused_final_bi_fwd(h0, hists, bg: BiGraph, wrel, loop1, loop2, grus,
                       rtab, imp, hot=None):
    """The flagship's final step and loss for B elements: K6+K7 for layer 1
    and layer 2, then K8. h0 [N, d] the input embeddings; hists (h1f, h2f,
    hlf, h1b, h2b, hlb), each [B, N, d] in the store dtype (float32, or
    `hot`), the two windows' densified states of layer 1, layer 2 and
    layer 2's local output; the weights as ``bi_weights`` gives them; hot
    None (float32) or torch.bfloat16 (the bfloat16 mode). Returns (loss
    [B], saved): what the backward needs ("table" and "out1" on every
    device)."""
    if _device("fused_final_bi_fwd", hists[0]) == "cpu":
        loss, table, out1 = fused_final_bi_fwd_plain(h0, hists, bg, wrel,
                                                     loop1, loop2, grus,
                                                     rtab, imp, hot)
        return loss, {"table": table, "out1": out1}
    h1f, h2f, hlf, h1b, h2b, hlb = hists
    gr = bg.gr
    B, N, d = h1f.shape
    csr = final_csr(gr, N, max(wrel.shape[0], rtab.shape[0]))
    h0x = h0.expand(B, N, d).contiguous()
    out1 = bi_layer_fwd(h0x, h1f, h1b, bg, gr.m1, wrel, 0, loop1, grus["1f"],
                        grus["1b"], csr=csr, hot=hot)
    table = bi_layer_fwd(out1, h2f, h2b, bg, gr.m2, wrel, d, loop2,
                         grus["2f"], grus["2b"], relu=bg.act2, hl=(hlf, hlb),
                         imp=imp, sel=h0x if bg.noact else None, csr=csr,
                         hot=hot)
    loss, saved = bi_loss_fwd(table, rtab, gr, csr, hot)
    saved.update(out1=out1, h0x=h0x)
    return loss, saved


def _gru_flat(grus):
    return [grus[k][n] for k in _GRUS for n in _GRU_PARTS]


def _gru_unflat(flat):
    it = iter(flat)
    return {k: {n: next(it) for n in _GRU_PARTS} for k in _GRUS}


class FusedFinalBi(torch.autograd.Function):
    """Differentiable flagship final step: ``fused_final_bi_fwd`` forward;
    backward K4, the select's backward, K9+K10 for layer 2, K9+K10 for layer
    1, as the JAX package's ``_fused_final_bi_bwd``, in the mode `hot`. `bg`
    (a BiGraph) takes no gradient; the GRU weights come flat in
    ``_gru_flat`` order. With `plain` every part runs its plain version on
    whatever device the tensors lie on (the bfloat16 plain path: autograd
    through the plain forward would not round where the kernels' backward
    does)."""

    @staticmethod
    def forward(ctx, bg, hot, plain, h0, h1f, h2f, hlf, h1b, h2b, hlb, wrel,
                loop1, loop2, rtab, imp, *gru_flat):
        hists = (h1f, h2f, hlf, h1b, h2b, hlb)
        grus = _gru_unflat(gru_flat)
        if plain:
            loss, table, out1 = fused_final_bi_fwd_plain(
                h0, hists, bg, wrel, loop1, loop2, grus, rtab, imp, hot)
            saved = {"table": table, "out1": out1}
        else:
            loss, saved = fused_final_bi_fwd(h0, hists, bg, wrel, loop1,
                                             loop2, grus, rtab, imp, hot)
        ctx.bg, ctx.saved, ctx.hot, ctx.plain = bg, saved, hot, plain
        ctx.save_for_backward(h0, *hists, wrel, loop1, loop2, rtab, imp,
                              *gru_flat)
        return loss

    @staticmethod
    def backward(ctx, g):
        (h0, h1f, h2f, hlf, h1b, h2b, hlb, wrel, loop1, loop2, rtab, imp,
         *gru_flat) = ctx.saved_tensors
        bg, saved, hot = ctx.bg, ctx.saved, ctx.hot
        gr, d = bg.gr, h0.shape[1]
        grus = _gru_unflat(gru_flat)
        csr = saved.get("csr")
        if ctx.plain:
            d_table, d_rtab = fused_final_bwd_loss_plain(
                saved["table"], rtab, gr, g.contiguous(), hot)
        else:
            d_table, d_rtab = fused_final_bwd_loss(saved, rtab, gr,
                                                   g.contiguous(), hot)
        d_out2, d_h0_sel = select_bwd(d_table,
                                      gr.active if bg.noact else None)

        def layer(x, prev_f, prev_b, mask, col, loop, gf, gb, d_out, **kw):
            if ctx.plain:
                return bi_layer_bwd_plain(x, prev_f, prev_b, bg, mask, wrel,
                                          col, loop, gf, gb, d_out, hot=hot,
                                          **kw)
            return bi_layer_bwd(x, prev_f, prev_b, bg, mask, wrel, col, loop,
                                gf, gb, d_out, csr=csr, hot=hot, **kw)

        two = layer(saved["out1"], h2f, h2b, gr.m2, d, loop2, grus["2f"],
                    grus["2b"], d_out2.contiguous(), relu=bg.act2,
                    hl=(hlf, hlb), imp=imp)
        one = layer(saved.get("h0x", h0), h1f, h1b, gr.m1, 0, loop1,
                    grus["1f"], grus["1b"], two[0])
        d_h0 = one[0].sum(0)
        if d_h0_sel is not None:
            d_h0 = d_h0 + d_h0_sel.sum(0)
        # per GRU (wih_t, whh_t, bih, bhh) in _gru_flat order: 1f, 1b, 2f, 2b
        d_grus = list(one[8:]) + list(two[8:])
        # the histories' cotangents come back in their dtype (autograd
        # rounds float32 ones to a bfloat16 history's, as the JAX
        # package's convert does)
        return (None, None, None, d_h0, one[1], two[1], two[3], one[2],
                two[2], two[4], torch.cat([one[6], two[6]], 1), one[7],
                two[7], d_rtab, two[5], *d_grus)


def fused_final_bi_supported(cfg, base: str) -> bool:
    """Config-only envelope of K6-K10 (and of their plain versions): the
    JAX package's ``fused_final_bi_supported`` without its VMEM model
    (BiGRRGCN with imputation and no gates, diagonal relation weights,
    fixed decay, no time embedding, ComplEx, negative_pool "all"), with a
    width the kernels take."""
    d = cfg.embed_size
    return (base == "GRRGCN"
            and cfg.module.startswith("Bi")
            and cfg.impute
            and not cfg.post_aggregation
            and not cfg.post_ensemble
            and not cfg.rec_only_last_layer
            and not cfg.type1
            and cfg.num_layers == 1
            and not cfg.learnable_lambda
            and not cfg.use_time_embedding
            and cfg.n_bases == d == cfg.hidden_size
            and d % 16 == 0 and d <= _MAX_D
            and cfg.score_function == "complex"
            and cfg.negative_pool == "all")


def fused_final_bi_loss(params, bg: BiGraph, hists, kernels: bool = True,
                        hot=None):
    """The loss of each of the B elements, [B]: ``FusedFinalBi`` (K6-K10
    with K4) in the mode `hot` (``kernels=False``: the plain forward,
    differentiated by autograd in float32, and with the plain K4 and
    K9+K10 in bfloat16). hists (h1f, h2f, hlf, h1b, h2b, hlb) as in
    ``fused_final_bi_fwd``. Mirrors the JAX package's
    ``fused_final_bi_loss``, batched."""
    h0, wrel, loop1, loop2, grus, rtab, imp = bi_weights(params)
    hists = tuple(h.contiguous() for h in hists)
    if not kernels and hot is None:
        return fused_final_bi_fwd_plain(h0, hists, bg, wrel, loop1, loop2,
                                        grus, rtab, imp)[0]
    return FusedFinalBi.apply(bg, hot, not kernels, h0, *hists, wrel, loop1,
                              loop2, rtab, imp, *_gru_flat(grus))
