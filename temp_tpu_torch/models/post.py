"""The TeMP variants of the recurrent models: imputation and the frequency
gates (``--impute``, ``--post-aggregation``, ``--post-ensemble``).

Reference: the JAX package's ``models/post.py`` (after the reference's
models/PostDynamicRGCN.py, models/PostBiDynamicRGCN.py and
utils/post_evaluation.py). The final step gives two tables: the local one,
layer 2's conv output, and the recurrent one, the GRUs' output. The
windows therefore carry a third history stream, layer 2's local output
(``pre_forward(with_loc=True)``).

- ``--impute``: the local rows of the snapshot's INACTIVE entities are
  blended with their last local embedding, weighted by
  exp(-max(w * dt + b, 0)), halved on each side in the Bi model. Without a
  gate the blend also feeds the GRUs and the model scores the recurrent
  table, one element at a time as ``DynamicRGCNModel`` does (the flagship
  BiGRRGCN ``--impute`` through the fused final step K6-K10 when
  ``fused_final`` is on).
- ``--post-aggregation``: two tiny MLPs map per-query frequency features
  (``data/frequency.py``) to a sigmoid gate that blends the local and the
  recurrent EMBEDDINGS before scoring. Quirks of the reference kept: four
  MLPs are made and two used, and the head loss's "blended" object reads
  the recurrent table.
- ``--post-ensemble`` (the paper's TED): two MLPs blend the local and the
  recurrent SCORES. Eval pairs the gates opposite to training (the tail
  ranks take the subject's gate), as the reference does.

Under a gate the GRUs take the unblended conv output, and training and
eval run one element at a time (K2 for the windows, K1 in the final
step), the eval reporting a loss of 0 as the reference's does. The gates
(``Gated``) also serve the attention models' Post variants
(``models/postselfattn.py``).

The recurrent options apply as in the base models: ``type1`` and
``learnable_lambda`` in the GRUs and their decay, ``rec_only_last_layer``
(layer 1 a plain conv), time embeddings on layer 1's output and on both
tables, ``random_dropout`` and DropEdge in the training windows (which then
run step by step, K1). Only GRU modules have these variants: the reference
has no RRGCN ones, and RRGCN or BiRRGCN with a flag raises.
"""

from __future__ import annotations

import math

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.frequency import build_freq_features
from temp_tpu_torch.data.snapshots import TKGData, to_device
from temp_tpu_torch.models.bidynamic import BiWindows
from temp_tpu_torch.models.dynamic import DynamicRGCNModel
from temp_tpu_torch.models.encoders import _base_module, calc_impute_weight
from temp_tpu_torch.models.layers import (
    bigrrgcn_layer_center, grrgcn_layer, layer_time_embedding, rgcn_conv,
)
from temp_tpu_torch.models.objectives import (
    _masked_mean, both_ranks, cross_entropy_0, make_raw_scorers,
)
from temp_tpu_torch.ops.fused_final_bi import (
    final_graph_bi, fused_final_bi_loss, fused_final_bi_supported,
)
from temp_tpu_torch.ops.scores import query_for
from temp_tpu_torch.parallel.mesh import boundary_gather, manual_axis

# the gate MLPs by flag; post_aggregation's last two are never used (kept
# for the parameter tree's parity with the reference)
GATES = {"post_aggregation": ("sqse", "oqse", "sqoe", "oqoe"),
         "post_ensemble": ("subject", "object")}


def init_gate_mlp(gen: torch.Generator):
    """Linear(3, 3), ReLU, Linear(3, 1) with torch's default init: every
    weight and bias U(-1/sqrt(3), 1/sqrt(3))."""
    b = 1.0 / math.sqrt(3)

    def u(*shape):
        return (torch.rand(shape, generator=gen) * 2.0 - 1.0) * b

    return {"w1": u(3, 3), "b1": u(3), "w2": u(1, 3), "b2": u(1)}


def gate_weight(p, x):
    """sigmoid(MLP(features x [Q, 3])) -> [Q] in (0, 1)."""
    h = torch.relu(x @ p["w1"].T + p["b1"])
    return torch.sigmoid((h @ p["w2"].T + p["b2"])[..., 0])


class Gated:
    """The frequency gates of ``--post-aggregation`` and ``--post-ensemble``
    (the JAX package shares them by assignment with its Post attention
    models), a mixin before a model class whose ``forward_tables`` gives
    the (loc, rec) tables of one target: the gate MLPs, their features
    and, under a gate, the gated loss and ranks of one element."""

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        super().__init__(cfg, data, device=device)
        self.freq = None
        if self.gated:
            self.freq = to_device(build_freq_features(
                data, cfg.train_seq_len, future=cfg.module.startswith("Bi")),
                self.device)

    @property
    def gated(self) -> bool:
        return bool(self.cfg.post_aggregation or self.cfg.post_ensemble)

    def init_tree(self, gen: torch.Generator):
        """The base model's tree and, under a gate, its MLPs as "gates"
        (``GATES``), drawn after it."""
        p = super().init_tree(gen)
        for flag, names in GATES.items():
            if getattr(self.cfg, flag):
                p["gates"] = {n: init_gate_mlp(gen) for n in names}
                break
        return p

    # -- the gates ----------------------------------------------------------

    def gate_weights(self, params, split: str, t_pos: int):
        """(w_sub, w_obj) [Q, 1]: the gates of the subject and the object
        query of each edge slot of `split` at t_pos, from its frequency
        features. post_aggregation's weights both come from its first two
        MLPs ("sqse", "oqse"), as the reference's do."""
        sub = getattr(self.freq, f"{split}_sub")[t_pos]
        obj = getattr(self.freq, f"{split}_obj")[t_pos]
        g = params["gates"]
        names = GATES["post_aggregation" if self.cfg.post_aggregation
                      else "post_ensemble"]
        return (gate_weight(g[names[0]], sub)[:, None],
                gate_weight(g[names[1]], obj)[:, None])

    def element_loss(self, params, data: TKGData, t_pos: int, hists, emask,
                     masks, pos, neg=None):
        """One target's training loss (the base model's
        ``element_loss``); under a gate the gated cross-entropy over both
        tables of ``forward_tables``, every table scored against the one
        draw of candidates `neg`."""
        if not self.gated:
            return super().element_loss(params, data, t_pos, hists, emask,
                                        masks, pos, neg)
        loc, rec = self.forward_tables(params, data, t_pos, hists,
                                       train=True, emask=emask, masks=masks)
        tr = data.train
        src, rel, dst = (x[t_pos].long() for x in (tr.src, tr.rel, tr.dst))
        r_emb = params["rel_embeds"][rel]
        w_s, w_o = self.gate_weights(params, "train", t_pos)
        score_t, score_h = make_raw_scorers(self.cfg, data, t_pos, src, rel,
                                            dst, neg)

        def q(ent, mode):
            return query_for(self.score_all, ent, r_emb, mode)

        if self.cfg.post_aggregation:
            # tail: the subject blended by the object query's gate
            qt = q(w_o * loc[src] + (1 - w_o) * rec[src], "tail")
            sc_t = w_o * score_t(qt, loc) + (1 - w_o) * score_t(qt, rec)
            # head: the reference's "blended" object reads the rec table
            qh = q(rec[dst], "head")
            sc_h = w_s * score_h(qh, loc) + (1 - w_s) * score_h(qh, rec)
        else:
            # the object query's gate weighs the tail scores, the
            # subject's the head scores
            sc_t = (w_o * score_t(q(loc[src], "tail"), loc)
                    + (1 - w_o) * score_t(q(rec[src], "tail"), rec))
            sc_h = (w_s * score_h(q(loc[dst], "head"), loc)
                    + (1 - w_s) * score_h(q(rec[dst], "head"), rec))
        return (_masked_mean(cross_entropy_0(sc_t), pos)
                + _masked_mean(cross_entropy_0(sc_h), pos))

    def element_ranks(self, params, data: TKGData, t_pos: int, hists,
                      split: str):
        """One target's (ranks, mask, bce) on `split` (the base model's
        ``element_ranks``); under a gate the gated scores' ranks, and a bce
        of 0 (the reference computes no eval loss for the gated models)."""
        if not self.gated:
            return super().element_ranks(params, data, t_pos, hists, split)
        loc, rec = self.forward_tables(params, data, t_pos, hists)
        edges = getattr(data, split)
        src, rel, dst = (x[t_pos].long()
                         for x in (edges.src, edges.rel, edges.dst))
        r_emb = params["rel_embeds"][rel]
        w_s, w_o = self.gate_weights(params, split, t_pos)

        def sc(ent, table, mode):
            return self.score_all(ent, r_emb, table, mode)

        if self.cfg.post_aggregation:
            s = w_o * loc[src] + (1 - w_o) * rec[src]
            sc_tail = w_o * sc(s, loc, "tail") + (1 - w_o) * sc(s, rec, "tail")
            # the object blended here, unlike in the loss
            o = w_s * loc[dst] + (1 - w_s) * rec[dst]
            sc_head = w_s * sc(o, loc, "head") + (1 - w_s) * sc(o, rec, "head")
        else:
            # the gates paired opposite to training: the subject query's
            # gate weighs the tail scores
            sc_tail = (w_s * sc(loc[src], loc, "tail")
                       + (1 - w_s) * sc(rec[src], rec, "tail"))
            sc_head = (w_o * sc(loc[dst], loc, "head")
                       + (1 - w_o) * sc(rec[dst], rec, "head"))
        qmask = edges.emask[t_pos]
        return (both_ranks(data, t_pos, sc_tail, sc_head, src, rel, dst),
                torch.cat([qmask, qmask]),
                torch.zeros((), device=self.device))


class PostDynamicRGCNModel(Gated, DynamicRGCNModel):
    """The unidirectional variants (GRRGCN base), and what the Bi ones
    share: the windows with the local stream, the gates, the gated loss and
    ranks."""

    with_loc = True
    partitionable = False

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        if _base_module(cfg.module) != "GRRGCN":
            raise NotImplementedError(
                f"the Post variants need a GRU module, not {cfg.module} (the "
                f"reference has no RRGCN variants)")
        super().__init__(cfg, data, device=device)

    # -- the final step -----------------------------------------------------

    def layer1_out(self, params, snap, recurrent, train: bool, mask):
        """Layer 1's output in the final step: its plain conv under
        ``rec_only_last_layer``, else the output of `recurrent()` (a
        layer's (conv, rec, time_emb)) with the time embedding under
        ``use_time_embedding``."""
        cfg = self.cfg
        if cfg.rec_only_last_layer:
            return rgcn_conv(params["encoder"]["layer1"], cfg, self.lc1,
                             params["ent_embeds"], snap, train, mask)
        _, out1, t1 = recurrent()
        return out1 + t1 if cfg.use_time_embedding else out1

    def with_time_embedding(self, params, snap, loc, rec):
        """(loc, rec), each plus layer 2's time embedding under
        ``use_time_embedding``."""
        if not self.cfg.use_time_embedding:
            return loc, rec
        t2 = layer_time_embedding(params["encoder"]["layer2"], snap)
        return loc + t2, rec + t2

    def local_and_gru_input(self, snap, conv2, blended):
        """(loc, the layer-2 GRUs' input) from layer 2's conv output and the
        impute blend (None without impute): the blend on the inactive rows
        is the local table, which also feeds the GRUs unless a gate is on
        (then they take the conv output)."""
        loc = conv2 if blended is None else torch.where(
            snap.active[:, None], conv2, blended)
        return loc, conv2 if self.gated else loc

    def forward_tables(self, params, data: TKGData, t_pos: int, hists,
                       train: bool = False, emask=None, masks=(None, None)):
        """(loc, rec) [N, d] of one target from its ``batch_hists``
        (hist1, hist2, hist_loc, last_pos): layer 1 (SpMM and self-loop, K1
        on the card) and its GRU (``layer1_out``); layer 2's conv output,
        blended with the local history on the inactive rows under impute
        (loc), into its GRU (rec), both with the time embedding under
        ``use_time_embedding``. `train`, `emask` and `masks` as in
        ``DynamicRGCNModel.forward_element``."""
        cfg, enc = self.cfg, params["encoder"]
        h1, h2, hl, lp = hists
        length = self.train_len if train else self.eval_len
        snap = self.final_snapshot(data, t_pos, length, emask)
        dt = (length - 1) - lp
        out1 = self.layer1_out(params, snap, lambda: grrgcn_layer(
            enc["layer1"], cfg, self.lc1, params["ent_embeds"], snap, h1, dt,
            train=train, mask=masks[0]), train, masks[0])
        conv2 = rgcn_conv(enc["layer2"], cfg, self.lc2, out1, snap, train,
                          masks[1])
        blended = None
        if cfg.impute:
            w = calc_impute_weight(enc, dt)
            blended = w * hl + (1.0 - w) * conv2
        loc, gru_in = self.local_and_gru_input(snap, conv2, blended)
        _, rec, _ = grrgcn_layer(enc["layer2"], cfg, self.lc2, gru_in, snap,
                                 h2, dt, conv_in=True)
        return self.with_time_embedding(params, snap, boundary_gather(loc),
                                        boundary_gather(rec))

    def forward_element(self, params, data: TKGData, t_pos: int, hists=None,
                        train: bool = False, emask=None, masks=(None, None)):
        """The recurrent table of ``forward_tables`` (the table the impute
        variant scores), with ``use_embed_for_non_active``'s select.
        Arguments as in ``DynamicRGCNModel.forward_element``; `hists` this
        element's ``batch_hists``."""
        length = self.train_len if train else self.eval_len
        if hists is None:
            hists = self.element_hists(params, data, t_pos, length)
        _, rec = self.forward_tables(params, data, t_pos, hists, train=train,
                                     emask=emask, masks=masks)
        return self.embed_non_active(params, data.active[int(t_pos)], rec,
                                     t_pos)


class PostBiDynamicRGCNModel(BiWindows, PostDynamicRGCNModel):
    """The Bi variants (reference models/PostBiDynamicRGCN.py), the
    flagship BiGRRGCN ``--impute`` among them: a forward and a backward
    window, whose layer-1 and layer-2 GRUs meet at the target snapshot
    (rec = GRU_f + GRU_b)."""

    @property
    def partitionable(self) -> bool:
        """The flagship (impute without a gate) runs under an edge
        partition; TED and ``--post-aggregation`` do not yet."""
        return bool(self.cfg.impute) and not self.gated

    def fused_final_on(self) -> bool:
        """Whether training runs the final step and loss through K6-K10
        (the dispatch of the JAX package's ``PostBiDynamicRGCNModel.loss``:
        impute without a gate); off under a partition."""
        return (self.cfg.fused_final_on(self.device)
                and manual_axis() is None
                and type(self) is PostBiDynamicRGCNModel
                and fused_final_bi_supported(self.cfg,
                                             _base_module(self.cfg.module)))

    def forward_tables(self, params, data: TKGData, t_pos: int, hists,
                       train: bool = False, emask=None, masks=(None, None)):
        """(loc, rec) [N, d] of one target from its ``batch_hists``: layer 1
        (SpMM and self-loop, K1 on the card) into both GRUs, summed
        (``layer1_out``); layer 2 with its ReLU, under impute blended with
        both windows' local histories on the inactive rows (loc), into both
        GRUs, summed (rec), both with the time embedding under
        ``use_time_embedding``. `train`, `emask` and `masks` as in
        ``DynamicRGCNModel.forward_element``."""
        cfg, enc = self.cfg, params["encoder"]
        h1f, h2f, hlf, lpf, h1b, h2b, hlb, lpb = hists
        length = self.train_len if train else self.eval_len
        snap = self.final_snapshot(data, t_pos, length, emask)
        dtf, dtb = (length - 1) - lpf, (length - 1) - lpb
        out1 = self.layer1_out(params, snap, lambda: bigrrgcn_layer_center(
            enc["layer1"], cfg, self.lc1, params["ent_embeds"], snap, h1f,
            dtf, h1b, dtb, train=train, mask=masks[0]), train, masks[0])
        conv2 = rgcn_conv(enc["layer2"], cfg, self.lc2, out1, snap, train,
                          masks[1])
        blended = None
        if cfg.impute:
            w_f = calc_impute_weight(enc, dtf, "fwd")
            w_b = calc_impute_weight(enc, dtb, "bwd")
            blended = w_f * hlf + w_b * hlb + (1.0 - w_f - w_b) * conv2
        loc, gru_in = self.local_and_gru_input(snap, conv2, blended)
        _, rec, _ = bigrrgcn_layer_center(enc["layer2"], cfg, self.lc2,
                                          gru_in, snap, h2f, dtf, h2b, dtb,
                                          conv_in=True)
        return self.with_time_embedding(params, snap, boundary_gather(loc),
                                        boundary_gather(rec))

    def fused_final_losses(self, params, data: TKGData, tp, draws, hists):
        """The final steps and losses of the B targets tp as one call of
        K6-K10 with K4 (``fused_final_bi_loss``): [B]."""
        cfg = self.cfg
        h1f, h2f, hlf, lpf, h1b, h2b, hlb, lpb = hists
        bg = final_graph_bi(data, self.answers, tp, draws, lpf, lpb,
                            cfg.inv_temperature, self.lc2.dropout,
                            self.train_len, self.lc2.activation == "relu",
                            cfg.use_embed_for_non_active)
        return fused_final_bi_loss(params, bg, (h1f, h2f, hlf, h1b, h2b, hlb),
                                   kernels=cfg.kernels, hot=cfg.hot_dtype)
