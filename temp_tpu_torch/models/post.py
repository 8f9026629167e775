"""The imputation variants of the recurrent models (the flagship BiGRRGCN
``--impute``).

Reference: the JAX package's ``models/post.py`` (after the reference's
models/PostDynamicRGCN.py and models/PostBiDynamicRGCN.py). With
``--impute`` the layer-2 input of the snapshot's INACTIVE entities is
blended with their last local (pre-GRU) embedding, weighted by
exp(-max(w * dt + b, 0)), halved on each side in the Bi model; the blend
feeds the GRUs. The windows therefore carry a third history stream, layer
2's local output (``pre_forward(with_loc=True)``).

Ported: ``PostBiDynamicRGCNModel`` with impute and no gates, trained through
the fused final step K6-K10 (``ops/fused_final_bi.py``) when
``fused_final`` is on and the config is inside its envelope, else one
element at a time (``forward_element``, K1 on the card). The gates
(``post_aggregation``, ``post_ensemble``) and the unidirectional impute
model are not ported yet: ``PostDynamicRGCNModel`` holds what the two share
and raises for the rest. Under an edge partition (``parallel/``) the impute
variants raise too.
"""

from __future__ import annotations

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.dynamic import DynamicRGCNModel, gather_window
from temp_tpu_torch.models.encoders import _base_module, calc_impute_weight
from temp_tpu_torch.models.layers import (
    Snapshot, decay_factor, dropout_mask, rgcn_conv,
)
from temp_tpu_torch.ops.fused_final_bi import (
    final_graph_bi, fused_final_bi_loss, fused_final_bi_supported,
)
from temp_tpu_torch.ops.gru import gru_stack
from temp_tpu_torch.parallel.mesh import manual_axis

PARTITION_UNPORTED = ("the impute variants under an edge partition are not "
                      "ported yet; see ROADMAP.md")


class PostDynamicRGCNModel(DynamicRGCNModel):
    """The shared part of the impute variants: the windows with the local
    stream, and the table the decoder scores (the recurrent one)."""

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        if _base_module(cfg.module) != "GRRGCN":
            raise NotImplementedError(
                f"the impute variants need a GRU module, not {cfg.module}")
        if cfg.post_aggregation or cfg.post_ensemble:
            raise NotImplementedError("the post_aggregation and "
                                      "post_ensemble gates are not ported "
                                      "yet; see ROADMAP.md")
        super().__init__(cfg, data, device=device)

    def pre_forward_loc(self, params, win, length: int, t_pos, train=False,
                        masks=None, direction=None):
        """``pre_forward`` carrying the local stream: (hist1, hist2,
        hist_loc, last_pos). Raises under an edge partition."""
        if manual_axis() is not None:
            raise NotImplementedError(PARTITION_UNPORTED)
        return self.pre_forward(params, win, length, t_pos, train=train,
                                masks=masks, direction=direction,
                                with_loc=True)

    def forward_tables(self, params, data: TKGData, t_pos: int, hists,
                       train: bool = False, emask=None, masks=(None, None)):
        raise NotImplementedError("the unidirectional impute model is not "
                                  "ported yet; see ROADMAP.md")

    def forward_element(self, params, data: TKGData, t_pos: int, hists=None,
                        train: bool = False, emask=None, masks=(None, None)):
        """The recurrent table of ``forward_tables`` (the table the impute
        variants score), with ``use_embed_for_non_active``'s select.
        Arguments as in ``DynamicRGCNModel.forward_element``; `hists` this
        element's ``batch_hists``."""
        length = self.train_len if train else self.eval_len
        tp = torch.tensor(int(t_pos), device=self.device)
        if hists is None:
            hists = tuple(h[0] for h in self.batch_hists(
                params, data, tp[None], length))
        _, rec = self.forward_tables(params, data, t_pos, hists, train=train,
                                     emask=emask, masks=masks)
        if self.cfg.use_embed_for_non_active:
            rec = torch.where(data.active[tp][:, None], rec,
                              params["ent_embeds"])
        return rec


class PostBiDynamicRGCNModel(PostDynamicRGCNModel):
    """BiGRRGCN with imputation (reference models/PostBiDynamicRGCN.py):
    a forward and a backward window, whose layer-1 and layer-2 GRUs meet at
    the target snapshot (center fusion: rec = GRU_f + GRU_b)."""

    def fused_final_on(self) -> bool:
        """Whether training runs the final step and loss through K6-K10
        (the dispatch of the JAX package's ``PostBiDynamicRGCNModel.loss``)."""
        return (self.cfg.fused_final_on(self.device)
                and type(self) is PostBiDynamicRGCNModel
                and fused_final_bi_supported(self.cfg,
                                             _base_module(self.cfg.module)))

    def draw_train(self, gen: torch.Generator, data: TKGData, t_pos):
        """``DynamicRGCNModel.draw_train`` (its "win1"/"win2" the forward
        window's masks) and "win1_b"/"win2_b", the backward window's."""
        out = super().draw_train(gen, data, t_pos)
        out["win1_b"] = out["win2_b"] = None
        L1 = self.train_len - 1
        rate = self.lc1.dropout
        if rate > 0.0 and L1 > 0:
            shape = (t_pos.shape[0], L1, data.act_idx.shape[-1],
                     self.cfg.embed_size)
            for key in ("win1_b", "win2_b"):
                out[key] = dropout_mask(gen, shape, rate, self.device)
        return out

    def batch_hists(self, params, data: TKGData, tp, length: int,
                    draws=None, conv1_all=None):
        """Both windows of B targets: (h1f, h2f, hlf, lpf, h1b, h2b, hlb,
        lpb), the forward window's ``pre_forward_loc`` then the backward
        one's. `conv1_all` is always None here (``precompute_eval_conv1``
        gives the Post models none, as in the JAX package)."""
        if conv1_all is not None:
            raise ValueError("the Post models take no precomputed convs")
        out = ()
        for direction, keys in (("fwd", ("win1", "win2")),
                                ("bwd", ("win1_b", "win2_b"))):
            win = gather_window(data, tp, length,
                                backward=direction == "bwd")
            masks = None if draws is None else tuple(draws[k] for k in keys)
            out += self.pre_forward_loc(params, win, length, tp,
                                        train=draws is not None, masks=masks,
                                        direction=direction)
        return out

    def forward_tables(self, params, data: TKGData, t_pos: int, hists,
                       train: bool = False, emask=None, masks=(None, None)):
        """(loc, rec) [N, d] of one target from its ``batch_hists``: layer 1
        (SpMM and self-loop, K1 on the card) into both GRUs, summed; layer 2
        with its ReLU, the impute blend on the inactive rows (loc) feeding
        both GRUs, summed (rec). `train`, `emask` and `masks` as in
        ``DynamicRGCNModel.forward_element``."""
        cfg = self.cfg
        enc = params["encoder"]
        p1, p2 = enc["layer1"], enc["layer2"]
        h1f, h2f, hlf, lpf, h1b, h2b, hlb, lpb = hists
        length = self.train_len if train else self.eval_len
        last = length - 1
        tp = torch.tensor(int(t_pos), device=self.device)
        win = gather_window(data, tp, length)
        snap = Snapshot(src=win.src[last], dst=win.dst[last],
                        rel=win.rel[last],
                        emask=win.emask[last] if emask is None else emask,
                        t_idx=win.t_idx[last], valid=win.valid[last],
                        active=win.active[last], t_pos=win.t_idx[last],
                        tables=win.tables)
        dtf, dtb = last - lpf, last - lpb
        conv1 = rgcn_conv(p1, cfg, self.lc1, params["ent_embeds"], snap,
                          train, masks[0])
        out1 = (gru_stack(p1["gru_fwd"], conv1,
                          h1f * decay_factor(p1, cfg, dtf))
                + gru_stack(p1["gru_bwd"], conv1,
                            h1b * decay_factor(p1, cfg, dtb)))
        conv2 = rgcn_conv(p2, cfg, self.lc2, out1, snap, train, masks[1])
        w_f = calc_impute_weight(enc, dtf, "fwd")
        w_b = calc_impute_weight(enc, dtb, "bwd")
        blended = w_f * hlf + w_b * hlb + (1.0 - w_f - w_b) * conv2
        loc = torch.where(snap.active[:, None], conv2, blended)
        rec = (gru_stack(p2["gru_fwd"], loc, h2f * decay_factor(p2, cfg, dtf))
               + gru_stack(p2["gru_bwd"], loc,
                           h2b * decay_factor(p2, cfg, dtb)))
        return loc, rec

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
                                   kernels=cfg.kernels)
