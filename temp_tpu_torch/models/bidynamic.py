"""BiDynamicRGCN: the bidirectional recurrent models (BiGRRGCN, BiRRGCN).

Reference: the JAX package's ``models/bidynamic.py`` (after the reference's
models/BiDynamicRGCN.py). Two history windows run for each target: the
past one on the forward recurrence (GRUs, or BiRRGCN's forward time
weights) and the future one, in reverse order, on the backward recurrence
and the backward history tables. At the target snapshot both windows'
states meet in each layer (``encoder_forward_center``: BiGRRGCN's conv
output into both GRUs, their outputs summed; BiRRGCN's two decayed states
through their time weights, added to the aggregation). Layer 2 has a
ReLU, so BiGRRGCN's windows run K2 with it on the card; BiRRGCN's, and
those under the options K2 does not take, run step by step through K1.
The final step runs one element at a time (K1), with no precomputed
layer-1 convs, as in the JAX package. Under an edge partition
(BiGRRGCN) both windows run step by step and every SpMM is partitioned
(``ops.segment.rel_spmm``). In training the forward windows
take DropEdge's past rates and the backward ones its future rates
(``edge_dropout``), or both an 80% subsample of each step's edges
(``random_dropout``).

``BiWindows`` holds the two windows' draws and histories, which the Post
Bi model (``models/post.py``) shares.
"""

from __future__ import annotations

import torch

from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.dynamic import DynamicRGCNModel, gather_window
from temp_tpu_torch.models.encoders import (
    _base_module, encoder_forward_center,
)
from temp_tpu_torch.models.layers import dropout_mask
from temp_tpu_torch.parallel.mesh import boundary_gather


class BiWindows:
    """The Bi models' two history windows, a mixin before a
    ``DynamicRGCNModel`` subclass."""

    def draw_train(self, gen: torch.Generator, data: TKGData, t_pos):
        """``DynamicRGCNModel.draw_train`` (its "win1"/"win2" and
        "win_edges" the forward window's masks) and "win1_b"/"win2_b" and
        "win_edges_b", the backward window's."""
        out = super().draw_train(gen, data, t_pos)
        out["win_edges_b"] = self.window_edges(gen, data, t_pos.long(),
                                               direction="bwd")
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
        """Both windows of B targets: the forward window's ``pre_forward``
        then the backward one's, each (hist1, hist2[, hist_loc], last_pos)
        (the local stream with ``with_loc``). `conv1_all` is always None
        here (``precompute_eval_conv1`` gives the Bi models none, as in
        the JAX package)."""
        if conv1_all is not None:
            raise ValueError("the Bi models take no precomputed convs")
        out = ()
        for direction, sfx in (("fwd", ""), ("bwd", "_b")):
            win = gather_window(data, tp, length,
                                backward=direction == "bwd")
            masks = edges = None
            if draws is not None:
                masks = (draws["win1" + sfx], draws["win2" + sfx])
                edges = draws.get("win_edges" + sfx)
            out += self.pre_forward(params, win, length, tp,
                                    train=draws is not None, masks=masks,
                                    direction=direction,
                                    with_loc=self.with_loc, edges=edges)
        return out


class BiDynamicRGCNModel(BiWindows, DynamicRGCNModel):
    """BiGRRGCN and BiRRGCN (reference models/BiDynamicRGCN.py)."""

    @property
    def partitionable(self) -> bool:
        """BiGRRGCN runs under an edge partition; BiRRGCN does not yet."""
        return _base_module(self.cfg.module) == "GRRGCN"

    def forward_element(self, params, data: TKGData, t_pos: int, hists=None,
                        train: bool = False, emask=None, masks=(None, None)):
        """Full forward for one target time -> dense [N, d] entity table,
        from both windows' history `hists` (h1f, h2f, lpf, h1b, h2b, lpb;
        computed here, for eval, when not given). `train`, `emask` and
        `masks` as in ``DynamicRGCNModel.forward_element``."""
        length = self.train_len if train else self.eval_len
        if hists is None:
            hists = self.element_hists(params, data, t_pos, length)
        h1f, h2f, lpf, h1b, h2b, lpb = hists
        snap = self.final_snapshot(data, t_pos, length, emask)
        out2, _ = encoder_forward_center(
            params["encoder"], self.cfg, self.lc1, self.lc2,
            params["ent_embeds"], snap, h1f, h2f, (length - 1) - lpf, h1b,
            h2b, (length - 1) - lpb, train=train, masks=masks)
        return self.embed_non_active(params, snap.active,
                                     boundary_gather(out2), t_pos)
