"""The gated (``--post-aggregation``) variants of the attention models.

Reference: the JAX package's ``models/postselfattn.py`` (after the
reference's models/PostSelfAttentionRGCN.py). The local table is layer 2's
conv output plus its time embedding, before the attention
(SARGCN.forward_post_ensemble: layer 1 runs plain, only layer 2 attends),
and the recurrent one is layer 2's attention output. The gates, their
loss and their ranks are the recurrent Post models' (``models/post.py``
``Gated``); the eval reports a loss of 0.
"""

from __future__ import annotations

from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.layers import layer_time_embedding, rgcn_conv
from temp_tpu_torch.models.post import Gated
from temp_tpu_torch.models.selfattn import (
    BiSelfAttentionRGCNModel, SelfAttentionRGCNModel,
)


class PostSelfAttentionRGCNModel(Gated, SelfAttentionRGCNModel):
    """SARGCN --post-aggregation (PostSelfAttentionRGCN)."""

    def forward_tables(self, params, data: TKGData, t_pos: int, hists,
                       train: bool = False, emask=None, masks=(None, None)):
        """(loc, rec) [N, d] of one target from its history `hists`
        (``batch_hists``): layer 1's conv into layer 2's (K1 on the card),
        plus layer 2's time embedding (loc), and its attention over layer
        2's history (rec). `train`, `emask` and `masks` as in
        ``DynamicRGCNModel.forward_element``."""
        cfg, enc = self.cfg, params["encoder"]
        _, h2, aux = hists
        length = self.train_len if train else self.eval_len
        snap = self.final_snapshot(data, t_pos, length, emask)
        conv1 = rgcn_conv(enc["layer1"], cfg, self.lc1, params["ent_embeds"],
                          snap, train, masks[0])
        conv2 = rgcn_conv(enc["layer2"], cfg, self.lc2, conv1, snap, train,
                          masks[1])
        cur2 = conv2 + layer_time_embedding(enc["layer2"], snap)
        rec = self._attend(enc["layer2"], cur2, h2, aux,
                           self._time_diff(length))
        return cur2, rec


class PostBiSelfAttentionRGCNModel(PostSelfAttentionRGCNModel):
    """BiSARGCN --post-aggregation (PostBiSelfAttentionRGCN): both
    windows' histories, concatenated."""

    bidirectional = True
    _time_diff = BiSelfAttentionRGCNModel._time_diff
