"""The static models: StaticRGCN (SRGCN) and DRGCN.

Reference: the JAX package's ``models/static.py`` (after the reference's
baselines/StaticRGCN.py and baselines/DRGCN.py). Each target snapshot runs
a 2-layer RGCN over all N entity rows on its own graph, with no history:
biased layers, a ReLU on layer 2, and layer 2's time embedding under
``use_time_embedding`` (``static_rgcn_forward``). Training takes a 50%
subsample of the snapshot's edges and the self-loop dropout; eval the full
graph. DRGCN's inputs are ``ent_embeds + sin(t * w_ent + b_ent)`` for the
target's time position t; ``use_embed_for_non_active`` gives the inactive
rows these inputs.

The models run the element loop of ``DynamicRGCNModel`` without windows
(``recurrent = False``, as the attention models do): ``draw_train`` draws
the final step's masks, the edge subsample and the positives, and every
element's loss and ranks come from ``forward_element``, two K1 calls an
element on the card.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.dynamic import DynamicRGCNModel
from temp_tpu_torch.models.encoders import static_rgcn_forward
from temp_tpu_torch.models.layers import RELU_GAIN, xavier_uniform


class StaticRGCNModel(DynamicRGCNModel):
    """SRGCN (reference baselines/StaticRGCN.py)."""

    partitionable = False
    recurrent = False

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        # the static layers whichever static module is named
        super().__init__(cfg.replace(module="SRGCN"), data, device=device)

    def batch_hists(self, params, data: TKGData, tp, length: int,
                    draws=None, conv1_all=None):
        """No history: an empty tuple for every element. `conv1_all` is
        always None here (``precompute_eval_conv1`` gives these models
        none)."""
        if conv1_all is not None:
            raise ValueError("the static models take no precomputed convs")
        return ()

    def forward_element(self, params, data: TKGData, t_pos: int, hists=None,
                        train: bool = False, emask=None, masks=(None, None)):
        """The [N, d] entity table of target t_pos: the static RGCN of its
        snapshot (its train edges, or in training the subsample `emask`
        with the self-loop keep masks `masks`) from the input features at
        t_pos; `hists` is unused."""
        snap = self.final_snapshot(data, t_pos, 1, emask)
        h0 = self.input_embeddings(params, int(t_pos))
        _, out2 = static_rgcn_forward(params["encoder"], self.cfg, self.lc1,
                                      self.lc2, h0, snap, train=train,
                                      masks=masks)
        if self.cfg.use_embed_for_non_active:
            out2 = torch.where(snap.active[:, None], out2, h0)
        return out2


class DRGCNModel(StaticRGCNModel):
    """DRGCN: StaticRGCN with sinusoidal per-entity time features on the
    input (reference baselines/DRGCN.py, there unreachable from the CLI;
    as the JAX package implements it)."""

    def init_tree(self, gen: torch.Generator) -> Dict[str, Any]:
        """StaticRGCN's tree and the time features' "w_ent" and "b_ent"
        [N, d], xavier-uniform (ReLU gain), drawn after it."""
        p = super().init_tree(gen)
        shape = (self.num_ents, self.cfg.embed_size)
        p["w_ent"] = xavier_uniform(gen, shape, RELU_GAIN)
        p["b_ent"] = xavier_uniform(gen, shape, RELU_GAIN)
        return p

    def input_embeddings(self, params, t_pos):
        """ent_embeds + sin(t * w_ent + b_ent), t the time position (the
        ``DynamicRGCNModel.input_embeddings`` hook)."""
        return params["ent_embeds"] + torch.sin(
            float(t_pos) * params["w_ent"] + params["b_ent"])
