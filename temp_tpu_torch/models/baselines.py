"""The embedding baselines: Static, DE (DiachronicEmbedding), ATiSE, Hyte
and SimplE.

Reference: the JAX package's ``models/baselines.py`` (after the
reference's baselines/{Static,DiachronicEmbedding,AtiSE,Hyte,Simple}.py).
Each baseline gives an entity table (and a relation table) for a time
position with no graph, so none runs a kernel; the loss and the filtered
ranks are the recurrent models' (``train_loss_single`` over the config's
negative pool, ``eval_ranks_single``), one target at a time:

- Static: one embedding table, the decoder of ``score_function``;
- DE: half of each entity's columns static, the other half times
  sin(t * w_temp + b_temp);
- ATiSE: the same feature map (the reference's file implements no more);
- Hyte: entity and relation embeddings projected onto the time position's
  hyperplane (the unit normal of its row of time_embeds), TransE scores
  (the score function forced);
- SimplE: canonical and inverse embeddings, each direction's scores the
  mean of two DistMult terms; eval scores tails against the inverse table
  and heads against the canonical one, with an eval loss of 0.

The models follow the Trainer's interface (``init_params``, ``loss`` with
`gen` or `draws`, ``eval_ranks`` with `conv1_all`, which is always None:
``precompute_eval_conv1`` gives none). Training draws the loss's positive
subset and the pool's candidates (``draw_train``).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.dynamic import _mean_bce, _tree_to
from temp_tpu_torch.models.layers import RELU_GAIN, xavier_uniform
from temp_tpu_torch.models.objectives import (
    _masked_mean, both_ranks, cross_entropy_0, draw_pool, element_neg,
    eval_ranks_single, make_raw_scorers, train_loss_single,
)
from temp_tpu_torch.models.timedynamic import diachronic
from temp_tpu_torch.ops.gru import shared_rounding
from temp_tpu_torch.ops.sampling import subsample_positives
from temp_tpu_torch.ops.scores import get_score_fn
from temp_tpu_torch.train.optim import param_leaves


class EmbeddingBaseline:
    """The baselines' common machinery: a per-time entity table scored by
    the shared loss and eval (reference baselines/TKG_Non_Recurrent.py)."""

    partitionable = False
    recurrent = False

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_ents = data.num_ents
        self.num_rels = data.num_rels
        self.num_times = data.num_times
        self.score_all, self.score_single = get_score_fn(cfg.score_function)

    # -- parameters ---------------------------------------------------------

    def init_params(self, seed: int) -> Dict[str, Any]:
        """Seeded init (drawn on the CPU, then moved to the model's
        device)."""
        gen = torch.Generator().manual_seed(int(seed))
        return _tree_to(self.init_tree(gen), self.device)

    def init_tree(self, gen: torch.Generator) -> Dict[str, Any]:
        """ent_embeds [N, d] and rel_embeds [2R, d], xavier-uniform (ReLU
        gain), then the baseline's own (``extra_tree``), drawn in order."""
        d = self.cfg.embed_size
        p = {"ent_embeds": xavier_uniform(gen, (self.num_ents, d), RELU_GAIN),
             "rel_embeds": xavier_uniform(gen, (2 * self.num_rels, d),
                                          RELU_GAIN)}
        p.update(self.extra_tree(gen))
        return p

    def extra_tree(self, gen: torch.Generator) -> Dict[str, Any]:
        return {}

    def entity_table(self, params, t_pos: int):
        """[N, d] entity representations at time position t_pos."""
        return params["ent_embeds"]

    def rel_table(self, params, t_pos: int):
        """[2R, d] relation representations at time position t_pos."""
        return params["rel_embeds"]

    # -- the Trainer's interface --------------------------------------------

    def fused_final_on(self) -> bool:
        """No fused final step: the baselines have no graph."""
        return False

    def precompute_eval_conv1(self, params, data: TKGData):
        """None: the baselines have no layer-1 convs."""
        return None

    def draw_train(self, gen: torch.Generator, data: TKGData, t_pos):
        """Every random draw of one training step for the targets t_pos [B]
        (a tensor on the model's device), from `gen`: "pos", the loss's
        positive subset [B, E] bool, and the pool's "neg_tail"/"neg_head"
        (``draw_pool``)."""
        tp = t_pos.long()
        out = {"pos": subsample_positives(gen, data.train.emask[tp],
                                          self.cfg.num_pos_facts)}
        out.update(draw_pool(gen, self.cfg, data, tp))
        return out

    def loss(self, params, data: TKGData, t_pos, t_valid,
             gen: torch.Generator = None, draws=None):
        """The summed loss of the targets t_pos whose t_valid is True (the
        others' terms are zero), one at a time (``element_loss``); `draws`
        (``draw_train``) drawn from `gen` when None. The parameters are
        rounded once for all the elements under a hot dtype
        (``shared_rounding``), as the JAX package's vmap rounds them."""
        t_host = [int(t) for t in np.asarray(t_pos)]
        tv = [bool(v) for v in np.asarray(t_valid)]
        if draws is None:
            draws = self.draw_train(
                gen, data, torch.tensor(t_host, device=self.device))
        total = torch.zeros((), device=self.device)
        with shared_rounding(param_leaves(params)) as next_element:
            for b, t in enumerate(t_host):
                if tv[b]:
                    next_element()
                    total = total + self.element_loss(
                        params, data, t, draws["pos"][b],
                        element_neg(draws, b))
        return total

    def element_loss(self, params, data: TKGData, t_pos: int, pos, neg):
        """One target's tail+head cross-entropy over its positives `pos`
        and candidates `neg` (``train_loss_single``)."""
        tr = data.train
        return train_loss_single(
            self.cfg, data, self.score_all, self.rel_table(params, t_pos),
            self.entity_table(params, t_pos), t_pos, tr.src[t_pos],
            tr.rel[t_pos], tr.dst[t_pos], pos, neg)

    def eval_ranks(self, params, data: TKGData, t_pos, t_valid, split: str,
                   conv1_all=None):
        """Filtered ranks for a batch of target times: (ranks [B, 2Q], mask
        [B, 2Q], mean bce loss), one target at a time."""
        if conv1_all is not None:
            raise ValueError("the baselines take no precomputed convs")
        tv = torch.as_tensor(np.asarray(t_valid, bool), device=self.device)
        out = [self.element_ranks(params, data, int(t), split)
               for t in np.asarray(t_pos)]
        ranks = torch.stack([o[0] for o in out])
        mask = torch.stack([o[1] for o in out]) & tv[:, None]
        return ranks, mask, _mean_bce(torch.stack([o[2] for o in out]), mask)

    def element_ranks(self, params, data: TKGData, t_pos: int, split: str):
        """One target's (ranks [2Q], mask [2Q], bce) on `split`."""
        edges = getattr(data, split)
        return eval_ranks_single(
            self.cfg, data, self.score_all, self.score_single,
            self.rel_table(params, t_pos), self.entity_table(params, t_pos),
            t_pos, edges.src[t_pos], edges.rel[t_pos], edges.dst[t_pos],
            edges.emask[t_pos])


class StaticModel(EmbeddingBaseline):
    """Static (reference baselines/Static.py)."""


class DiachronicEmbeddingModel(EmbeddingBaseline):
    """DE (reference baselines/DiachronicEmbedding.py): the first
    floor(static_frac * d) columns static, the rest times
    sin(t * w_temp + b_temp)."""

    static_frac = 0.5

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        super().__init__(cfg, data, device=device)
        self.static_size = math.floor(self.static_frac * cfg.embed_size)
        self.temporal_size = cfg.embed_size - self.static_size

    def extra_tree(self, gen: torch.Generator):
        shape = (self.num_ents, self.temporal_size)
        return {"w_temp": xavier_uniform(gen, shape, RELU_GAIN),
                "b_temp": xavier_uniform(gen, shape, RELU_GAIN)}

    def entity_table(self, params, t_pos: int):
        t = torch.tensor(float(t_pos), device=self.device)
        return diachronic(params["ent_embeds"], params["w_temp"],
                          params["b_temp"], t, self.static_size)


class AtiSEModel(DiachronicEmbeddingModel):
    """ATiSE (reference baselines/AtiSE.py, whose source implements the
    same feature map as DE)."""


class HyteModel(EmbeddingBaseline):
    """Hyte (reference baselines/Hyte.py): both embedding tables projected
    onto the time position's hyperplane, scored by TransE (forced)."""

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        super().__init__(cfg.replace(score_function="transE"), data,
                         device=device)

    def extra_tree(self, gen: torch.Generator):
        return {"time_embeds": xavier_uniform(
            gen, (self.num_times, self.cfg.embed_size), RELU_GAIN)}

    def _project(self, params, x, t_pos: int):
        w = params["time_embeds"][t_pos][None, :]
        w = w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        return x - w * torch.sum(x * w, dim=-1, keepdim=True)

    def entity_table(self, params, t_pos: int):
        return self._project(params, params["ent_embeds"], t_pos)

    def rel_table(self, params, t_pos: int):
        return self._project(params, params["rel_embeds"], t_pos)


class SimplEModel(EmbeddingBaseline):
    """SimplE (reference baselines/Simple.py)."""

    def extra_tree(self, gen: torch.Generator):
        d = self.cfg.embed_size
        return {"ent_embeds_inv": xavier_uniform(gen, (self.num_ents, d),
                                                 RELU_GAIN),
                "rel_embeds_inv": xavier_uniform(gen, (2 * self.num_rels, d),
                                                 RELU_GAIN)}

    def element_loss(self, params, data: TKGData, t_pos: int, pos, neg):
        """Each direction's logits the mean of two dot-query terms, both
        against the one draw of candidates: tails s*r against the inverse
        table and s_inv*r_inv against the canonical one; heads r*o_inv
        against the canonical table and r_inv*o against the inverse
        one."""
        tr = data.train
        src, rel, dst = (x[t_pos].long() for x in (tr.src, tr.rel, tr.dst))
        emb, inv = params["ent_embeds"], params["ent_embeds_inv"]
        re, ri = params["rel_embeds"][rel], params["rel_embeds_inv"][rel]
        score_t, score_h = make_raw_scorers(self.cfg, data, t_pos, src, rel,
                                            dst, neg)
        sc_t = 0.5 * (score_t((emb[src] * re, "dot"), inv)
                      + score_t((inv[src] * ri, "dot"), emb))
        sc_h = 0.5 * (score_h((re * inv[dst], "dot"), emb)
                      + score_h((ri * emb[dst], "dot"), inv))
        return (_masked_mean(cross_entropy_0(sc_t), pos)
                + _masked_mean(cross_entropy_0(sc_h), pos))

    def element_ranks(self, params, data: TKGData, t_pos: int, split: str):
        """DistMult scores, tail candidates from the inverse table and head
        candidates from the canonical one (the reference's
        SimpleEvaluationFilter); the bce 0."""
        edges = getattr(data, split)
        src, rel, dst = (x[t_pos].long()
                         for x in (edges.src, edges.rel, edges.dst))
        emb, inv = params["ent_embeds"], params["ent_embeds_inv"]
        re = params["rel_embeds"][rel]
        sc_tail = (emb[src] * re) @ inv.T
        sc_head = (re * inv[dst]) @ emb.T
        qmask = edges.emask[t_pos]
        return (both_ranks(data, t_pos, sc_tail, sc_head, src, rel, dst),
                torch.cat([qmask, qmask]),
                torch.zeros((), device=self.device))


BASELINES = {"Static": StaticModel, "DE": DiachronicEmbeddingModel,
             "ATiSE": AtiSEModel, "Hyte": HyteModel, "SimplE": SimplEModel}


def get_baseline(cfg: TKGConfig, data: TKGData, device="cuda"):
    return BASELINES[cfg.module](cfg, data, device=device)
