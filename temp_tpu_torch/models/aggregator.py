"""Aggregator: the two-checkpoint TED ensemble.

Reference: the JAX package's ``models/aggregator.py`` (after the
reference's models/aggregator.py). Two frozen, pretrained submodels, a
spatial one (SRGCN) and a temporal one, come from run directories the
Trainer wrote (config.json and checkpoints/best.pt, ``spatial_checkpoint``
and ``temporal_checkpoint``; ``load_checkpoint_params``). Without both, a
debug path builds fresh seeded ones: SRGCN from seed and
``temporal_module`` from seed + 1. Only two gate MLPs train
(``models/post.py``'s): per query, a sigmoid of the frequency features
(``data/frequency.py``) blends the two submodels' scores, every table
scored against one draw of candidates. Eval pairs the gates the swapped
way, as TED does (the tail ranks take the subject's gate), with an eval
loss of 0.

The submodels' forwards run in eval mode (full graphs, no dropout) under
``torch.no_grad()``: on the card K1f and K2f, never their backward
kernels (``kernels`` off, the Aggregator's, their plain versions). Their
parameters stay as loaded.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.frequency import build_freq_features
from temp_tpu_torch.data.snapshots import TKGData, to_device
from temp_tpu_torch.models.objectives import (
    _masked_mean, both_ranks, cross_entropy_0, element_neg,
    make_raw_scorers,
)
from temp_tpu_torch.models.baselines import EmbeddingBaseline
from temp_tpu_torch.models.post import gate_weight, init_gate_mlp
from temp_tpu_torch.ops.scores import query_for


def _frozen(params):
    """The parameter tree with every leaf detached, requiring no grad."""
    if isinstance(params, dict):
        return {k: _frozen(v) for k, v in params.items()}
    if isinstance(params, list):
        return [_frozen(v) for v in params]
    return params.detach().requires_grad_(False)


class AggregatorModel(EmbeddingBaseline):
    """The Aggregator (reference models/aggregator.py), on the
    baselines' seeded init, draws and Trainer hooks."""

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        from temp_tpu_torch.models.registry import get_model
        from temp_tpu_torch.train.loop import load_checkpoint_params

        super().__init__(cfg, data, device=device)
        if cfg.spatial_checkpoint and cfg.temporal_checkpoint:
            subs = []
            for run_dir in (cfg.spatial_checkpoint, cfg.temporal_checkpoint):
                sub_cfg, params, _ = load_checkpoint_params(run_dir,
                                                            self.device)
                # the kernels or their plain versions, as the Aggregator
                sub_cfg = sub_cfg.replace(kernels=cfg.kernels)
                subs.append((get_model(sub_cfg, data, device=self.device),
                             params))
        else:
            subs = [(get_model(cfg.replace(module=m), data,
                               device=self.device), seed)
                    for m, seed in (("SRGCN", cfg.seed),
                                    (cfg.temporal_module, cfg.seed + 1))]
            subs = [(m, m.init_params(seed)) for m, seed in subs]
        (self.spatial_model, sp), (self.temporal_model, tp) = subs
        self.spatial_params, self.temporal_params = _frozen(sp), _frozen(tp)
        temporal_cfg = self.temporal_model.cfg
        self.freq = to_device(build_freq_features(
            data, temporal_cfg.train_seq_len,
            future=temporal_cfg.module.startswith("Bi")), self.device)

    def init_tree(self, gen: torch.Generator) -> Dict[str, Any]:
        """The two gate MLPs, "subject" then "object"; nothing else
        trains."""
        return {"gates": {"subject": init_gate_mlp(gen),
                          "object": init_gate_mlp(gen)}}

    def _tables(self, data: TKGData, t_host):
        """[(loc, rec)] of the targets t_host: the frozen submodels' [N, d]
        tables in eval mode, each submodel's windows of all the targets as
        one batch."""
        if not t_host:
            return []
        tp = torch.tensor(t_host, device=self.device)
        subs = ((self.spatial_model, self.spatial_params),
                (self.temporal_model, self.temporal_params))
        with torch.no_grad():
            hists = [m.batch_hists(p, data, tp, m.eval_len) for m, p in subs]
            return [tuple(m.forward_element(p, data, t,
                                            hists=tuple(h[b] for h in hs))
                          for (m, p), hs in zip(subs, hists))
                    for b, t in enumerate(t_host)]

    def _gates(self, params, split: str, t_pos: int):
        """(w_subj, w_obj) [Q, 1] of `split`'s edge slots at t_pos."""
        g, f = params["gates"], self.freq
        return (gate_weight(g["subject"], getattr(f, f"{split}_sub")[t_pos]
                            )[:, None],
                gate_weight(g["object"], getattr(f, f"{split}_obj")[t_pos]
                            )[:, None])

    def loss(self, params, data: TKGData, t_pos, t_valid,
             gen: torch.Generator = None, draws=None):
        """The summed gated loss of the targets t_pos whose t_valid is
        True (the others' terms are zero); `draws` (``draw_train``) drawn
        from `gen` when None."""
        t_all = [int(t) for t in np.asarray(t_pos)]
        rows = [b for b, v in enumerate(np.asarray(t_valid)) if v]
        if draws is None:
            draws = self.draw_train(gen, data,
                                    torch.tensor(t_all, device=self.device))
        total = torch.zeros((), device=self.device)
        for b, tables in zip(rows, self._tables(data,
                                                [t_all[b] for b in rows])):
            total = total + self._element_loss(
                params, data, t_all[b], tables, draws["pos"][b],
                element_neg(draws, b))
        return total

    def _element_loss(self, params, data: TKGData, t_pos: int, tables, pos,
                      neg):
        """One target's gated cross-entropy: the object query's gate
        weighs the tail scores of the spatial table (loc) against the
        temporal one's (rec), the subject's the head scores."""
        loc, rec = tables
        tr = data.train
        src, rel, dst = (x[t_pos].long() for x in (tr.src, tr.rel, tr.dst))
        rl = self.spatial_params["rel_embeds"][rel]
        rr = self.temporal_params["rel_embeds"][rel]
        w_s, w_o = self._gates(params, "train", t_pos)
        score_t, score_h = make_raw_scorers(self.cfg, data, t_pos, src, rel,
                                            dst, neg)

        def q(ent, r, mode):
            return query_for(self.score_all, ent, r, mode)

        sc_t = (w_o * score_t(q(loc[src], rl, "tail"), loc)
                + (1 - w_o) * score_t(q(rec[src], rr, "tail"), rec))
        sc_h = (w_s * score_h(q(loc[dst], rl, "head"), loc)
                + (1 - w_s) * score_h(q(rec[dst], rr, "head"), rec))
        return (_masked_mean(cross_entropy_0(sc_t), pos)
                + _masked_mean(cross_entropy_0(sc_h), pos))

    def element_scores(self, params, data: TKGData, t_pos: int, tables,
                       split: str):
        """One target's gated scores on `split` from its (loc, rec)
        tables: (sc_tail, sc_head [Q, N], src, rel, dst [Q]), the gates
        paired opposite to training (the subject query's gate weighs the
        tail scores)."""
        loc, rec = tables
        edges = getattr(data, split)
        src, rel, dst = (x[t_pos].long()
                         for x in (edges.src, edges.rel, edges.dst))
        rl = self.spatial_params["rel_embeds"][rel]
        rr = self.temporal_params["rel_embeds"][rel]
        w_s, w_o = self._gates(params, split, t_pos)
        sc_tail = (w_s * self.score_all(loc[src], rl, loc, "tail")
                   + (1 - w_s) * self.score_all(rec[src], rr, rec, "tail"))
        sc_head = (w_o * self.score_all(loc[dst], rl, loc, "head")
                   + (1 - w_o) * self.score_all(rec[dst], rr, rec, "head"))
        return sc_tail, sc_head, src, rel, dst

    def eval_ranks(self, params, data: TKGData, t_pos, t_valid, split: str,
                   conv1_all=None):
        """Filtered ranks of the gated scores (``element_scores``) for a
        batch of target times: (ranks [B, 2Q], mask [B, 2Q], 0)."""
        if conv1_all is not None:
            raise ValueError("the Aggregator takes no precomputed convs")
        t_host = [int(t) for t in np.asarray(t_pos)]
        tv = torch.as_tensor(np.asarray(t_valid, bool), device=self.device)
        emask = getattr(data, split).emask
        ranks = [both_ranks(data, t, *self.element_scores(params, data, t,
                                                          tables, split))
                 for t, tables in zip(t_host, self._tables(data, t_host))]
        mask = torch.stack([torch.cat([emask[t], emask[t]])
                            for t in t_host]) & tv[:, None]
        return torch.stack(ranks), mask, torch.zeros((), device=self.device)
