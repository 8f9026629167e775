"""Self-attention temporal models: SARGCN and BiSARGCN.

Reference: the JAX package's ``models/selfattn.py`` (after the reference's
models/SARGCN.py, models/SelfAttentionRGCN.py and
models/BiSelfAttentionRGCN.py). Each history snapshot runs the static
2-layer RGCN on its own, with no recurrence, so a window's L-1 history
steps run side by side: one SpMM a layer over the L-1 graphs (K1 on the
card, over the data's static tables of the train snapshots; each slot names
its time position, clamped into [0, T) where the window runs off the data,
and such a slot's edges are all masked). The final snapshot then attends
over the stacked history and itself with 8 heads and an additive
(slot, entity) activity mask of -10e9, with an optional learnable decay of
the logits by the time difference (``learnable_lambda``), and JK max-pools
the two layers' attention outputs unless ``rec_only_last_layer``.

Two forms of the history, as in JAX:

- dense (default): each step's convs run over all N entity rows in global
  ids, [L-1, N, d] states and an [L-1, N] mask;
- compact (``sa_compact``): each step's convs run over its A active rows
  in compact slots, and the attention's per-entity softmax is a segment
  max and sum over the slots' entity ids.

``ema`` replaces the attention on the final snapshot's inactive rows by an
exponential moving average over the history (a learnable rate a
dimension). The attention, the EMA and the segment softmax are plain torch
ops, as they are XLA ops in the JAX package.

Training draws every random choice of a step up front (``draw_train``), as
``DynamicRGCNModel`` does; the final step and loss run one element at a
time, as in JAX (no fused final step for these models).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.dynamic import DynamicRGCNModel, gather_window
from temp_tpu_torch.models.layers import (
    RELU_GAIN, Snapshot, dropout_mask, init_rgcn_layer, layer_time_embedding,
    rgcn_conv, xavier_uniform,
)
from temp_tpu_torch.models.objectives import draw_pool
from temp_tpu_torch.ops.gru import shared_rounding
from temp_tpu_torch.ops.sampling import subsample_edges, subsample_positives
from temp_tpu_torch.train.optim import param_leaves

NEG_MASK = -10e9  # reference SelfAttentionRGCN.py:109
N_HEADS = 8       # reference SARGCN.py:20


def _linear_init(gen: torch.Generator, out_f: int, in_f: int):
    """torch nn.Linear(bias=False)'s default init: U(-1/sqrt(in),
    1/sqrt(in))."""
    b = 1.0 / math.sqrt(in_f)
    return (torch.rand((out_f, in_f), generator=gen) * 2.0 - 1.0) * b


def init_sargcn_layer(gen: torch.Generator, cfg: TKGConfig, lc):
    """The conv's parameters (``init_rgcn_layer``) and the attention's
    query, key and value maps, [d, d] each, applied as ``x @ W.T``."""
    p = init_rgcn_layer(gen, cfg, lc)
    for name in ("q_linear", "k_linear", "v_linear"):
        p[name] = _linear_init(gen, lc.in_feat, lc.in_feat)
    return p


def _logit_decay(p, cfg: TKGConfig, time_diff):
    """-max(decay_w * time_diff + decay_b, 0) [S+1] under
    ``learnable_lambda``, else None."""
    if not cfg.learnable_lambda:
        return None
    x = p["decay_w"] * time_diff + p["decay_b"]
    # torch.maximum splits the gradient at a tie, as jnp.maximum does
    return -torch.maximum(x, torch.zeros_like(x))


def _merge_heads(out, n: int, d: int):
    """[n, heads, d_k] -> [n, d] in the reference's [d_k, heads] order
    (calc_result transposes before the view, SARGCN.py:36)."""
    return out.transpose(1, 2).reshape(n, d)


def attention_over_history(p, cfg: TKGConfig, cur, hist, time_diff,
                           attn_mask):
    """Multi-head attention of the current embedding over [history...,
    current]. cur [N, d]; hist [S, N, d]; time_diff [S+1]; attn_mask
    [S+1, N] (0 where the (slot, entity) was active, -10e9 otherwise; the
    current slot 0). The reference's SARGCNLayer.attention
    (SARGCN.py:25-53)."""
    d = cur.shape[-1]
    dk = d // N_HEADS
    allt = torch.cat([hist, cur[None]], 0)                    # [L, N, d]
    L, N, _ = allt.shape
    q = (cur @ p["q_linear"].T).reshape(N, N_HEADS, dk)
    k = (allt @ p["k_linear"].T).reshape(L, N, N_HEADS, dk)
    v = (allt @ p["v_linear"].T).reshape(L, N, N_HEADS, dk)
    scores = torch.einsum("nhd,lnhd->nhl", q, k) / math.sqrt(dk)
    decay = _logit_decay(p, cfg, time_diff)
    if decay is not None:
        scores = scores + decay[None, None, :]
    scores = scores + attn_mask.T[:, None, :]
    attn = torch.softmax(scores, dim=-1)
    return _merge_heads(torch.einsum("nhl,lnhd->nhd", attn, v), N, d)


def attention_over_history_compact(p, cfg: TKGConfig, cur, hist_c, act_idx,
                                   act_mask, time_diff, num_ents: int):
    """``attention_over_history`` with the history in compact form: hist_c
    [S, A, d], the slots' entity ids act_idx [S, A] where act_mask [S, A]
    holds. The keys, values and logits run on the S * A slots only; each
    entity's softmax is a segment max and sum over its slots and its
    current row. Rows never active attend only to the current slot, as
    under the dense mask."""
    d = cur.shape[-1]
    dk = d // N_HEADS
    S, A, _ = hist_c.shape
    N = num_ents
    q = (cur @ p["q_linear"].T).reshape(N, N_HEADS, dk)
    k_cur = (cur @ p["k_linear"].T).reshape(N, N_HEADS, dk)
    v_cur = (cur @ p["v_linear"].T).reshape(N, N_HEADS, dk)
    decay = _logit_decay(p, cfg, time_diff)
    if decay is None:
        decay = torch.zeros_like(time_diff)
    sc_cur = (q * k_cur).sum(-1) / math.sqrt(dk) + decay[-1]   # [N, h]
    if S == 0:  # the softmax over the current slot alone
        return _merge_heads(v_cur, N, d)

    hc = hist_c.reshape(S * A, d)
    kc = (hc @ p["k_linear"].T).reshape(S * A, N_HEADS, dk)
    vc = (hc @ p["v_linear"].T).reshape(S * A, N_HEADS, dk)
    amask = act_mask.reshape(S * A)
    # masked slots name the sentinel segment N, dropped below
    ids = torch.where(amask, act_idx.reshape(S * A).long(), N)
    gid = ids.clamp(max=N - 1)
    sc = (q[gid] * kc).sum(-1) / math.sqrt(dk)                 # [S*A, h]
    sc = sc + decay[:S].repeat_interleave(A)[:, None]
    sc = torch.where(amask[:, None], sc, -math.inf)
    # the segment max with -inf for empty segments (include_self over a
    # -inf fill), then with the current slot. It only shifts the softmax,
    # so it takes no gradient; JAX's gradient through it sums to zero
    m = torch.full((N + 1, N_HEADS), -math.inf, device=cur.device,
                   dtype=cur.dtype)
    m = m.scatter_reduce(0, ids[:, None].expand(-1, N_HEADS), sc.detach(),
                         "amax", include_self=True)[:N]
    m = torch.maximum(m, sc_cur.detach())                      # [N, h]
    e = torch.where(amask[:, None], torch.exp(sc - m[gid]), 0.0)
    e_cur = torch.exp(sc_cur - m)
    z = _segment_sum(e, ids, N) + e_cur
    num = _segment_sum(e[..., None] * vc, ids, N)
    out = (num + e_cur[..., None] * v_cur) / z[..., None]      # [N, h, dk]
    return _merge_heads(out, N, d)


def _segment_sum(x, ids, n: int):
    """Sums of the rows of x by ids into n + 1 segments, the last (the
    sentinel's) dropped."""
    out = torch.zeros((n + 1,) + tuple(x.shape[1:]), device=x.device,
                      dtype=x.dtype)
    return out.index_add(0, ids, x)[:n]


def ema_over_history(alpha_logit, cur, hist):
    """The EMA alternative (SARGCN.py:64-83): with a = sigmoid(alpha_logit)
    [d, 1] over the L slots [history..., current], slot l > 0 weighs
    a * (1 - a)^(L-1-l) and the oldest slot (1 - a)^(L-1), the reference's
    (1 - a)^[0..L-1] with all but the last entry times a, reversed."""
    alpha = torch.sigmoid(alpha_logit)                         # [d, 1]
    allt = torch.cat([hist, cur[None]], 0)                     # [L, N, d]
    L = allt.shape[0]
    expo = torch.arange(L, dtype=cur.dtype, device=cur.device)
    ema = torch.pow(1.0 - alpha, expo[None, :])                # [d, L]
    ema = torch.cat([ema[:, :-1] * alpha, ema[:, -1:]], 1)
    return torch.einsum("lnd,dl->nd", allt, ema.flip(1))


class SelfAttentionRGCNModel(DynamicRGCNModel):
    """SARGCN (reference models/SelfAttentionRGCN.py)."""

    bidirectional = False
    partitionable = False
    recurrent = False

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        # the reference forces time embeddings on for the attention models
        # (SARGCN.py:92)
        cfg = cfg.replace(use_time_embedding=True)
        super().__init__(cfg, data, device=device)

    def init_tree(self, gen: torch.Generator) -> Dict[str, Any]:
        cfg, d = self.cfg, self.cfg.embed_size
        p = {"ent_embeds": xavier_uniform(gen, (self.num_ents, d),
                                          RELU_GAIN),
             "rel_embeds": xavier_uniform(gen, (2 * self.num_rels, d),
                                          RELU_GAIN)}
        init1 = init_rgcn_layer if cfg.rec_only_last_layer else (
            init_sargcn_layer)
        p["encoder"] = {"layer1": init1(gen, cfg, self.lc1),
                        "layer2": init_sargcn_layer(gen, cfg, self.lc2)}
        if cfg.ema:
            # the reference's uninitialized torch.Tensor, as zeros
            p["alpha"] = torch.zeros(d, 1)
        return p

    # -- the history ----------------------------------------------------------

    def _static_step(self, params, h0, snap: Snapshot, n: int, train: bool,
                     masks, table=None):
        """The static 2-layer RGCN of the G graphs of `snap` (G = L-1 window
        slots side by side, n rows each; h0 [G * n, d], G copies of
        `table` when given): conv outputs plus each slot's time embedding,
        layer 2 taking layer 1's conv output without it (SARGCN.py:103-107).
        Returns (h1, h2), [G, n, d] each."""
        cfg, enc = self.cfg, params["encoder"]
        G = snap.src.shape[0]
        m1, m2 = (None, None) if masks is None else (
            m.reshape(G * n, -1) for m in masks)
        conv1 = rgcn_conv(enc["layer1"], cfg, self.lc1, h0, snap, train, m1,
                          loop_h=table)
        conv2 = rgcn_conv(enc["layer2"], cfg, self.lc2, conv1, snap, train,
                          m2)
        return tuple(
            c.reshape(G, n, -1) + layer_time_embedding(layer, snap)[:, None]
            for c, layer in ((conv1, enc["layer1"]),
                             (conv2, enc["layer2"])))

    def _history(self, params, win, length: int, train: bool = False,
                 masks=None, edges=None):
        """The history states of one element's window `win` (a
        ``gather_window`` of one target) over its first L-1 slots, every
        slot's graph in one SpMM a layer. Training (`train`) takes the
        self-loop keep masks `masks` (layer 1, layer 2; [L-1, rows, d]
        bool, None without dropout) and under ``random_dropout`` the
        slots' edge subsample `edges` [L-1, E].

        Returns (h1, h2, aux): dense, [L-1, N, d] each (0 on the rows not
        active in a slot, and in slots off the data) and the additive mask
        [L-1, N] (0 active, -10e9 else); compact (``sa_compact``),
        [L-1, A, d] each and (act_idx, act_mask) [L-1, A]."""
        cfg = self.cfg
        L1, N, d = length - 1, self.num_ents, cfg.hidden_size
        A = win.act_idx.shape[-1]
        dev = self.device
        if L1 == 0:  # train_seq_len 1: the attention over [current] only
            rows = A if cfg.sa_compact else N
            z = torch.zeros(0, rows, d, device=dev)
            aux = ((torch.zeros(0, A, dtype=torch.long, device=dev),
                    torch.zeros(0, A, dtype=torch.bool, device=dev))
                   if cfg.sa_compact else torch.zeros(0, N, device=dev))
            return z, z, aux
        emask = win.emask[:L1] if edges is None else edges
        t = win.t_idx[:L1]
        if cfg.sa_compact:
            a_idx, a_mask = win.act_idx[:L1], win.act_mask[:L1]
            snap = Snapshot(src=win.src_loc[:L1], dst=win.dst_loc[:L1],
                            rel=win.rel[:L1], emask=emask, t_idx=t,
                            t_pos=t, compact=True, tables=win.tables)
            h0 = self._rows(params, a_idx).reshape(L1 * A, -1)
            h1, h2 = self._static_step(params, h0, snap, A, train, masks)
            return h1, h2, (a_idx, a_mask)
        snap = Snapshot(src=win.src[:L1], dst=win.dst[:L1], rel=win.rel[:L1],
                        emask=emask, t_idx=t, t_pos=t, tables=win.tables)
        # every slot's layer-1 input is the entity table: L-1 copies side
        # by side, as K1 reads rows b * N + i of graph b
        emb = params["ent_embeds"]
        h0 = emb.expand(L1, N, emb.shape[1]).reshape(L1 * N, -1)
        h1, h2 = self._static_step(params, h0, snap, N, train, masks, emb)
        upd = (win.active[:L1] & win.valid[:L1, None])[..., None]
        mask = torch.where(upd[..., 0], 0.0, NEG_MASK)
        return (torch.where(upd, h1, 0.0), torch.where(upd, h2, 0.0), mask)

    def batch_hists(self, params, data: TKGData, tp, length: int,
                    draws=None, conv1_all=None):
        """The histories of the B targets tp [B], one element at a time:
        (h1s, h2s, auxs), lists of B (``_history``; the Bi model's two
        windows concatenated along the slot axis, forward first). Training
        (`draws` given) takes its window masks and edge subsample.
        `conv1_all` is always None here (``precompute_eval_conv1`` gives
        these models none, as in the JAX package). The parameters are
        rounded once a use for all the elements under a hot dtype
        (``shared_rounding``), as the JAX package's vmap rounds them."""
        if conv1_all is not None:
            raise ValueError("the attention models take no precomputed "
                             "convs")
        train = draws is not None
        out = ([], [], [])
        with shared_rounding(param_leaves(params)) as next_element:
            for b in range(tp.shape[0]):
                next_element()
                parts = []
                for sfx, backward in (("", False), ("_b", True))[
                        :2 if self.bidirectional else 1]:
                    win = gather_window(data, tp[b], length,
                                        backward=backward)
                    masks = edges = None
                    if train and draws[f"win1{sfx}"] is not None:
                        masks = (draws[f"win1{sfx}"][b],
                                 draws[f"win2{sfx}"][b])
                    if train and draws["win_edges"] is not None:
                        edges = draws["win_edges"][b]
                    parts.append(self._history(params, win, length, train,
                                               masks, edges))
                hist = parts[0] if len(parts) == 1 else self._concat(*parts)
                for lst, x in zip(out, hist):
                    lst.append(x)
        return out

    def _concat(self, fwd, bwd):
        """Two windows' (h1, h2, aux) concatenated along the slot axis."""
        h1 = torch.cat([fwd[0], bwd[0]], 0)
        h2 = torch.cat([fwd[1], bwd[1]], 0)
        if self.cfg.sa_compact:
            aux = tuple(torch.cat([x, y], 0) for x, y in zip(fwd[2], bwd[2]))
        else:
            aux = torch.cat([fwd[2], bwd[2]], 0)
        return h1, h2, aux

    def _time_diff(self, length: int):
        """The slots' time differences to the target, [L-1, ..., 1, 0]
        (SelfAttentionRGCN.py:22-23)."""
        return torch.arange(length - 1, -1, -1, dtype=torch.float32,
                            device=self.device)

    # -- training draws -------------------------------------------------------

    def draw_train(self, gen: torch.Generator, data: TKGData, t_pos):
        """Every random draw of one training step for the targets t_pos [B]
        (a tensor on the model's device), from `gen` (on that device):

        - "win1"/"win2" (and the Bi model's backward window's
          "win1_b"/"win2_b"): the history steps' self-loop keep masks,
          [B, L1, rows, d] bool with rows N (dense) or A (``sa_compact``);
          None without dropout;
        - "win_edges": under ``random_dropout`` the history steps' 80%
          edge subsample, [B, L1, E] bool (the unidirectional models only,
          as in JAX); else None;
        - "fin1"/"fin2", "edges", "pos", "neg_tail"/"neg_head": as
          ``DynamicRGCNModel.draw_train``.
        """
        cfg = self.cfg
        tp = t_pos.long()
        B, L1, d = tp.shape[0], self.train_len - 1, cfg.embed_size
        rows = data.act_idx.shape[-1] if cfg.sa_compact else self.num_ents
        rate = self.lc1.dropout
        out = {}
        for sfx in ("", "_b")[:2 if self.bidirectional else 1]:
            for key in ("win1", "win2"):
                out[key + sfx] = (dropout_mask(gen, (B, L1, rows, d), rate,
                                               self.device)
                                  if rate > 0.0 and L1 > 0 else None)
        out["win_edges"] = None
        if cfg.random_dropout and not self.bidirectional and L1 > 0:
            win = gather_window(data, tp, self.train_len)
            out["win_edges"] = subsample_edges(gen, win.emask[:, :L1], 0.8)
        for key in ("fin1", "fin2"):
            out[key] = (dropout_mask(gen, (B, self.num_ents, d), rate,
                                     self.device) if rate > 0.0 else None)
        out["edges"] = subsample_edges(gen, data.train.emask[tp], 0.5)
        out["pos"] = subsample_positives(gen, data.train.emask[tp],
                                         cfg.num_pos_facts)
        out.update(draw_pool(gen, cfg, data, tp))
        return out

    # -- the final step -------------------------------------------------------

    def _attend(self, p, cur, hist, aux, time_diff):
        """The dense or the compact attention of layer params `p`."""
        if self.cfg.sa_compact:
            return attention_over_history_compact(
                p, self.cfg, cur, hist, aux[0], aux[1], time_diff,
                self.num_ents)
        full = torch.cat([aux, torch.zeros(1, self.num_ents,
                                           device=aux.device)], 0)
        return attention_over_history(p, self.cfg, cur, hist, time_diff,
                                      full)

    def _final(self, params, snap: Snapshot, hists, time_diff, train: bool,
               masks):
        """SARGCN.forward_final (SARGCN.py:109-117): each layer's conv (K1
        on the card) attends over its history; JK max-pool of the two
        unless ``rec_only_last_layer``. The inactive rows' layer-2 input is
        layer 1's attention output (SARGCN.forward_isolated), the active
        rows' its conv output: an edge's source is active at its snapshot,
        so one conv gives both paths. Under ``ema`` the inactive rows take
        the EMA over layer 2's history instead (and layer 2's input stays
        the conv output, SARGCN.forward_ema_isolated)."""
        cfg, enc = self.cfg, params["encoder"]
        h1, h2, aux = hists
        conv1 = rgcn_conv(enc["layer1"], cfg, self.lc1, params["ent_embeds"],
                          snap, train, masks[0])
        cur1 = conv1 + layer_time_embedding(enc["layer1"], snap)
        attn1, h2in = None, conv1
        if not cfg.rec_only_last_layer:
            attn1 = self._attend(enc["layer1"], cur1, h1, aux, time_diff)
            if not cfg.ema:
                h2in = torch.where(snap.active[:, None], conv1, attn1)
        conv2 = rgcn_conv(enc["layer2"], cfg, self.lc2, h2in, snap, train,
                          masks[1])
        cur2 = conv2 + layer_time_embedding(enc["layer2"], snap)
        attn2 = self._attend(enc["layer2"], cur2, h2, aux, time_diff)
        out = attn2 if cfg.rec_only_last_layer else torch.maximum(attn1,
                                                                  attn2)
        if cfg.ema:
            ema = ema_over_history(params["alpha"], cur2,
                                   self._dense_history(h2, aux))
            out = torch.where(snap.active[:, None], out, ema)
        return out

    def _dense_history(self, h, aux):
        """The history `h` as dense [S, N, d] rows (compact slots scattered
        to their entities' rows, 0 elsewhere)."""
        if not self.cfg.sa_compact:
            return h
        a_idx, a_mask = aux
        S, A, d = h.shape
        N = self.num_ents
        tgt = torch.where(a_mask, a_idx.long(), N)
        slot = torch.arange(S, device=h.device)[:, None].expand(S, A)
        dense = torch.zeros(S, N + 1, d, device=h.device, dtype=h.dtype)
        return dense.index_put((slot, tgt), h)[:, :N]

    def forward_element(self, params, data: TKGData, t_pos: int, hists=None,
                        train: bool = False, emask=None, masks=(None, None)):
        """Full forward for one target time -> dense [N, d] entity table,
        from its history `hists` (h1, h2, aux; computed here, for eval,
        when not given). `train`, `emask` and `masks` as in
        ``DynamicRGCNModel.forward_element``."""
        length = self.train_len if train else self.eval_len
        if hists is None:
            hists = self.element_hists(params, data, t_pos, length)
        snap = self.final_snapshot(data, t_pos, length, emask)
        table = self._final(params, snap, hists, self._time_diff(length),
                            train, masks)
        return self.embed_non_active(params, snap.active, table, t_pos)


class BiSelfAttentionRGCNModel(SelfAttentionRGCNModel):
    """BiSARGCN (reference models/BiSelfAttentionRGCN.py): the forward and
    the backward window's histories concatenated along the slot axis; the
    history steps always run on their full graphs
    (BiSelfAttentionRGCN.py:38-39)."""

    bidirectional = True

    def _time_diff(self, length: int):
        """[L-1..1, L-1..1, 0] (BiSelfAttentionRGCN.py:19-20)."""
        down = torch.arange(length - 1, 0, -1, dtype=torch.float32,
                            device=self.device)
        return torch.cat([down, down, torch.zeros(1, device=self.device)])
