"""DynamicRGCN: the unidirectional recurrent pipeline (GRRGCN, RRGCN).

For a batch of target times the history window (the L-1 snapshots before
each target) runs in compact form: every step computes only the active rows
of its snapshot, and "entity e's state at its last active step" is a gather
resolved by the precomputed HistoryTables. The final snapshot then runs over
all N entities against the densified history and gives the [N, d] table
that the decoder scores.

Tensors carry an explicit batch dimension where the JAX package vmaps.

Training runs the final step and loss of the whole batch as one call of
kernels K3-K5 (``ops/fused_final.py``) when ``fused_final`` is on and the
config lies inside their envelope, else one element at a time
(``forward_element`` and ``train_loss_single``), as the JAX package does.
Eval does the same with kernel K11 when ``fused_eval`` is on, and with
``fused_window_mb`` on the windows run through K12
(``ops/fused_window_mb.py``) where the JAX package runs its batched window.

Inside an edge partition (``parallel/edge_partition.py``
``EdgePartitionedModel``) every fused path is off, as in the JAX package:
the windows and final steps run step by step through ``rel_spmm``, which
partitions each SpMM over the ranks (the ring modes through K13, the
boundary exchange through K1 a rank), and the final step's table passes
``boundary_gather`` where the JAX package re-replicates it.

Training draws every random choice of a step up front (``draw_train``):
the self-loop dropout masks of the window and of the final step, the
window steps' edge masks (``random_dropout``'s 80% subsample, or DropEdge's
frequency-driven drops under ``edge_dropout``, from the rates built once at
model build, ``data/frequency.py``), the 50% edge subsample of the final
snapshot and the positive subset of the loss. ``loss`` takes them as the
optional `draws`, so a test can hand the model the JAX package's own
draws. Windows with edge masks, RRGCN's windows and those under the
options K2 does not take (``type1``, ``learnable_lambda``, time embeddings,
``rec_only_last_layer``) run step by step (K1 for every graph product);
the final step still runs fused through K3-K5 where its envelope holds.
"""

from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Sequence

import numpy as np
import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.frequency import build_drop_rates
from temp_tpu_torch.data.snapshots import (
    AnswerLists, HistoryTables, TKGData, build_answer_lists,
    build_history_tables, to_device,
)
from temp_tpu_torch.models.encoders import (
    _base_module, encoder_forward, init_encoder, make_layer_cfgs,
)
from temp_tpu_torch.models.layers import (
    RELU_GAIN, Snapshot, dropout_mask, rgcn_conv, xavier_uniform,
)
from temp_tpu_torch.models.objectives import (
    draw_pool, element_neg, eval_ranks_single, train_loss_single,
)
from temp_tpu_torch.ops.fused_final import (
    final_graph, final_graph_eval, final_weights, fused_eval_ranks,
    fused_eval_ranks_plain, fused_eval_supported, fused_final_loss,
    fused_final_supported,
)
from temp_tpu_torch.ops.fused_window import (
    fused_window_scan, fused_window_supported,
)
from temp_tpu_torch.ops.fused_window_mb import fused_window_scan_mb
from temp_tpu_torch.ops.gru import shared_rounding
from temp_tpu_torch.ops.sampling import subsample_edges, subsample_positives
from temp_tpu_torch.ops.scores import get_score_fn
from temp_tpu_torch.ops.segment import data_tables
from temp_tpu_torch.parallel.mesh import boundary_gather, manual_axis
from temp_tpu_torch.train.optim import param_leaves


class WindowSlice(NamedTuple):
    """Stacked window of L snapshots; leading dims are those of t_pos."""

    src: torch.Tensor       # [..., L, E] global ids
    rel: torch.Tensor       # [..., L, E]
    dst: torch.Tensor       # [..., L, E]
    emask: torch.Tensor     # [..., L, E]
    t_idx: torch.Tensor     # [..., L] time position (clipped)
    valid: torch.Tensor     # [..., L] bool
    active: torch.Tensor    # [..., L, N]
    act_idx: torch.Tensor   # [..., L, A]
    act_mask: torch.Tensor  # [..., L, A]
    src_loc: torch.Tensor   # [..., L, E] src position within act_idx row
    dst_loc: torch.Tensor   # [..., L, E]
    tables: Any = None      # the data's SpMM tables (``data_tables``)


def _window_positions(t_pos, length: int, num_times: int, backward: bool):
    offs = torch.arange(length, device=t_pos.device)
    t = t_pos.long()[..., None]
    if backward:
        wpos = t + (length - 1) - offs
        valid = wpos <= num_times - 1
    else:
        wpos = t - (length - 1) + offs
        valid = wpos >= 0
    return wpos.clamp(0, num_times - 1), valid


def gather_window(data: TKGData, t_pos, length: int,
                  backward: bool = False) -> WindowSlice:
    """Positions [t-L+1 .. t] (forward) or [t+L-1 .. t] (backward): the
    window always ends at the target snapshot. `data` holds tensors."""
    safe, valid = _window_positions(t_pos, length, data.num_times, backward)
    tr = data.train
    return WindowSlice(
        src=tr.src[safe], rel=tr.rel[safe], dst=tr.dst[safe],
        emask=tr.emask[safe] & valid[..., None],
        t_idx=safe, valid=valid,
        active=data.active[safe] & valid[..., None],
        act_idx=data.act_idx[safe],
        act_mask=data.act_mask[safe] & valid[..., None],
        src_loc=data.train_src_loc[safe], dst_loc=data.train_dst_loc[safe],
        tables=data_tables(data),
    )


class DynamicRGCNModel:
    """GRRGCN and RRGCN (reference models/DynamicRGCN.py)."""

    # whether the windows carry the third (local) history stream
    with_loc = False
    # whether the model runs under an edge partition (``parallel/``): the
    # Bi models say for themselves, the other subclasses do not yet
    partitionable = True
    # whether the model runs recurrent windows (their history tables and
    # the fused final step's answer lists); the attention models do not
    recurrent = True

    def __init__(self, cfg: TKGConfig, data: TKGData, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.num_ents = data.num_ents
        self.num_rels = data.num_rels
        self.num_times = data.num_times
        self.lc1, self.lc2 = make_layer_cfgs(cfg, data.num_rels,
                                             data.num_times)
        self.train_len = cfg.train_seq_len
        # recurrent models evaluate with the training window length
        # (reference models/DynamicRGCN.py:18)
        self.eval_len = cfg.train_seq_len
        self.score_all, self.score_single = get_score_fn(cfg.score_function)
        self.tbl_fwd = self.tbl_bwd = self.answers = None
        if self.recurrent:
            self.tbl_fwd = to_device(build_history_tables(data,
                                                          self.train_len),
                                     self.device)
            # the Bi models' backward-direction windows run over their own
            # tables
            if cfg.module.startswith("Bi"):
                self.tbl_bwd = to_device(build_history_tables(
                    data, self.train_len, backward=True), self.device)
            # the train edge slots' true answers, the fused loss's mask
            self.answers = to_device(build_answer_lists(data), self.device)
        # DropEdge's per-(target, window step, edge) drop rates of the
        # forward windows and (the Bi models) the backward ones, built on
        # the host once; their seconds in drop_rates_s
        self.drop_past = self.drop_future = self.drop_rates_s = None
        if self.recurrent and cfg.edge_dropout:
            t0 = time.perf_counter()
            past, future = build_drop_rates(
                data, cfg.train_seq_len, cfg.module.startswith("Bi"),
                cfg.rate_lower, cfg.rate_upper, cfg.lambda_1, cfg.lambda_2,
                cfg.lambda_3)
            self.drop_past = torch.from_numpy(past).to(self.device)
            self.drop_future = torch.from_numpy(future).to(self.device)
            self.drop_rates_s = time.perf_counter() - t0
        # the eval splits' query slots' (total table), the fused eval's
        self.eval_answers: Dict[str, AnswerLists] = {
            split: to_device(build_answer_lists(data, split), self.device)
            for split in ("valid", "test")} if self.fused_eval_on() else {}

    # -- parameters ---------------------------------------------------------

    def init_params(self, seed: int) -> Dict[str, Any]:
        """Seeded init (drawn on the CPU, then moved to the model's device,
        so a seed gives the same weights on every device)."""
        gen = torch.Generator().manual_seed(int(seed))
        return _tree_to(self.init_tree(gen), self.device)

    def init_tree(self, gen: torch.Generator) -> Dict[str, Any]:
        """The parameter tree on the CPU, drawn from `gen` in order."""
        d = self.cfg.embed_size
        return {
            "ent_embeds": xavier_uniform(gen, (self.num_ents, d), RELU_GAIN),
            "rel_embeds": xavier_uniform(gen, (2 * self.num_rels, d),
                                         RELU_GAIN),
            "encoder": init_encoder(gen, self.cfg, self.num_rels,
                                    self.num_times),
        }

    # -- forward ------------------------------------------------------------

    def _rows(self, params, idx):
        """Input features of entity ids; the padding id num_ents reads the
        last row, as a clamped gather does in the JAX package."""
        return params["ent_embeds"][idx.long().clamp(max=self.num_ents - 1)]

    def input_embeddings(self, params, t_pos):
        """The input entity features [N, d] at time position t_pos (an int
        or a 0-d tensor): the final step's layer-1 input and the inactive
        rows' under ``use_embed_for_non_active``. TimeDynamicRGCN and
        DRGCN make them time-dependent."""
        return params["ent_embeds"]

    def input_embeddings_rows(self, params, t_idx, rows):
        """The input features [..., A, d] of the entity ids rows [..., A]
        at the time positions t_idx [...] (the window steps' clamped
        positions): the windows' layer-1 input, whose gradient K2b
        returns. The padding id num_ents reads the last row (``_rows``)."""
        return self._rows(params, rows)

    def fused_window_on(self, train: bool = False) -> bool:
        """Whether the windows run through K2; off under a partition."""
        return (self.cfg.fused_window_on(self.device)
                and manual_axis() is None
                and fused_window_supported(
                    self.cfg, _base_module(self.cfg.module),
                    self.lc2.activation, train=train))

    def fused_final_on(self) -> bool:
        """Whether training runs the final step and loss through K3-K5 (the
        dispatch of the JAX package's ``DynamicRGCNModel.loss``); off under
        a partition."""
        return (self.cfg.fused_final_on(self.device)
                and manual_axis() is None
                and type(self) is DynamicRGCNModel
                and fused_final_supported(
                    self.cfg, _base_module(self.cfg.module),
                    self.lc2.activation))

    def fused_window_mb_on(self, length: int, train: bool = False) -> bool:
        """Whether the windows of a batch run through the batched window
        (K12): the dispatch of the JAX package's ``_use_mb`` and its
        callers. The fused window is on and takes the config, the window
        has steps, and training runs the fused final step (the batched
        window only with it, as in JAX) or eval runs ``DynamicRGCNModel``
        itself."""
        if not (self.cfg.fused_window_mb_on(self.device) and length > 1
                and self.fused_window_on(train)):
            return False
        return self.fused_final_on() if train else (
            type(self) is DynamicRGCNModel)

    def fused_eval_on(self) -> bool:
        """Whether eval runs the final step and ranks through K11 (the
        dispatch of the JAX package's ``eval_ranks``); the other models
        evaluate one element at a time, as in JAX; off under a
        partition."""
        return (self.cfg.fused_eval_on(self.device)
                and manual_axis() is None
                and type(self) is DynamicRGCNModel
                and not self.cfg.use_time_embedding
                and fused_eval_supported(
                    self.cfg, _base_module(self.cfg.module),
                    self.lc2.activation))

    def precompute_eval_conv1(self, params, data: TKGData):
        """Layer-1 conv outputs for ALL train snapshots, compact [T, A, d].

        Layer 1's input is the static entity embedding, so with eval's
        deterministic graphs each snapshot's conv1 is the same in every
        window that holds it: computed once per eval sweep, as one SpMM over
        the T snapshots laid side by side. None when the table would take
        more than 256 MB; for the subclasses (the Post models), whose
        eval threads its own windows, as in the JAX package; where layer 1
        is no GRU layer fed by the conv alone (RRGCN, whose recurrence sits
        inside the layer, and ``rec_only_last_layer``) or its output takes
        a time embedding; and under an edge partition (the config's or an
        active one), whose windows run every SpMM through the partition.
        """
        cfg = self.cfg
        T, A = data.act_idx.shape
        d = cfg.embed_size
        if (type(self) is not DynamicRGCNModel
                or _base_module(cfg.module) != "GRRGCN"
                or cfg.rec_only_last_layer or cfg.use_time_embedding
                or T * A * d * 4 > 256 * 2**20
                or cfg.edge_partition_mode is not None
                or manual_axis() is not None):
            return None
        # the T snapshots side by side, each named in compact slots
        snap = Snapshot(src=data.train_src_loc, dst=data.train_dst_loc,
                        rel=data.train.rel, emask=data.train.emask, t_idx=0,
                        t_pos=torch.arange(T, device=self.device),
                        compact=True, tables=data_tables(data))
        h = self._rows(params, data.act_idx.reshape(-1))
        return rgcn_conv(params["encoder"]["layer1"], cfg, self.lc1, h,
                         snap).reshape(T, A, d)

    def _window_conv1(self, conv1_all, t_pos, length: int):
        """[B, L1, A, d] slice of the conv1 table for each window."""
        safe, _ = _window_positions(t_pos, length, self.num_times, False)
        return conv1_all[safe[..., :length - 1]]

    def _tables_for(self, direction) -> HistoryTables:
        """The history tables of a window direction ("bwd": the Bi models'
        backward windows; "fwd" or None: the forward ones)."""
        return self.tbl_bwd if direction == "bwd" else self.tbl_fwd

    def pre_forward(self, params, win: WindowSlice, length: int, t_pos,
                    conv1_xs=None, train: bool = False, masks=None,
                    direction=None, with_loc: bool = False, edges=None):
        """Run the first length-1 snapshots of B windows (win and t_pos with
        a leading batch dim). Returns (hist1, hist2[, hist_loc], last_pos):
        [B, N, d] each and [B, N], the history each entity carries into the
        final step; hist_loc (``with_loc``) is layer 2's local output at the
        entity's last active step.

        `conv1_xs` [B, L1, A, d]: precomputed layer-1 convs of the window
        steps (eval); layer 1's SpMM is then skipped. `masks` (train): the
        self-loop keep masks of layer 1 and layer 2, each bool
        [B, L1, A, d], or None without dropout. `edges` (train): the steps'
        edge masks [B, L1, E] bool (``random_dropout``, ``edge_dropout``),
        or None for the window's own. `direction` "bwd" runs a backward
        window (``gather_window(backward=True)``) on the backward weights
        (gru_bwd, time_weight_bwd) and the backward history tables; "fwd"
        the forward one on the forward weights (the Bi models); None the
        unidirectional model's.
        """
        if not self.partitionable and manual_axis() is not None:
            raise NotImplementedError(
                f"{type(self).__name__} ({self.cfg.module}) under an edge "
                f"partition is not ported yet; see ROADMAP.md Queue 1 items "
                f"8-9")
        cfg = self.cfg
        d = cfg.embed_size
        L1 = length - 1
        B = t_pos.shape[0]
        N = self.num_ents
        A = win.act_idx.shape[-1]
        n_buf = 3 if with_loc else 2
        store = cfg.hot_dtype or torch.float32
        if L1 == 0:
            zeros = tuple(torch.zeros(B, N, d, device=self.device,
                                      dtype=store) for _ in range(n_buf))
            return zeros + (torch.zeros(B, N, device=self.device),)
        tbl = self._tables_for(direction)
        tp = t_pos.long()
        prev_step = tbl.prev_step[tp].long()          # [B, L1, A]
        prev_row = tbl.prev_row[tp].long()
        conv1_in = conv1_xs is not None
        h0_xs = conv1_xs if conv1_in else self.input_embeddings_rows(
            params, win.t_idx[:, :L1], win.act_idx[:, :L1])
        bidx = torch.arange(B, device=self.device)[:, None]

        if masks is not None and masks[0] is None:
            masks = None
        emask = win.emask if edges is None else edges
        if self.fused_window_on(train):
            if edges is not None:
                raise ValueError("K2 takes no per-step edge masks")
            pos = torch.arange(L1, device=self.device)[None, :, None]
            dt = (pos - prev_step.clamp(min=0)).to(torch.float32)
            keep = 1.0 - self.lc1.dropout
            scaled = None if masks is None else tuple(
                m.to(torch.float32) / keep for m in masks)
            edges = (win.src_loc[:, :L1], win.dst_loc[:, :L1],
                     win.rel[:, :L1], win.emask[:, :L1], prev_step,
                     prev_row, dt, prev_step >= 0)
            if self.fused_window_mb_on(length, train):
                bufs = fused_window_scan_mb(
                    params["encoder"], cfg, self.lc2, h0_xs, *edges, scaled,
                    train, n_buf, direction=direction, conv1_in=conv1_in,
                    kernels=cfg.kernels)
            else:
                bufs = fused_window_scan(
                    params["encoder"], cfg, h0_xs, *edges, conv1_in=conv1_in,
                    kernels=cfg.kernels, masks=scaled, direction=direction,
                    activation2=self.lc2.activation, n_buf=n_buf)
        else:
            bufs = tuple(torch.zeros(B, L1, A, d, device=self.device,
                                     dtype=store)
                         for _ in range(n_buf))
            for k in range(L1):
                pstep = prev_step[:, k]
                gidx = pstep.clamp(min=0) * A + prev_row[:, k]
                # in the buffers' dtype, as the JAX scan's step; the
                # store below rounds each output to it, and its
                # transpose hands the step a cotangent in that dtype
                live = (pstep >= 0).to(store)[..., None]
                h1 = bufs[0].reshape(B, L1 * A, d)[bidx, gidx] * live
                h2 = bufs[1].reshape(B, L1 * A, d)[bidx, gidx] * live
                dt = (k - pstep.clamp(min=0)).to(torch.float32)
                # the B graphs side by side (rel_spmm), each in its own
                # compact ids at its own time position
                snap = Snapshot(src=win.src_loc[:, k], dst=win.dst_loc[:, k],
                                rel=win.rel[:, k], emask=emask[:, k],
                                t_idx=win.t_idx[:, k], t_pos=win.t_idx[:, k],
                                compact=True, tables=win.tables)
                step_masks = (None, None) if masks is None else tuple(
                    m[:, k].reshape(B * A, d) for m in masks)
                outs = encoder_forward(
                    params["encoder"], cfg, self.lc1, self.lc2,
                    h0_xs[:, k].reshape(B * A, d), snap,
                    h1.reshape(B * A, d), h2.reshape(B * A, d),
                    dt.reshape(-1), conv1_in=conv1_in,
                    train=masks is not None, masks=step_masks,
                    direction=direction)
                for buf, out in zip(bufs, outs):
                    buf[:, k] = out.reshape(B, A, d)

        # densify once: hist[e] = output at e's last active step, else 0
        fin_step = tbl.fin_step[tp].long()            # [B, N]
        fidx = fin_step.clamp(min=0) * A + tbl.fin_row[tp].long()
        has = (fin_step >= 0)[..., None]
        hists = tuple(
            buf.reshape(B, L1 * A, d)[bidx, fidx] * has.to(buf.dtype)
            for buf in bufs)
        return hists + (fin_step.clamp(min=0).to(torch.float32),)

    def final_snapshot(self, data: TKGData, t_pos: int, length: int,
                       emask=None) -> Snapshot:
        """The target snapshot t_pos, the last of a window of `length`, on
        `emask` [E] bool (its train edges when None; the 50% subsample in
        training)."""
        tp = torch.tensor(int(t_pos), device=self.device)
        win = gather_window(data, tp, length)
        last = length - 1
        return Snapshot(src=win.src[last], dst=win.dst[last],
                        rel=win.rel[last],
                        emask=win.emask[last] if emask is None else emask,
                        t_idx=win.t_idx[last], valid=win.valid[last],
                        active=win.active[last], t_pos=win.t_idx[last],
                        tables=win.tables)

    def element_hists(self, params, data: TKGData, t_pos: int, length: int):
        """One target's history (eval), as ``batch_hists`` gives it."""
        tp = torch.tensor([int(t_pos)], device=self.device)
        return tuple(h[0] for h in self.batch_hists(params, data, tp,
                                                    length))

    def forward_element(self, params, data: TKGData, t_pos: int, hists=None,
                        train: bool = False, emask=None, masks=(None, None)):
        """Full forward for one target time -> dense [N, d] entity table.
        `hists`: this element's (hist1, hist2, last_pos) from a batched
        pre_forward; computed here (eval) when not given.

        Training (`train`, with `hists` given) runs the final snapshot on
        `emask` [E] bool, the 50% subsample of its edges, and self-loop
        dropout with the keep masks `masks` (layer 1, layer 2; [N, d] bool,
        None without dropout); ``draw_train`` draws them.
        """
        length = self.train_len if train else self.eval_len
        if hists is None:
            hists = self.element_hists(params, data, t_pos, length)
        hist1, hist2, last_pos = hists
        snap = self.final_snapshot(data, t_pos, length, emask)
        dt = (length - 1) - last_pos
        emb = self.input_embeddings(params, t_pos)
        _, out2, _ = encoder_forward(params["encoder"], self.cfg, self.lc1,
                                     self.lc2, emb, snap, hist1, hist2, dt,
                                     train=train, masks=masks)
        return self.embed_non_active(params, snap.active,
                                     boundary_gather(out2), t_pos)

    def embed_non_active(self, params, active, table, t_pos):
        """`table` with the rows of the entities not `active` [N] replaced
        by their input embeddings at t_pos when
        ``use_embed_for_non_active``."""
        if not self.cfg.use_embed_for_non_active:
            return table
        return torch.where(active[:, None], table,
                           self.input_embeddings(params, t_pos))

    # -- training -----------------------------------------------------------

    def draw_train(self, gen: torch.Generator, data: TKGData, t_pos):
        """Every random draw of one training step for the targets t_pos [B]
        (a tensor on the model's device), from `gen` (on that device):

        - "win1"/"win2": the window's self-loop keep masks, [B, L1, A, d]
          bool (None without dropout, and in a model without windows);
        - "win_edges": the window steps' edge masks, [B, L1, E] bool
          (``window_edges``; None without ``random_dropout`` or
          ``edge_dropout``);
        - "fin1"/"fin2": the final step's, [B, N, d] bool (None without);
        - "edges": the final snapshot's 50% edge subsample, [B, E] bool;
        - "pos": the loss's positive subset, [B, E] bool;
        - "neg_tail"/"neg_head": the loss's negative candidates
          (``draw_pool``; None under the "all" pool).
        """
        cfg = self.cfg
        tp = t_pos.long()
        B, L1, d = tp.shape[0], self.train_len - 1, cfg.embed_size
        A = data.act_idx.shape[-1]
        rate = self.lc1.dropout
        out = {"win1": None, "win2": None, "fin1": None, "fin2": None,
               "win_edges": self.window_edges(gen, data, tp)}
        if rate > 0.0:
            if L1 > 0 and self.recurrent:
                for key in ("win1", "win2"):
                    out[key] = dropout_mask(gen, (B, L1, A, d), rate,
                                            self.device)
            for key in ("fin1", "fin2"):
                out[key] = dropout_mask(gen, (B, self.num_ents, d), rate,
                                        self.device)
        out["edges"] = subsample_edges(gen, data.train.emask[tp], 0.5)
        out["pos"] = subsample_positives(gen, data.train.emask[tp],
                                         cfg.num_pos_facts)
        out.update(draw_pool(gen, cfg, data, tp))
        return out

    def window_edges(self, gen: torch.Generator, data: TKGData, tp,
                     direction=None):
        """The training edge masks [B, L1, E] bool of the windows of the
        targets tp [B] (the backward ones for `direction` "bwd"): under
        ``edge_dropout`` each edge kept when a uniform draw is at least its
        DropEdge rate (the forward windows' rates, or the backward ones');
        else under ``random_dropout`` an 80% subsample of each step's
        edges; else (and in a model without windows) None."""
        cfg = self.cfg
        L1 = self.train_len - 1
        if not (self.recurrent and L1 > 0
                and (cfg.edge_dropout or cfg.random_dropout)):
            return None
        emask = gather_window(data, tp, self.train_len,
                              backward=direction == "bwd").emask[:, :L1]
        if cfg.edge_dropout:
            rates = (self.drop_future if direction == "bwd"
                     else self.drop_past)[tp]
            return emask & (torch.rand(emask.shape, generator=gen,
                                       device=emask.device) >= rates)
        return subsample_edges(gen, emask, 0.8)

    def batch_hists(self, params, data: TKGData, tp, length: int,
                    draws=None, conv1_all=None):
        """The history of B targets tp [B] (a tensor on the model's device)
        as ``pre_forward`` gives it: (hist1, hist2, last_pos). Training
        (`draws` given) takes its window masks and edge masks; eval may
        gather layer 1's convs from `conv1_all`
        (``precompute_eval_conv1``)."""
        c1 = (None if conv1_all is None
              else self._window_conv1(conv1_all, tp, length))
        masks = None if draws is None else (draws["win1"], draws["win2"])
        return self.pre_forward(params, gather_window(data, tp, length),
                                length, tp, conv1_xs=c1,
                                train=draws is not None, masks=masks,
                                with_loc=self.with_loc,
                                edges=None if draws is None
                                else draws.get("win_edges"))

    def fused_final_losses(self, params, data: TKGData, tp, draws, hists):
        """The final steps and losses of the B targets tp as one call of
        K3-K5 (``fused_final_loss``): the loss of each element, [B]."""
        cfg = self.cfg
        hist1, hist2, last_pos = hists
        gr = final_graph(data, self.answers, tp, draws, last_pos,
                         cfg.inv_temperature, self.lc2.dropout,
                         self.train_len, cfg.use_embed_for_non_active)
        return fused_final_loss(params, gr, hist1, hist2,
                                kernels=cfg.kernels, hot=cfg.hot_dtype)

    def loss(self, params, data: TKGData, t_pos, t_valid,
             gen: torch.Generator = None, draws=None):
        """Summed tail+head CE over the batch: the sum over b of the
        per-element loss times t_valid[b] (reference DynamicRGCN.py:176-194).

        `draws` (see ``draw_train``) fixes every random choice; drawn from
        `gen` when None. The history windows of all B targets run as one
        batch (``batch_hists``; K2 with its backward on the card). The final
        steps and losses of all B follow as one call of the fused final-step
        kernels (``fused_final_on``, ``fused_final_losses``), each element's
        loss times t_valid[b]; or else one target at a time (K1), elements
        whose t_valid is False skipped (their term is zero).
        """
        t_host = [int(t) for t in np.asarray(t_pos)]
        tv = [bool(v) for v in np.asarray(t_valid)]
        tp = torch.tensor(t_host, device=self.device)
        if draws is None:
            draws = self.draw_train(gen, data, tp)
        hists = self.batch_hists(params, data, tp, self.train_len, draws)
        if self.fused_final_on():
            losses = self.fused_final_losses(params, data, tp, draws, hists)
            tvt = torch.tensor(tv, device=self.device, dtype=losses.dtype)
            return (losses * tvt).sum()
        return self.unfused_final_loss(params, data, t_host, tv, hists,
                                       draws)

    def unfused_final_loss(self, params, data: TKGData, t_host, tv, hists,
                           draws):
        """The final steps and losses of the targets t_host one at a time
        (``element_loss``; K1 on the card), summed over the elements whose
        tv is True. `hists`: the batch's ``batch_hists``; `draws` as in
        ``loss``. The parameters are rounded once for all the elements
        (``shared_rounding``), as the JAX package's vmap over them
        rounds them."""
        total = torch.zeros((), device=self.device)
        with shared_rounding(param_leaves(params)) as next_element:
            for b, t in enumerate(t_host):
                if not tv[b]:
                    continue
                next_element()
                fin = (None, None) if draws["fin1"] is None else (
                    draws["fin1"][b], draws["fin2"][b])
                total = total + self.element_loss(
                    params, data, t, tuple(h[b] for h in hists),
                    draws["edges"][b], fin, draws["pos"][b],
                    element_neg(draws, b))
        return total

    def element_loss(self, params, data: TKGData, t_pos: int, hists, emask,
                     masks, pos, neg=None):
        """One target's training loss from its history `hists`, on the
        edge subsample `emask` with the self-loop keep masks `masks`, over
        the positives `pos` and the negative candidates `neg` (``draw_pool``
        of this element; None under the "all" pool) (``forward_element``,
        ``train_loss_single``)."""
        tr = data.train
        table = self.forward_element(params, data, t_pos, hists=hists,
                                     train=True, emask=emask, masks=masks)
        return train_loss_single(
            self.cfg, data, self.score_all, params["rel_embeds"], table,
            t_pos, tr.src[t_pos], tr.rel[t_pos], tr.dst[t_pos], pos, neg)

    # -- objectives ---------------------------------------------------------

    def eval_ranks(self, params, data: TKGData, t_pos: Sequence[int],
                   t_valid: Sequence[bool], split: str, conv1_all=None):
        """Filtered ranks for a batch of target times. Returns (ranks
        [B, 2Q], mask [B, 2Q], mean bce loss).

        `conv1_all` [T, A, d]: the precomputed layer-1 convs
        (precompute_eval_conv1), gathered by every window step. With
        ``fused_eval_on`` the final steps and ranks of all B targets run as
        one call of K11 (which runs layer 1 of the final snapshot itself),
        else one target at a time."""
        t_host = [int(t) for t in np.asarray(t_pos)]
        tp = torch.tensor(t_host, device=self.device)
        tv = torch.as_tensor(np.asarray(t_valid, bool), device=self.device)
        hists = self.batch_hists(params, data, tp, self.eval_len,
                                 conv1_all=conv1_all)
        if self.fused_eval_on():
            hist1, hist2, last_pos = hists
            gr, q = final_graph_eval(
                data, self.eval_answers[split], tp, last_pos,
                self.cfg.inv_temperature, self.eval_len,
                self.cfg.use_embed_for_non_active, split)
            h0, wrel, loop1, loop2, g1, g2, rtab = final_weights(params)
            run = fused_eval_ranks if self.cfg.kernels else (
                fused_eval_ranks_plain)
            ranks, mask, bces = run(h0, hist1.contiguous(),
                                    hist2.contiguous(), gr, q, wrel, loop1,
                                    loop2, g1, g2, rtab,
                                    hot=self.cfg.hot_dtype)
            mask = mask & tv[:, None]
            return ranks, mask, _mean_bce(bces, mask)
        out = [self.element_ranks(params, data, t,
                                  tuple(h[b] for h in hists), split)
               for b, t in enumerate(t_host)]
        ranks = torch.stack([o[0] for o in out])
        mask = torch.stack([o[1] for o in out]) & tv[:, None]
        return ranks, mask, _mean_bce(torch.stack([o[2] for o in out]), mask)

    def element_ranks(self, params, data: TKGData, t_pos: int, hists,
                      split: str):
        """One target's (ranks [2Q], mask [2Q], bce) on `split` from its
        history `hists` (``forward_element``, ``eval_ranks_single``)."""
        edges = getattr(data, split)
        table = self.forward_element(params, data, t_pos, hists=hists)
        return eval_ranks_single(
            self.cfg, data, self.score_all, self.score_single,
            params["rel_embeds"], table, t_pos, edges.src[t_pos],
            edges.rel[t_pos], edges.dst[t_pos], edges.emask[t_pos])


def _mean_bce(bces, mask):
    """The mean of the per-element BCEs over the elements with a query."""
    has_q = (mask.sum(1) > 0).to(torch.float32)
    return (bces * has_q).sum() / has_q.sum().clamp(min=1.0)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)
