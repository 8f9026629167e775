"""The RGCN layer family: the static conv, the GRU-recurrent layer (GRRGCN;
BiGRRGCN's owns a GRU for each direction and sums both at the target
snapshot) and the linear-recurrent one (RRGCN; BiRRGCN's owns a time
weight for each direction).

Dense unified formulation: a layer maps the entity rows it is given [M, d_in]
-> [M, d_out] for one snapshot's padded edge list; rows without in-edges get
zero aggregation. Parameters follow the reference: per-relation
block-diagonal weights (xavier-uniform with ReLU gain), optional bias, a
self-loop weight, a per-timestamp time embedding, exponential decay of the
previous state (a fixed rate, or under ``learnable_lambda`` a clamped
Linear(1, 1) of the time difference), and the recurrence: a torch-semantics
GRU (or the reference's type1 cell) fed by the conv output, or in RRGCN
``prev @ time_weight`` times the decay added inside the layer, before bias,
self-loop and activation.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.ops.gru import (
    GRU_KEY, hot_round, init_gru_params, init_type1_gru_params, run_gru,
)
from temp_tpu_torch.ops.segment import rel_spmm


class Snapshot(NamedTuple):
    """One timestamp's graph in the id space of the rows it is applied to;
    or B graphs side by side, edges [B, E] each in its own rows' ids (see
    ``rel_spmm``).

    `t_pos` names the train snapshots the graphs' edges are (their time
    positions, [B] or a scalar, in global ids or, with `compact`, in the
    window's compact slots) in `tables`, the data's static tables of them
    (``ops.segment.data_tables``), so that the SpMM (K1, or K13 under a
    ring partition) walks those tables rather than sort the edges; None
    where the edges are no train snapshot's or the data has no tables."""

    src: torch.Tensor    # [E] or [B, E] int
    dst: torch.Tensor    # [E] or [B, E] int
    rel: torch.Tensor    # [E] or [B, E] int
    emask: torch.Tensor  # [E] or [B, E] bool
    t_idx: Any           # time position (for the time embedding)
    valid: Any = True
    active: Optional[torch.Tensor] = None
    t_pos: Optional[torch.Tensor] = None
    compact: bool = False
    tables: Any = None


@dataclass(frozen=True)
class LayerCfg:
    in_feat: int
    out_feat: int
    num_rels2: int
    n_bases: int
    num_times: int
    bias: bool = True
    activation: Optional[str] = None  # None | 'relu'
    self_loop: bool = True
    dropout: float = 0.0


RELU_GAIN = 1.4142135623730951  # sqrt(2), torch calculate_gain('relu')


def xavier_uniform(gen: torch.Generator, shape, gain: float = 1.0):
    """torch nn.init.xavier_uniform_ bounds: fan_in=shape[1],
    fan_out=shape[0]."""
    fan_out, fan_in = shape[0], shape[1] if len(shape) > 1 else shape[0]
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(tuple(shape), generator=gen) * 2.0 - 1.0) * a


def init_rgcn_layer(gen: torch.Generator, cfg: TKGConfig,
                    lc: LayerCfg) -> Dict[str, Any]:
    si = lc.in_feat // lc.n_bases
    so = lc.out_feat // lc.n_bases
    p: Dict[str, Any] = {
        "weight": xavier_uniform(gen, (lc.num_rels2, lc.n_bases * si * so),
                                 RELU_GAIN),
        "time_embed": xavier_uniform(gen, (lc.num_times, lc.in_feat),
                                     RELU_GAIN),
    }
    if lc.bias:
        p["h_bias"] = torch.zeros(lc.out_feat)
    if lc.self_loop:
        p["loop_weight"] = xavier_uniform(gen, (lc.in_feat, lc.out_feat),
                                          RELU_GAIN)
    if cfg.learnable_lambda:
        # nn.Linear(1, 1)'s default init, U(-1, 1): the recurrent layers'
        # decay (``decay_factor``) and the attention's logit decay
        # (models/selfattn.py)
        for name in ("decay_w", "decay_b"):
            p[name] = torch.rand((), generator=gen) * 2.0 - 1.0
    return p


def init_grrgcn_layer(gen: torch.Generator, cfg: TKGConfig, lc: LayerCfg,
                      bidirectional: bool = False):
    """The conv's parameters and one GRU ("gru"), or one for each direction
    ("gru_fwd", "gru_bwd") when `bidirectional`: a stack of
    ``cfg.num_layers`` standard cells, or under ``type1`` a list of one
    type1 cell."""
    p = init_rgcn_layer(gen, cfg, lc)
    names = ("gru_fwd", "gru_bwd") if bidirectional else ("gru",)
    for name in names:
        p[name] = ([init_type1_gru_params(gen, lc.in_feat, lc.out_feat)]
                   if cfg.type1 else
                   init_gru_params(gen, lc.in_feat, lc.out_feat,
                                   cfg.num_layers))
    return p


# the time weight of a linear-recurrent layer by window direction
TIME_WEIGHT_KEY = {"fwd": "time_weight_fwd", "bwd": "time_weight_bwd",
                   None: "time_weight"}


def init_rrgcn_layer(gen: torch.Generator, cfg: TKGConfig, lc: LayerCfg,
                     bidirectional: bool = False):
    """The conv's parameters and the recurrence's time weight [d_in,
    d_out] ("time_weight"), or one for each direction ("time_weight_fwd",
    "time_weight_bwd") when `bidirectional`; xavier-uniform, ReLU gain."""
    p = init_rgcn_layer(gen, cfg, lc)
    names = ("fwd", "bwd") if bidirectional else (None,)
    for d in names:
        p[TIME_WEIGHT_KEY[d]] = xavier_uniform(gen, (lc.in_feat, lc.out_feat),
                                               RELU_GAIN)
    return p


def _activation(name: Optional[str], x):
    if name is None:
        return x
    if name == "relu":
        return torch.relu(x)
    raise ValueError(name)


def dropout_mask(gen: torch.Generator, shape, rate: float, device):
    """Bernoulli keep mask (True with probability 1 - rate)."""
    return torch.rand(tuple(shape), generator=gen, device=device) < 1.0 - rate


def _dropout(x, rate: float, train: bool, mask=None):
    """Training dropout: kept entries scaled by 1/keep; `mask` (bool, the
    shape of x) is the keep mask (``dropout_mask``)."""
    if not train or rate == 0.0:
        return x
    if mask is None:
        raise ValueError("training dropout needs its keep mask")
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def _aggregate(p, cfg: TKGConfig, lc: LayerCfg, h, snap: Snapshot):
    """The relational aggregation of `snap`'s edges over the rows h (K1 on
    the card; K13 under a "ring_pallas" edge partition). The hot dtype
    goes with it, as the JAX package passes it: K1 takes it under the
    method "pallas" (its bfloat16 mode) and ignores it under "segment",
    the default; the partitioned modes take it (``rel_spmm``)."""
    return rel_spmm(h, snap.src, snap.dst, snap.rel, snap.emask, p["weight"],
                    lc.n_bases, lc.out_feat, h.shape[0], kernels=cfg.kernels,
                    t_pos=snap.t_pos, compact=snap.compact,
                    tables=snap.tables, dtype=cfg.hot_dtype)


def _matmul(x, w, dtype=None):
    """x @ w with optional low-precision inputs and float32 sums: the JAX
    package's ``_matmul`` (``ops.gru._mm`` without the transpose). x may
    be bfloat16 (a history read from the windows' bfloat16 buffers)."""
    return hot_round(x.to(torch.float32), dtype) @ hot_round(w, dtype)


def _bias_loop_act(p, lc: LayerCfg, out, h, train: bool, mask,
                   dtype=None, loop_h=None):
    """out + bias + the self-loop message of h (its product in `dtype`;
    dropout at rate ``lc.dropout`` with the keep mask `mask` in training),
    then the activation. `loop_h`: the rows that h's rows repeat (G graphs
    over one table side by side): the product runs once on them and is
    tiled, as the JAX package's vmap over the graphs leaves it unmapped."""
    if lc.bias:
        out = out + p["h_bias"]
    if lc.self_loop:
        loop = _matmul(h if loop_h is None else loop_h, p["loop_weight"],
                       dtype)
        if loop_h is not None:
            loop = loop.repeat(h.shape[0] // loop_h.shape[0], 1)
        out = out + _dropout(loop, lc.dropout, train, mask)
    return _activation(lc.activation, out)


def rgcn_conv(p, cfg: TKGConfig, lc: LayerCfg, h, snap: Snapshot,
              train: bool = False, mask=None, loop_h=None):
    """Aggregation + bias + self-loop + activation. In training the
    self-loop message takes dropout at rate ``lc.dropout`` with the keep
    mask `mask`. The self-loop product runs in ``cfg.hot_dtype``, once on
    `loop_h` when h's rows repeat it (``_bias_loop_act``); the
    aggregation takes the dtype as ``_aggregate`` says."""
    return _bias_loop_act(p, lc, _aggregate(p, cfg, lc, h, snap), h, train,
                          mask, cfg.hot_dtype, loop_h)


def layer_time_embedding(p, snap: Snapshot):
    """time_embed[t]: [d_in], broadcast over the rows; [G, d_in] for G
    graphs side by side whose t_idx is [G] (``plus_time_embedding``)."""
    return p["time_embed"][snap.t_idx]


def plus_time_embedding(x, temb):
    """x [M, d] plus a time embedding (``layer_time_embedding``): [d] for
    every row, or [G, d] for G graphs side by side, each to its M / G
    rows."""
    if temb.dim() == 1:
        return x + temb
    G, d = temb.shape
    return (x.reshape(G, -1, d) + temb[:, None]).reshape(x.shape)


def decay_factor(p, cfg: TKGConfig, dt):
    """The previous state's decay, dt: [M] -> [M, 1]: exp(-dt * lambda)
    with the fixed ``inv_temperature``, or under ``learnable_lambda``
    exp(-max(decay_w * dt + decay_b, 0)) with the layer's Linear(1, 1)."""
    dt = dt[:, None]
    if cfg.learnable_lambda:
        x = p["decay_w"] * dt + p["decay_b"]
        # torch.maximum splits the gradient at a tie, as jnp.maximum does
        return torch.exp(-torch.maximum(x, torch.zeros_like(x)))
    return torch.exp(-dt * cfg.inv_temperature)


def grrgcn_layer(p, cfg: TKGConfig, lc: LayerCfg, h, snap: Snapshot, prev,
                 dt, conv_in: bool = False, train: bool = False, mask=None,
                 direction=None):
    """GRU-recurrent RGCN layer. Returns (conv_out, rec_out, time_emb).

    ``conv_in=True``: ``h`` already is this layer's conv output (the eval
    reuse of precomputed layer-1 convs); only the GRU runs. `train` and
    `mask` are the conv's self-loop dropout (``rgcn_conv``). `direction`
    ("fwd", "bwd" or None) picks the GRU (``GRU_KEY``).
    """
    conv = h if conv_in else rgcn_conv(p, cfg, lc, h, snap, train, mask)
    h0 = prev * decay_factor(p, cfg, dt)
    rec = run_gru(cfg, p[GRU_KEY[direction]], conv, h0)
    return conv, rec, layer_time_embedding(p, snap)


def bigrrgcn_layer_center(p, cfg: TKGConfig, lc: LayerCfg, h, snap: Snapshot,
                          prev_f, dt_f, prev_b, dt_b, conv_in: bool = False,
                          train: bool = False, mask=None):
    """The Bi layer at the target snapshot, where the two windows meet: the
    conv output into the forward GRU (from the forward window's state) and
    into the backward one (from the backward window's), their outputs
    summed. Returns (conv_out, rec_out, time_emb); `conv_in`, `train` and
    `mask` as in ``grrgcn_layer``."""
    conv = h if conv_in else rgcn_conv(p, cfg, lc, h, snap, train, mask)
    rec = (run_gru(cfg, p["gru_fwd"], conv,
                   prev_f * decay_factor(p, cfg, dt_f))
           + run_gru(cfg, p["gru_bwd"], conv,
                     prev_b * decay_factor(p, cfg, dt_b)))
    return conv, rec, layer_time_embedding(p, snap)


def rrgcn_layer(p, cfg: TKGConfig, lc: LayerCfg, h, snap: Snapshot, prev,
                dt, train: bool = False, mask=None, direction=None):
    """Linear-recurrent RGCN layer (reference models/RRGCN.py:130-151):
    agg + (prev @ time_weight) * decay + bias + self-loop, then the
    activation; the recurrence sits inside the layer. Returns (agg, out,
    time_emb), agg the aggregation alone (the layer's "local" output).
    `train` and `mask` are the self-loop's dropout; `direction` picks the
    time weight (``TIME_WEIGHT_KEY``). The time weight's and the
    self-loop's products run in ``cfg.hot_dtype``, the decay in
    float32."""
    hot = cfg.hot_dtype
    agg = _aggregate(p, cfg, lc, h, snap)
    rec = (_matmul(prev, p[TIME_WEIGHT_KEY[direction]], hot)
           * decay_factor(p, cfg, dt))
    return (agg, _bias_loop_act(p, lc, agg + rec, h, train, mask, hot),
            layer_time_embedding(p, snap))


def birrgcn_layer_center(p, cfg: TKGConfig, lc: LayerCfg, h, snap: Snapshot,
                         prev_f, dt_f, prev_b, dt_b, train: bool = False,
                         mask=None):
    """The BiRRGCN layer at the target snapshot (reference
    models/BiRRGCN.py:115-140): both directions' decayed states through
    their time weights, added to the aggregation before bias, self-loop
    and activation. Returns (agg, out, time_emb); `train` and `mask` as in
    ``rrgcn_layer``, the products in ``cfg.hot_dtype`` as there."""
    hot = cfg.hot_dtype
    agg = _aggregate(p, cfg, lc, h, snap)
    out = (agg + _matmul(prev_f * decay_factor(p, cfg, dt_f),
                         p["time_weight_fwd"], hot)
           + _matmul(prev_b * decay_factor(p, cfg, dt_b),
                     p["time_weight_bwd"], hot))
    return (agg, _bias_loop_act(p, lc, out, h, train, mask, hot),
            layer_time_embedding(p, snap))
