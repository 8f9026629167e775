"""Two-layer temporal encoder containers: the recurrent ones (GRRGCN,
RRGCN and their Bi forms) and the static RGCN (SRGCN, DRGCN).

- recurrent: layer 1 maps embed -> hidden and layer 2 hidden -> hidden, both
  without bias; layer 2 has no activation in the unidirectional models and
  a ReLU in the Bi models, whose layers own their recurrence for each
  direction. Both layers' outputs are history state. Under
  ``rec_only_last_layer`` layer 1 is a plain conv. Under
  ``use_time_embedding`` each recurrent layer's output takes its time
  embedding, and the value stored in the history includes it (the
  reference mutates ndata['h']).
- static (``static_rgcn_forward``): biased layers, a ReLU on layer 2, the
  time embedding added to layer 2's output only.

The recurrent forward returns (out1, out2, local2): the two history states
and layer 2's "local" output (GRRGCN's pre-GRU conv output, RRGCN's
aggregation) that the Post models' windows carry. The self-attention
modules' layers (bias on both, a ReLU on layer 2) are made in
``models/selfattn.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.models.layers import (
    LayerCfg, Snapshot, bigrrgcn_layer_center, birrgcn_layer_center,
    decay_factor, grrgcn_layer, init_grrgcn_layer, init_rgcn_layer,
    init_rrgcn_layer, layer_time_embedding, plus_time_embedding, rgcn_conv,
    rrgcn_layer,
)
from temp_tpu_torch.ops.gru import GRU_KEY, run_gru


def _base_module(module: str) -> str:
    return module[2:] if module.startswith("Bi") else module


def make_layer_cfgs(cfg: TKGConfig, num_rels: int,
                    num_times: int) -> Tuple[LayerCfg, LayerCfg]:
    module = cfg.module
    common = dict(num_rels2=2 * num_rels, n_bases=cfg.n_bases,
                  num_times=num_times, self_loop=True, dropout=cfg.dropout)
    if module in ("SRGCN", "RGCN", "SARGCN", "BiSARGCN"):
        lc1 = LayerCfg(cfg.embed_size, cfg.hidden_size, bias=True,
                       activation=None, **common)
        lc2 = LayerCfg(cfg.hidden_size, cfg.hidden_size, bias=True,
                       activation="relu", **common)
    elif module.startswith("Bi"):
        lc1 = LayerCfg(cfg.embed_size, cfg.hidden_size, bias=False,
                       activation=None, **common)
        lc2 = LayerCfg(cfg.hidden_size, cfg.hidden_size, bias=False,
                       activation="relu", **common)
    else:
        lc1 = LayerCfg(cfg.embed_size, cfg.hidden_size, bias=False,
                       activation=None, **common)
        lc2 = LayerCfg(cfg.hidden_size, cfg.hidden_size, bias=False,
                       activation=None, **common)
    return lc1, lc2


def init_encoder(gen: torch.Generator, cfg: TKGConfig, num_rels: int,
                 num_times: int) -> Dict[str, Any]:
    """Both layers' parameters (a plain conv layer 1 under
    ``rec_only_last_layer``, both plain in the static modules); with
    ``impute`` also the imputation weights, one (weight, bias) pair a
    direction in the Bi models, each U(-1, 1) as torch's nn.Linear(1, 1)
    starts."""
    lc1, lc2 = make_layer_cfgs(cfg, num_rels, num_times)
    bidir = cfg.module.startswith("Bi")
    base = _base_module(cfg.module)
    if base in ("SRGCN", "RGCN", "SARGCN"):
        return {"layer1": init_rgcn_layer(gen, cfg, lc1),
                "layer2": init_rgcn_layer(gen, cfg, lc2)}
    init_rec = init_grrgcn_layer if base == "GRRGCN" else init_rrgcn_layer
    p: Dict[str, Any] = {
        "layer1": (init_rgcn_layer(gen, cfg, lc1) if cfg.rec_only_last_layer
                   else init_rec(gen, cfg, lc1, bidirectional=bidir)),
        "layer2": init_rec(gen, cfg, lc2, bidirectional=bidir)}
    if cfg.impute:
        names = (("impute_w_fwd", "impute_b_fwd", "impute_w_bwd",
                  "impute_b_bwd") if bidir else ("impute_w", "impute_b"))
        for name in names:
            p[name] = torch.rand((), generator=gen) * 2.0 - 1.0
    return p


def encoder_forward(p, cfg: TKGConfig, lc1: LayerCfg, lc2: LayerCfg, h0,
                    snap: Snapshot, prev1, prev2, dt,
                    conv1_in: bool = False, train: bool = False,
                    masks=(None, None), direction=None):
    """One snapshot through the recurrent container (GRRGCN or RRGCN, by
    the module's base). Returns (out1, out2, local2); local2 is layer 2's
    local output, GRRGCN's pre-GRU conv output (after its activation) or
    RRGCN's aggregation, with the time embedding under
    ``use_time_embedding``, as out1 (unless ``rec_only_last_layer``) and
    out2.

    ``conv1_in=True`` (GRRGCN, or a plain layer 1): ``h0`` already holds
    this snapshot's precomputed layer-1 conv output; layer 1 runs only its
    recurrence. In training each layer's self-loop takes dropout with the
    keep masks `masks` (layer 1, layer 2). `direction` ("fwd", "bwd" or
    None) picks the recurrence's weights. The snapshot may hold G graphs
    side by side with a time position each (``plus_time_embedding``).
    """
    base = _base_module(cfg.module)
    temb = cfg.use_time_embedding
    if cfg.rec_only_last_layer:
        # no time embedding on a plain layer 1
        out1 = h0 if conv1_in else rgcn_conv(p["layer1"], cfg, lc1, h0, snap,
                                             train, masks[0])
    else:
        if base == "GRRGCN":
            _, out1, t1 = grrgcn_layer(p["layer1"], cfg, lc1, h0, snap, prev1,
                                       dt, conv_in=conv1_in, train=train,
                                       mask=masks[0], direction=direction)
        elif conv1_in:
            raise ValueError("precomputed layer-1 convs need a GRU layer 1")
        else:
            _, out1, t1 = rrgcn_layer(p["layer1"], cfg, lc1, h0, snap, prev1,
                                      dt, train=train, mask=masks[0],
                                      direction=direction)
        if temb:
            out1 = plus_time_embedding(out1, t1)
    if base == "GRRGCN":
        local2 = rgcn_conv(p["layer2"], cfg, lc2, out1, snap, train, masks[1])
        out2 = run_gru(cfg, p["layer2"][GRU_KEY[direction]], local2,
                       prev2 * decay_factor(p["layer2"], cfg, dt))
    else:
        local2, out2, _ = rrgcn_layer(p["layer2"], cfg, lc2, out1, snap,
                                      prev2, dt, train=train, mask=masks[1],
                                      direction=direction)
    if temb:
        t2 = layer_time_embedding(p["layer2"], snap)
        out2 = plus_time_embedding(out2, t2)
        local2 = plus_time_embedding(local2, t2)
    return out1, out2, local2


def encoder_forward_center(p, cfg: TKGConfig, lc1: LayerCfg, lc2: LayerCfg,
                           h0, snap: Snapshot, prev1_f, prev2_f, dt_f,
                           prev1_b, prev2_b, dt_b, train: bool = False,
                           masks=(None, None)):
    """The target snapshot through the Bi container, both windows' states
    meeting in each recurrent layer (``bigrrgcn_layer_center`` or
    ``birrgcn_layer_center``; layer 1 a plain conv under
    ``rec_only_last_layer``). Returns (out2, local2), with the time
    embeddings as in ``encoder_forward``; `train` and `masks` as there."""
    center = (bigrrgcn_layer_center if _base_module(cfg.module) == "GRRGCN"
              else birrgcn_layer_center)
    temb = cfg.use_time_embedding
    if cfg.rec_only_last_layer:
        out1 = rgcn_conv(p["layer1"], cfg, lc1, h0, snap, train, masks[0])
    else:
        _, out1, t1 = center(p["layer1"], cfg, lc1, h0, snap, prev1_f, dt_f,
                             prev1_b, dt_b, train=train, mask=masks[0])
        if temb:
            out1 = plus_time_embedding(out1, t1)
    local2, out2, t2 = center(p["layer2"], cfg, lc2, out1, snap, prev2_f,
                              dt_f, prev2_b, dt_b, train=train, mask=masks[1])
    if temb:
        out2 = plus_time_embedding(out2, t2)
        local2 = plus_time_embedding(local2, t2)
    return out2, local2


def static_rgcn_forward(p, cfg: TKGConfig, lc1: LayerCfg, lc2: LayerCfg, h0,
                        snap: Snapshot, train: bool = False,
                        masks=(None, None)):
    """The static 2-layer RGCN of one snapshot (reference
    models/RGCN.py:154-164): layer 2 takes layer 1's output, and under
    ``use_time_embedding`` its own output takes its time embedding.
    Returns (out1, out2); `train` and `masks` as in
    ``encoder_forward``."""
    out1 = rgcn_conv(p["layer1"], cfg, lc1, h0, snap, train, masks[0])
    out2 = rgcn_conv(p["layer2"], cfg, lc2, out1, snap, train, masks[1])
    if cfg.use_time_embedding:
        out2 = plus_time_embedding(out2, layer_time_embedding(p["layer2"],
                                                              snap))
    return out1, out2


def calc_impute_weight(p, dt, direction=None):
    """exp(-max(w * dt + b, 0)) [M, 1] for dt [M], with the encoder's
    imputation weights; each direction's halved in the Bi models."""
    dt = dt[:, None]
    if direction is None:
        return torch.exp(-torch.relu(p["impute_w"] * dt + p["impute_b"]))
    return torch.exp(-torch.relu(p[f"impute_w_{direction}"] * dt
                                 + p[f"impute_b_{direction}"])) / 2.0
