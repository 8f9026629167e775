"""Two-layer temporal encoder container (the GRRGCN and BiGRRGCN part).

Layer 1 maps embed -> hidden and layer 2 hidden -> hidden, both without bias;
layer 2 has no activation in the unidirectional recurrent models and a ReLU
in the Bi models, whose layers own a GRU for each direction. Both layers'
outputs are history state. Ported so far: GRRGCN and BiGRRGCN, with or
without imputation and the Post gates (``models/post.py``), without time
embeddings; the self-attention modules' layers (bias on both, a ReLU on
layer 2) are made in ``models/selfattn.py``; other configurations raise.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.models.layers import (
    LayerCfg, Snapshot, bigrrgcn_layer_center, decay_factor, grrgcn_layer,
    init_grrgcn_layer, rgcn_conv,
)
from temp_tpu_torch.ops.gru import GRU_KEY, gru_stack


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


# the self-attention modules (``models/selfattn.py``)
SA_MODULES = ("SARGCN", "BiSARGCN")


def _check_ported(cfg: TKGConfig) -> None:
    """GRRGCN and BiGRRGCN, with or without ``impute``, ``post_ensemble``
    and ``post_aggregation``, pass; so do SARGCN and BiSARGCN, also with
    time embeddings (which they force on), ``rec_only_last_layer``,
    ``learnable_lambda`` and ``random_dropout``; the other modules and
    flags raise."""
    if cfg.module not in ("GRRGCN", "BiGRRGCN") + SA_MODULES:
        raise NotImplementedError(f"module {cfg.module} is not ported yet")
    unported = ("type1", "edge_dropout")
    if cfg.module not in SA_MODULES:
        unported += ("rec_only_last_layer", "learnable_lambda",
                     "use_time_embedding", "random_dropout")
    for flag in unported:
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not ported yet for "
                                      f"{cfg.module}")


def init_encoder(gen: torch.Generator, cfg: TKGConfig, num_rels: int,
                 num_times: int) -> Dict[str, Any]:
    """Both layers' parameters; with ``impute`` also the imputation
    weights, one (weight, bias) pair a direction in the Bi models, each
    U(-1, 1) as torch's nn.Linear(1, 1) starts."""
    _check_ported(cfg)
    lc1, lc2 = make_layer_cfgs(cfg, num_rels, num_times)
    bidir = cfg.module.startswith("Bi")
    p: Dict[str, Any] = {
        "layer1": init_grrgcn_layer(gen, cfg, lc1, bidirectional=bidir),
        "layer2": init_grrgcn_layer(gen, cfg, lc2, bidirectional=bidir)}
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
    """One snapshot through the recurrent container. Returns
    (out1, out2, local2); local2 is layer 2's pre-GRU output (after its
    activation).

    ``conv1_in=True``: ``h0`` already holds this snapshot's precomputed
    layer-1 conv output; layer 1 runs only its GRU. In training each
    layer's self-loop takes dropout with the keep masks `masks` (layer 1,
    layer 2). `direction` ("fwd", "bwd" or None) picks the GRUs.
    """
    _, out1, _ = grrgcn_layer(p["layer1"], cfg, lc1, h0, snap, prev1, dt,
                              conv_in=conv1_in, train=train, mask=masks[0],
                              direction=direction)
    conv2 = rgcn_conv(p["layer2"], cfg, lc2, out1, snap, train, masks[1])
    out2 = gru_stack(p["layer2"][GRU_KEY[direction]], conv2,
                     prev2 * decay_factor(p["layer2"], cfg, dt))
    return out1, out2, conv2


def encoder_forward_center(p, cfg: TKGConfig, lc1: LayerCfg, lc2: LayerCfg,
                           h0, snap: Snapshot, prev1_f, prev2_f, dt_f,
                           prev1_b, prev2_b, dt_b, train: bool = False,
                           masks=(None, None)):
    """The target snapshot through the Bi container, both windows' states
    meeting in each layer (``bigrrgcn_layer_center``). Returns (out2,
    local2); `train` and `masks` as in ``encoder_forward``."""
    _, out1 = bigrrgcn_layer_center(p["layer1"], cfg, lc1, h0, snap, prev1_f,
                                    dt_f, prev1_b, dt_b, train=train,
                                    mask=masks[0])
    local2, out2 = bigrrgcn_layer_center(p["layer2"], cfg, lc2, out1, snap,
                                         prev2_f, dt_f, prev2_b, dt_b,
                                         train=train, mask=masks[1])
    return out2, local2


def calc_impute_weight(p, dt, direction=None):
    """exp(-max(w * dt + b, 0)) [M, 1] for dt [M], with the encoder's
    imputation weights; each direction's halved in the Bi models."""
    dt = dt[:, None]
    if direction is None:
        return torch.exp(-torch.relu(p["impute_w"] * dt + p["impute_b"]))
    return torch.exp(-torch.relu(p[f"impute_w_{direction}"] * dt
                                 + p[f"impute_b_{direction}"])) / 2.0
