"""Two-layer temporal encoder container (the GRRGCN part).

Layer 1 maps embed -> hidden and layer 2 hidden -> hidden, both without bias
and, for the unidirectional recurrent models, without activation. Both
layers' outputs are history state. Only GRRGCN without time embeddings,
imputation or gating is ported so far; other configurations raise.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.models.layers import (
    LayerCfg, Snapshot, decay_factor, grrgcn_layer, init_grrgcn_layer,
    rgcn_conv,
)
from temp_tpu_torch.ops.gru import gru_stack


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


def _check_ported(cfg: TKGConfig) -> None:
    if cfg.module != "GRRGCN":
        raise NotImplementedError(f"module {cfg.module} is not ported yet")
    for flag in ("rec_only_last_layer", "type1", "impute",
                 "learnable_lambda", "use_time_embedding", "post_ensemble",
                 "post_aggregation", "edge_dropout", "random_dropout"):
        if getattr(cfg, flag):
            raise NotImplementedError(f"{flag} is not ported yet")


def init_encoder(gen: torch.Generator, cfg: TKGConfig, num_rels: int,
                 num_times: int) -> Dict[str, Any]:
    _check_ported(cfg)
    lc1, lc2 = make_layer_cfgs(cfg, num_rels, num_times)
    return {"layer1": init_grrgcn_layer(gen, cfg, lc1),
            "layer2": init_grrgcn_layer(gen, cfg, lc2)}


def encoder_forward(p, cfg: TKGConfig, lc1: LayerCfg, lc2: LayerCfg, h0,
                    snap: Snapshot, prev1, prev2, dt,
                    conv1_in: bool = False, train: bool = False,
                    masks=(None, None)):
    """One snapshot through the recurrent container. Returns
    (out1, out2, local2); local2 is layer 2's pre-GRU output.

    ``conv1_in=True``: ``h0`` already holds this snapshot's precomputed
    layer-1 conv output; layer 1 runs only its GRU. In training each
    layer's self-loop takes dropout with the keep masks `masks` (layer 1,
    layer 2).
    """
    _, out1, _ = grrgcn_layer(p["layer1"], cfg, lc1, h0, snap, prev1, dt,
                              conv_in=conv1_in, train=train, mask=masks[0])
    conv2 = rgcn_conv(p["layer2"], cfg, lc2, out1, snap, train, masks[1])
    out2 = gru_stack(p["layer2"]["gru"], conv2,
                     prev2 * decay_factor(p["layer2"], cfg, dt))
    return out1, out2, conv2
