"""Model selection: --module string + behavior flags -> model class, after
the JAX package's ``models/registry.py``. Ported: GRRGCN and RRGCN
(``DynamicRGCNModel``; GRRGCN with ``--impute``, ``--post-ensemble`` or
``--post-aggregation`` ``PostDynamicRGCNModel``), BiGRRGCN and BiRRGCN
(``BiDynamicRGCNModel``; BiGRRGCN with any of the three flags
``PostBiDynamicRGCNModel``, the flagship BiGRRGCN ``--impute`` among
them), SRGCN and DRGCN (``models/static.py``), SARGCN and BiSARGCN
(``models/selfattn.py``; with ``--post-aggregation``
``models/postselfattn.py``), each with the recurrent options; only plain
GRRGCN (no flag, no option) under an edge partition. The other modules,
RRGCN with a flag (the reference has no such model), the other decoders
and negative pools raise."""

from __future__ import annotations

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData
from temp_tpu_torch.models.encoders import PORTED_MODULES


def normalize_remap_flags(cfg: TKGConfig) -> TKGConfig:
    """Resolve the post/impute flag combinations to the variant the
    reference's remap table selects (its main.py:57-79), as the JAX
    package's ``normalize_remap_flags`` does:

    - GRRGCN/RRGCN (an `if` then an `if/elif`): post_ensemble overrides
      post_aggregation, and impute overrides post_aggregation when
      post_ensemble is unset;
    - BiGRRGCN/BiRRGCN (an elif chain): post_aggregation over
      post_ensemble; impute stays meaningful under post_aggregation;
    - SARGCN/BiSARGCN: only post_aggregation remaps; post_ensemble and
      impute are ignored.
    """
    m = cfg.module
    if m in ("GRRGCN", "RRGCN"):
        if cfg.post_ensemble and cfg.post_aggregation:
            return cfg.replace(post_aggregation=False)
        if cfg.impute and cfg.post_aggregation and not cfg.post_ensemble:
            return cfg.replace(post_aggregation=False)
        return cfg
    if m in ("BiGRRGCN", "BiRRGCN"):
        if cfg.post_aggregation and cfg.post_ensemble:
            return cfg.replace(post_ensemble=False)
        return cfg
    if m in ("SARGCN", "BiSARGCN"):
        if cfg.post_ensemble or cfg.impute:
            return cfg.replace(post_ensemble=False, impute=False)
        return cfg
    return cfg


# the options a partitioned model does not take: every recurrent option
# the unpartitioned models do (only plain GRRGCN runs under a partition)
_OPTIONS = ("type1", "learnable_lambda", "use_time_embedding",
            "rec_only_last_layer", "random_dropout", "edge_dropout")


def get_model(cfg: TKGConfig, data: TKGData, device="cuda"):
    cfg = normalize_remap_flags(cfg)
    variant = cfg.impute or cfg.post_ensemble or cfg.post_aggregation
    if cfg.module not in PORTED_MODULES:
        raise NotImplementedError(f"module {cfg.module} is not ported yet; "
                                  f"see ROADMAP.md")
    if cfg.partitioned and (variant or cfg.module != "GRRGCN" or any(
            getattr(cfg, o) for o in _OPTIONS)):
        raise NotImplementedError(f"{cfg.module} with these flags under an "
                                  f"edge partition is not ported yet; see "
                                  f"ROADMAP.md")
    if cfg.module in ("SARGCN", "BiSARGCN"):
        bi = cfg.module == "BiSARGCN"
        if cfg.post_aggregation:
            from temp_tpu_torch.models import postselfattn as m
            cls = (m.PostBiSelfAttentionRGCNModel if bi
                   else m.PostSelfAttentionRGCNModel)
        else:
            from temp_tpu_torch.models import selfattn as m
            cls = (m.BiSelfAttentionRGCNModel if bi
                   else m.SelfAttentionRGCNModel)
        return cls(cfg, data, device=device)
    if cfg.module in ("SRGCN", "DRGCN"):
        from temp_tpu_torch.models import static as m
        cls = m.StaticRGCNModel if cfg.module == "SRGCN" else m.DRGCNModel
        return cls(cfg, data, device=device)
    bi = cfg.module.startswith("Bi")
    if variant:
        # the Post models raise for an RRGCN base
        from temp_tpu_torch.models import post as m
        cls = m.PostBiDynamicRGCNModel if bi else m.PostDynamicRGCNModel
    elif bi:
        from temp_tpu_torch.models.bidynamic import BiDynamicRGCNModel as cls
    else:
        from temp_tpu_torch.models.dynamic import DynamicRGCNModel as cls
    return cls(cfg, data, device=device)
