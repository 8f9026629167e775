"""Model selection: --module string + behavior flags -> model class, after
the JAX package's ``models/registry.py``. Ported: GRRGCN
(``DynamicRGCNModel``; with ``--impute``, ``--post-ensemble`` or
``--post-aggregation`` ``PostDynamicRGCNModel``) and BiGRRGCN
(``BiDynamicRGCNModel``; with any of the three flags
``PostBiDynamicRGCNModel``, the flagship BiGRRGCN ``--impute`` among
them), SARGCN and BiSARGCN (``models/selfattn.py``; with
``--post-aggregation`` ``models/postselfattn.py``); only plain GRRGCN under
an edge partition. Every other combination raises."""

from __future__ import annotations

from temp_tpu_torch.config import TKGConfig
from temp_tpu_torch.data.snapshots import TKGData


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


def get_model(cfg: TKGConfig, data: TKGData, device="cuda"):
    cfg = normalize_remap_flags(cfg)
    variant = cfg.impute or cfg.post_ensemble or cfg.post_aggregation
    if cfg.module not in ("GRRGCN", "BiGRRGCN", "SARGCN", "BiSARGCN"):
        raise NotImplementedError(f"module {cfg.module} is not ported yet")
    if cfg.partitioned and (variant or cfg.module != "GRRGCN"):
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
    if cfg.module == "GRRGCN":
        if variant:
            from temp_tpu_torch.models.post import PostDynamicRGCNModel
            return PostDynamicRGCNModel(cfg, data, device=device)
        from temp_tpu_torch.models.dynamic import DynamicRGCNModel
        return DynamicRGCNModel(cfg, data, device=device)
    if variant:
        from temp_tpu_torch.models.post import PostBiDynamicRGCNModel
        return PostBiDynamicRGCNModel(cfg, data, device=device)
    from temp_tpu_torch.models.bidynamic import BiDynamicRGCNModel
    return BiDynamicRGCNModel(cfg, data, device=device)
