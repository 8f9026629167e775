"""Model selection: --module string + behavior flags -> model class, after
the JAX package's ``models/registry.py``: GRRGCN and RRGCN
(``DynamicRGCNModel``; GRRGCN with ``--impute``, ``--post-ensemble`` or
``--post-aggregation`` ``PostDynamicRGCNModel``), BiGRRGCN and BiRRGCN
(``BiDynamicRGCNModel``; BiGRRGCN with any of the three flags
``PostBiDynamicRGCNModel``, the flagship BiGRRGCN ``--impute`` among
them), SRGCN and DRGCN (``models/static.py``), SARGCN and BiSARGCN
(``models/selfattn.py``; with ``--post-aggregation``
``models/postselfattn.py``), each with the recurrent options; the
embedding baselines Static, DE, ATiSE (or AtiSE), Hyte and SimplE (or
Simple) (``models/baselines.py``), TimeDynamicRGCN
(``models/timedynamic.py``) and the Aggregator (``models/aggregator.py``);
every decoder (complex, distmult, transE) and negative pool (all, shared,
per_query). Under an edge partition GRRGCN, BiGRRGCN and the flagship
BiGRRGCN ``--impute``, with ComplEx and the "all" pool, run; the rest
raises there (ROADMAP.md Queue 1 items 8-9), as RRGCN with a flag does
(the reference has no such model). The model's config is resolved for
its device (``TKGConfig.for_device``: "auto" is bfloat16 on CUDA)."""

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


# the options a partitioned model does not take: every recurrent option
# the unpartitioned models do
_OPTIONS = ("type1", "learnable_lambda", "use_time_embedding",
            "rec_only_last_layer", "random_dropout", "edge_dropout")
# the baselines' names, the reference CLI's aliases among them
_BASELINES = {"Static": "Static", "DE": "DE", "ATiSE": "ATiSE",
              "AtiSE": "ATiSE", "Hyte": "Hyte", "SimplE": "SimplE",
              "Simple": "SimplE"}


def partition_ported(cfg: TKGConfig) -> bool:
    """Whether the port runs `cfg`'s model under an edge partition: plain
    GRRGCN, plain BiGRRGCN and the flagship BiGRRGCN ``--impute`` (no
    gate), with no recurrent option, ComplEx and the "all" pool."""
    cfg = normalize_remap_flags(cfg)
    gated = cfg.post_ensemble or cfg.post_aggregation
    return ((cfg.module == "BiGRRGCN" and not gated)
            or (cfg.module == "GRRGCN" and not (gated or cfg.impute))) and (
        not any(getattr(cfg, o) for o in _OPTIONS)
        and cfg.score_function == "complex" and cfg.negative_pool == "all")


def get_model(cfg: TKGConfig, data: TKGData, device="cuda"):
    cfg = normalize_remap_flags(cfg).for_device(device)
    module = cfg.module
    variant = cfg.impute or cfg.post_ensemble or cfg.post_aggregation
    if cfg.partitioned and not partition_ported(cfg):
        raise NotImplementedError(
            f"{module} with these flags, decoder or pool under an edge "
            f"partition is not ported yet (only GRRGCN, BiGRRGCN and "
            f"BiGRRGCN --impute with ComplEx and the 'all' pool are); see "
            f"ROADMAP.md Queue 1 items 8-9")
    if module in ("SARGCN", "BiSARGCN"):
        bi = module == "BiSARGCN"
        if cfg.post_aggregation:
            from temp_tpu_torch.models import postselfattn as m
            cls = (m.PostBiSelfAttentionRGCNModel if bi
                   else m.PostSelfAttentionRGCNModel)
        else:
            from temp_tpu_torch.models import selfattn as m
            cls = (m.BiSelfAttentionRGCNModel if bi
                   else m.SelfAttentionRGCNModel)
        return cls(cfg, data, device=device)
    if module in ("SRGCN", "DRGCN"):
        from temp_tpu_torch.models import static as m
        cls = m.StaticRGCNModel if module == "SRGCN" else m.DRGCNModel
        return cls(cfg, data, device=device)
    if module in _BASELINES:
        from temp_tpu_torch.models.baselines import get_baseline
        return get_baseline(cfg.replace(module=_BASELINES[module]), data,
                            device=device)
    if module == "Aggregator":
        from temp_tpu_torch.models.aggregator import AggregatorModel
        return AggregatorModel(cfg, data, device=device)
    if module == "TimeDynamicRGCN":
        from temp_tpu_torch.models.timedynamic import TimeDynamicRGCNModel
        return TimeDynamicRGCNModel(cfg, data, device=device)
    if module not in ("GRRGCN", "RRGCN", "BiGRRGCN", "BiRRGCN"):
        raise ValueError(f"unknown module: {module}")
    bi = module.startswith("Bi")
    if variant:
        # the Post models raise for an RRGCN base
        from temp_tpu_torch.models import post as m
        cls = m.PostBiDynamicRGCNModel if bi else m.PostDynamicRGCNModel
    elif bi:
        from temp_tpu_torch.models.bidynamic import BiDynamicRGCNModel as cls
    else:
        from temp_tpu_torch.models.dynamic import DynamicRGCNModel as cls
    return cls(cfg, data, device=device)
