"""Configuration for temp_tpu_torch runs.

The same dataclass as the JAX package's ``TKGConfig``: the same field names
and model defaults, and the same loader for the ``grid/*/config_*.json``
files, so one config file drives both packages. Differences:

- ``"auto"`` flags resolve on the device the port runs on (on for CUDA, off
  for the CPU) instead of on the JAX backend;
- ``eval_conv1`` replaces the ``TEMP_TPU_EVAL_CONV1`` environment switch of
  the JAX trainer;
- ``kernels`` selects between each hand-written kernel and its plain PyTorch
  version on the card (the plain run is the reference the kernels are held
  against end to end);
- ``compute_dtype="auto"`` resolves on the model's device as the JAX
  package's resolves on its backend: bfloat16 on CUDA, float32 on the CPU
  (``for_device``, which ``models.registry.get_model`` applies; the config
  a run saves keeps "auto"). ``"bfloat16"`` runs the hot contractions in
  bfloat16 (``hot_dtype``) in every model, decoder, pool and option;
- a field whose non-default value selects a path the port has not ported
  (``_UNPORTED``; a ``compute_dtype`` other than float32 or bfloat16;
  ``mp_size > 1`` without an edge partition) raises
  ``NotImplementedError`` when the config is made, naming what is
  missing, rather than quietly running another path.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

import torch


# fields whose non-default values select paths the port has not ported:
# (name, default, what that value needs)
_UNPORTED = (
    ("distributed", False, "multi-process training "
     "(temp_tpu/parallel/multihost.py; ROADMAP.md Queue 1 item 7)"),
)

# the edge-partition modes the port runs (ops/segment.py rel_spmm)
PARTITION_MODES = ("psum", "ring", "ring_pallas", "boundary")

_F32 = ("float32", "f32", None)
_BF16 = ("bfloat16", "bf16")


@dataclass
class TKGConfig:
    # -- data ---------------------------------------------------------------
    dataset_dir: str = "interpolation"
    dataset: str = "icews14"
    data_root: str = "data"  # where <dataset_dir>/<dataset>/ lives

    # -- model selection ----------------------------------------------------
    score_function: str = "complex"
    module: str = "GRRGCN"

    # -- sizes --------------------------------------------------------------
    hidden_size: int = 128
    embed_size: int = 128
    num_layers: int = 1
    n_bases: int = 128
    rgcn_layers: int = 2
    train_seq_len: int = 15
    test_seq_len: int = 30

    # -- optimization -------------------------------------------------------
    max_nb_epochs: int = 1000
    dropout: float = 0.1
    lr: float = 1e-3
    weight_decay: float = 1e-4
    gradient_clip_val: float = 1.0
    patience: int = 10
    batch_size: int = 8
    eval_batch_size: Optional[int] = None
    seed: int = 123

    @property
    def eval_batch(self) -> int:
        if self.eval_batch_size:
            return int(self.eval_batch_size)
        return self.batch_size
    negative_rate: int = 500
    num_pos_facts: int = 3000

    # -- model behavior flags ----------------------------------------------
    rec_only_last_layer: bool = False
    use_time_embedding: bool = False
    inv_temperature: float = 0.1
    use_embed_for_non_active: bool = False
    edge_dropout: bool = False
    random_dropout: bool = False
    type1: bool = False
    post_ensemble: bool = False
    post_aggregation: bool = False
    learnable_lambda: bool = False
    impute: bool = False
    ema: bool = False
    sa_compact: bool = False

    # -- DropEdge params ----------------------------------------------------
    rate_lower: float = 0.2
    rate_upper: float = 0.8
    lambda_1: float = 2.0
    lambda_2: float = 10.0
    lambda_3: float = 20.0

    # -- padding / bucketing ------------------------------------------------
    edge_pad_multiple: int = 128
    query_pad_multiple: int = 128
    neg_oversample: int = 64
    negative_pool: str = "all"

    # -- precision ----------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "auto"

    # -- scheduling ---------------------------------------------------------
    scan_unroll: int = 0
    # whole-window recurrence kernel (ops/fused_window.py); "auto" = on for
    # CUDA when the config lies inside the kernel's envelope
    fused_window: object = "auto"
    fused_final: object = "auto"
    # the whole batch's history windows as one batched window call (K12,
    # ops/fused_window_mb.py) and the fused eval of the final step and
    # ranks (K11, ops/fused_final.py); off by default, as in the JAX package
    fused_window_mb: object = False
    fused_eval: object = False

    # -- port-only switches -------------------------------------------------
    # layer-1 convs computed once per eval sweep (models/dynamic.py
    # precompute_eval_conv1); False recomputes them in every window
    eval_conv1: bool = True
    # False runs each kernel's plain PyTorch version, on whatever device the
    # tensors lie on
    kernels: bool = True

    @staticmethod
    def _auto_flag(value, device) -> bool:
        if isinstance(value, str):
            s = value.lower()
            if s == "auto":
                return torch.device(device).type == "cuda"
            return s in ("1", "true", "yes", "on")
        return bool(value)

    def fused_window_on(self, device) -> bool:
        return self._auto_flag(self.fused_window, device)

    def fused_final_on(self, device) -> bool:
        """The fused dense final step and loss (kernels K3-K5); an explicit
        on runs their plain versions on the CPU."""
        return self._auto_flag(self.fused_final, device)

    def fused_window_mb_on(self, device) -> bool:
        """The batched window (K12); "auto" is on for CUDA."""
        return self._auto_flag(self.fused_window_mb, device)

    def fused_eval_on(self, device) -> bool:
        """The fused eval (K11); an explicit on runs its plain version on
        the CPU."""
        return self._auto_flag(self.fused_eval, device)

    @property
    def edge_partition_mode(self) -> Optional[str]:
        """The exchange of the partitioned SpMM, as the JAX package's
        property: None when off, "boundary" for True, else the mode's
        name."""
        value = self.edge_partition
        if isinstance(value, str) and value.lower() in (
                "0", "false", "no", "off", "1", "true", "yes", "on"):
            value = value.lower() in ("1", "true", "yes", "on")
        if not value:
            return None
        if value is True:
            return "boundary"
        mode = str(value)
        if mode not in PARTITION_MODES:
            raise ValueError(f"edge_partition={value!r}: not a mode")
        return mode

    @property
    def partitioned(self) -> bool:
        """Whether the model runs edge-partitioned over more than one rank
        (the Trainer then wraps it; the ring modes regroup the data)."""
        return self.edge_partition_mode is not None and int(self.mp_size) > 1

    def __post_init__(self):
        if int(self.mp_size) > 1 and self.edge_partition_mode is None:
            raise NotImplementedError(
                f"mp_size={self.mp_size} without edge_partition needs the "
                f"GSPMD entity sharding of model parallelism "
                f"(temp_tpu/parallel/mesh.py), which is not ported yet; "
                f"see ROADMAP.md Queue 1 item 6")
        for name, default, what in _UNPORTED:
            value = getattr(self, name)
            off = (value.lower() in ("0", "false", "no", "off")
                   if isinstance(value, str) else value == default)
            if not off:
                raise NotImplementedError(
                    f"{name}={value!r} needs {what}, which is not ported "
                    f"yet; see ROADMAP.md")
        if self.compute_dtype not in ("auto",) + _F32 + _BF16:
            raise NotImplementedError(
                f"compute_dtype={self.compute_dtype!r}: the port computes in "
                f"float32 or bfloat16; see ROADMAP.md")

    def for_device(self, device) -> "TKGConfig":
        """This config with ``compute_dtype`` "auto" resolved for a model
        on `device`, as the JAX package's ``hot_dtype`` resolves it on its
        backend: "bfloat16" on CUDA, "float32" elsewhere (the CPU, where
        the tests' float32 references run); any other value as it is.
        ``models.registry.get_model`` resolves the model's config so."""
        if self.compute_dtype != "auto":
            return self
        on_card = torch.device(device).type == "cuda"
        return self.replace(compute_dtype="bfloat16" if on_card
                            else "float32")

    @property
    def hot_dtype(self):
        """The dtype of the hot contractions, or None for float32: the JAX
        package's ``TKGConfig.hot_dtype``. torch.bfloat16 for
        ``compute_dtype`` "bfloat16" (or "bf16"): the products' operands
        rounded to bfloat16 with float32 sums (the self-loop, time weight,
        GRU and score products, every product of kernels K2-K12), the
        windows' history buffers stored in bfloat16; the relational SpMM
        outside the fused kernels is K1 in float32 under the SpMM method
        "segment" (the default, as the JAX package's row path ignores the
        dtype), K1's bfloat16 modes under "pallas" and "onehot"
        (``ops.segment.rel_spmm``), K13's under the "ring_pallas" edge
        partition; the "boundary" partition rounds the cut rows it
        exchanges, as the JAX package's does.

        "auto" is resolved for a device by ``for_device`` (bfloat16 on
        CUDA); a config that is not yet resolved reads it as float32, the
        CPU's choice."""
        return torch.bfloat16 if self.compute_dtype in _BF16 else None

    # -- run control --------------------------------------------------------
    debug: bool = False
    fast_dev_run: bool = False
    resume: bool = False
    model_name: Optional[str] = None
    version: Optional[str] = None
    checkpoint_path: Optional[str] = None
    experiments_dir: str = "experiments"

    # -- aggregator ---------------------------------------------------------
    spatial_checkpoint: Optional[str] = None
    temporal_checkpoint: Optional[str] = None
    temporal_module: str = "BiGRRGCN"

    # -- greedy classifier / analysis flags ---------------------------------
    vote: str = "recency"
    future: bool = False
    filtered: bool = False

    # -- parallelism --------------------------------------------------------
    dp_size: int = 1
    mp_size: int = 1
    edge_partition: object = False
    distributed: bool = False

    @property
    def dataset_path(self) -> str:
        ds = self.dataset
        if ds.startswith(self.dataset_dir + "/") or os.sep in ds:
            return os.path.join(self.data_root, ds)
        return os.path.join(self.data_root, self.dataset_dir, ds)

    def replace(self, **kw) -> "TKGConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json_file(cls, path: str, **overrides) -> "TKGConfig":
        with open(path) as f:
            raw = json.load(f)
        return cls.from_dict(raw, **overrides)

    @classmethod
    def from_dict(cls, raw: dict, **overrides) -> "TKGConfig":
        alias = {"EMA": "ema"}
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in raw.items():
            k = alias.get(k, k.replace("-", "_"))
            if k in known:
                kw[k] = v
        kw.update(overrides)
        return cls(**kw)


def encode_run_name(cfg: TKGConfig) -> str:
    """Experiment name from the key hyperparameters: the JAX package's
    ``encode_run_name`` (after the reference's TestTube naming), so both
    packages name a run's directory alike."""
    parts = [
        cfg.module,
        cfg.dataset.replace("/", "-"),
        cfg.score_function,
        f"seq{cfg.train_seq_len}",
        f"d{cfg.embed_size}",
        f"b{cfg.n_bases}",
        f"neg{cfg.negative_rate}",
        f"lr{cfg.lr}",
    ]
    for flag, tag in [
        (cfg.rec_only_last_layer, "reclast"),
        (cfg.use_time_embedding, "temb"),
        (cfg.post_ensemble, "postens"),
        (cfg.post_aggregation, "postagg"),
        (cfg.impute, "impute"),
        (cfg.learnable_lambda, "learnlam"),
        (cfg.edge_dropout, "dropedge"),
        (cfg.random_dropout, "rnddrop"),
        (cfg.type1, "type1"),
        (cfg.ema, "ema"),
    ]:
        if flag:
            parts.append(tag)
    return "-".join(parts)
