"""Where the time of a few training steps goes, on the card.

    python -m temp_tpu_torch.profile_train [--plain | --unfused] [--steps N]
        [--config FILE] [--impute] [--post-ensemble] [--post-aggregation]
        [--fused-window-mb] [--edge-partition MODE [--mp-size M]]
        [--compute-dtype DTYPE] [--out DIR]

Builds the chip smoke's workload (synthetic data at icews14's sizes, the
grid/icews14/config_grrgcn.json model or the one of --config, with
imputation on for --impute: ``--config grid/icews14/config_bigrrgcn.json
--impute`` is the flagship, with ``--post-ensemble`` also TED's gates
(``--post-aggregation`` the other gates; ``--compute-dtype bfloat16`` any
of them in bfloat16);
``--config grid/icews14/config_sargcn.json`` (or ``config_bisargcn.json``)
the attention models and ``config_rrgcn.json``, ``config_birrgcn.json`` or
``config_srgcn.json`` the linear-recurrence and static ones, whose every
graph product is K1;
seeded random weights and draws), takes two warm-up optimizer steps, then
traces the next N (default 4) with torch.profiler. The path: the kernels
with the fused final step (K3-K5, or K6-K10 for the flagship; the default
where the model has one), ``--unfused`` the kernels with fused_final off
(the final step one element at a time through K1, as the gated models and
plain BiGRRGCN always run), ``--plain`` the plain versions;
``--fused-window-mb`` the windows through the batched window, K12;
``--edge-partition`` (psum, ring, ring_pallas or boundary) partitions
every SpMM over M ranks (default 4) on the data regrouped for them, the
ranks on the visible cards in turn (several to a card when there are
fewer cards); any of them in bfloat16 with ``--compute-dtype bfloat16``
(the default float32; "auto" would be bfloat16 on the card). Prints the
wall time, the device time summed over all kernels and its share of the
wall time, and the device time of each kernel name, largest first. With --out it also writes the Chrome trace
there. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from temp_tpu_torch.config import PARTITION_MODES, TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, ring_layout
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.profile_eval import export, profile
from temp_tpu_torch.train.loop import Trainer

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CONFIG = os.path.join("grid", "icews14", "config_grrgcn.json")


def parse(argv=None):
    """(the parsed flags, the run's TKGConfig)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--plain", action="store_true",
                      help="profile the plain PyTorch versions of the kernels")
    path.add_argument("--unfused", action="store_true",
                      help="profile the kernels with fused_final off")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--config", default=_CONFIG,
                    help="the model's config file, relative to the checkout "
                         "(default: %(default)s)")
    ap.add_argument("--impute", action="store_true",
                    help="with imputation (BiGRRGCN --impute: the flagship)")
    ap.add_argument("--post-ensemble", action="store_true",
                    help="with TED's gates (with --impute on BiGRRGCN: TED)")
    ap.add_argument("--post-aggregation", action="store_true",
                    help="with the --post-aggregation gates")
    ap.add_argument("--fused-window-mb", action="store_true",
                    help="the windows through K12 (fused_window_mb)")
    ap.add_argument("--edge-partition", choices=PARTITION_MODES,
                    default=None, help="partition every SpMM over "
                    "--mp-size ranks (ring_pallas: kernel K13)")
    ap.add_argument("--mp-size", type=int, default=4,
                    help="ranks of the edge partition (default 4; on the "
                         "visible cards in turn)")
    ap.add_argument("--compute-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the hot dtype (bfloat16: the model's bfloat16 "
                         "path; K1's bfloat16 mode with "
                         "TEMP_TPU_SPMM_METHOD=pallas; default: "
                         "%(default)s)")
    ap.add_argument("--out", default=None, help="directory for the trace")
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    cfg = TKGConfig.from_json_file(
        os.path.join(_ROOT, args.config),
        **{k: True for k in ("impute", "post_ensemble", "post_aggregation")
           if getattr(args, k)},
        kernels=not args.plain, compute_dtype=args.compute_dtype,
        fused_final=not args.unfused, fused_window_mb=args.fused_window_mb)
    if args.edge_partition:
        cfg = cfg.replace(edge_partition=args.edge_partition,
                          mp_size=args.mp_size)
    return args, cfg


def main(argv=None) -> int:
    args, cfg = parse(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs a CUDA device", file=sys.stderr)
        return 1
    data = ring_layout(cfg, make_synthetic(
        num_ents=7128, num_rels=230, num_times=365, edges_per_time=200,
        seed=0, edge_pad_multiple=cfg.edge_pad_multiple))
    model = get_model(cfg, data, device="cuda")
    trainer = Trainer(cfg, model, data)
    if trainer.mesh is not None:
        print(f"mesh: {trainer.mesh.placement()} "
              f"(edge_partition={cfg.edge_partition_mode})")
    params, opt = trainer.init_state()
    batches = trainer.epoch_batches(0)[:2 + args.steps]

    def steps(idx):
        for i in idx:
            t_pos, t_valid = batches[i]
            trainer.train_step(params, opt, t_pos, t_valid,
                               gen=trainer.step_generator(0, i))

    steps(range(2))  # warm-up: build, caches, allocator
    torch.cuda.synchronize()
    report = profile(lambda: steps(range(2, 2 + args.steps)),
                     f"{args.steps} training steps", args.top)
    name = ("plain" if args.plain
            else "fused" if model.fused_final_on() else "unfused")
    if args.edge_partition:  # the fused final step is off under it
        name = (f"{'plain' if args.plain else 'kernels'}_"
                f"{args.edge_partition}_x{args.mp_size}")
    if args.fused_window_mb:
        name += ", fused_window_mb"
    if args.compute_dtype != "float32":
        name += f", {args.compute_dtype}"
    print(f"path: {name}; {report}")
    if args.out:
        export(args.out, f"train_{name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
