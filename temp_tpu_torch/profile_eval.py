"""Where the time of one eval sweep goes, on the card.

    python -m temp_tpu_torch.profile_eval [--plain] [--config FILE]
        [--impute] [--post-ensemble] [--post-aggregation] [--fused-eval]
        [--fused-window-mb]
        [--edge-partition MODE [--mp-size M]] [--compute-dtype DTYPE]
        [--out DIR]

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
seeded random weights; --fused-eval and --fused-window-mb switch on the
fused eval, K11, and the batched window, K12; --edge-partition, psum,
ring, ring_pallas or boundary, partitions every SpMM over --mp-size
ranks, default 4, on the data regrouped for them, the ranks on the
visible cards in turn; any of them in bfloat16 with --compute-dtype
bfloat16), runs
one warm-up valid sweep, then traces a second one with torch.profiler. Prints
the wall time, the device time summed over all kernels and its share of the
wall time (kernels on the ranks' streams may overlap, so the sum can
exceed the busy time), and the device time of each kernel name, largest
first. With
--out it also writes the Chrome trace there. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

from temp_tpu_torch.config import PARTITION_MODES, TKGConfig
from temp_tpu_torch.data.snapshots import make_synthetic, ring_layout
from temp_tpu_torch.models.registry import get_model
from temp_tpu_torch.train.loop import Trainer

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CONFIG = os.path.join("grid", "icews14", "config_grrgcn.json")


def parse(argv=None):
    """(the parsed flags, the run's TKGConfig)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plain", action="store_true",
                    help="profile the plain PyTorch versions of the kernels")
    ap.add_argument("--config", default=_CONFIG,
                    help="the model's config file, relative to the checkout "
                         "(default: %(default)s)")
    ap.add_argument("--impute", action="store_true",
                    help="with imputation (BiGRRGCN --impute: the flagship)")
    ap.add_argument("--post-ensemble", action="store_true",
                    help="with TED's gates (with --impute on BiGRRGCN: TED)")
    ap.add_argument("--post-aggregation", action="store_true",
                    help="with the --post-aggregation gates")
    ap.add_argument("--fused-eval", action="store_true",
                    help="the final step and ranks through K11 (fused_eval)")
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
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    cfg = TKGConfig.from_json_file(
        os.path.join(_ROOT, args.config),
        **{k: True for k in ("impute", "post_ensemble", "post_aggregation")
           if getattr(args, k)},
        kernels=not args.plain, compute_dtype=args.compute_dtype,
        fused_eval=args.fused_eval, fused_window_mb=args.fused_window_mb)
    if args.edge_partition:
        cfg = cfg.replace(edge_partition=args.edge_partition,
                          mp_size=args.mp_size)
    return args, cfg


def main(argv=None) -> int:
    args, cfg = parse(argv)
    if not torch.cuda.is_available():
        print("profile_eval: needs a CUDA device", file=sys.stderr)
        return 1
    data = ring_layout(cfg, make_synthetic(
        num_ents=7128, num_rels=230, num_times=365, edges_per_time=200,
        seed=0, edge_pad_multiple=cfg.edge_pad_multiple))
    model = get_model(cfg, data, device="cuda")
    params = model.init_params(cfg.seed)
    trainer = Trainer(cfg, model, data)
    if trainer.mesh is not None:
        print(f"mesh: {trainer.mesh.placement()} "
              f"(edge_partition={cfg.edge_partition_mode})")
    trainer.eval_sweep(params, "valid")  # warm-up: build, caches, allocator
    torch.cuda.synchronize()

    report = profile(lambda: trainer.eval_sweep(params, "valid"),
                     "valid sweep", args.top)
    path = "plain" if args.plain else "kernels"
    path += "".join(f", {name}" for name, on in (
        ("fused_eval", args.fused_eval),
        ("fused_window_mb", args.fused_window_mb),
        (f"{args.edge_partition} x {args.mp_size}", args.edge_partition),
        (args.compute_dtype, args.compute_dtype != "float32"))
        if on)
    print(f"path: {path}; {report}")
    if args.out:
        export(args.out, f"eval_{'plain' if args.plain else 'kernels'}"
               f"{'_fused' if args.fused_eval else ''}")
    return 0


_last = {}


def profile(fn, label: str, top: int = 15) -> str:
    """Trace one call of `fn` with torch.profiler; print the card, then the
    device time of each kernel name, largest first. Returns the summary
    line: wall time, device busy time and its share of the wall."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _last["prof"] = prof

    per_kernel = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            t, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (t + us / 1e3, n + 1)
    busy = sum(t for t, _ in per_kernel.values())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    print(f"card: {smi}")
    if not per_kernel:
        print("the profiler recorded no device time: not measured")
    for name, (t, n) in sorted(per_kernel.items(),
                               key=lambda kv: -kv[1][0])[:top]:
        print(f"{t:10.3f} ms {n:7d} calls  {100 * t / max(busy, 1e-9):5.1f}%"
              f"  {name[:100]}")
    return (f"{label} wall {wall * 1e3:.3f} ms (traced); device busy "
            f"{busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}% of wall)")


def export(out_dir: str, name: str) -> None:
    """Write the last trace as Chrome JSON to <out_dir>/<name>.json."""
    os.makedirs(out_dir, exist_ok=True)
    _last["prof"].export_chrome_trace(os.path.join(out_dir, f"{name}.json"))


if __name__ == "__main__":
    sys.exit(main())
