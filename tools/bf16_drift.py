#!/usr/bin/env python3
"""How far a bfloat16 kernel path's trained parameters drift from its plain
version's, step by step, on one GPU.

    python3 tools/bf16_drift.py [--steps 8] [--cpu]

Builds the chip smoke's workload (``chip_smoke.phase_setup``: synthetic
icews14-sized data, seeded weights and draws, batch 8, d = 128) and trains
GRRGCN and the flagship BiGRRGCN --impute from the same weights and draws
on four paths each: bfloat16 with the kernels (fused final step), bfloat16
plain, float32 with the kernels, float32 plain. After every step it prints
RMS(bf16 kernels - bf16 plain) over RMS(f32 kernels - bf16 plain), all
leaves as one vector (the ratio of ``chip_smoke.bf16_param_ratio``, the
terms of BF16_RULE), beside the same for float32's kernels against their
plain path; after the last step the ratio of each leaf. The smoke holds the
bfloat16 paths' leaves to BF16_PARAM_TOL of their change; this is the
measurement behind it. ``--cpu`` runs the smoke's small CPU rehearsal
sizes with the plain versions on both sides. Needs a CUDA device otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def _trained(ctx, cfg, steps: int):
    """The leaves (float64, on the host) after each of the first `steps`
    steps of epoch 0, and their names."""
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer
    from temp_tpu_torch.train.optim import param_leaves

    model = get_model(cfg, ctx["data"], device=ctx["device"])
    tr = Trainer(cfg, model, ctx["data"])
    params, opt = tr.init_state()
    out = []
    for i, (t_pos, t_valid) in enumerate(tr.epoch_batches(0)[:steps]):
        tr.train_step(params, opt, t_pos, t_valid,
                      gen=tr.step_generator(0, i))
        out.append([t.detach().double().cpu().clone()
                    for t in param_leaves(params)])
    return out, chip_smoke._leaf_names(params)


def _rms(x) -> float:
    return float(x.pow(2).mean().sqrt())


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="the CPU rehearsal's sizes, plain versions")
    args = ap.parse_args(argv)
    if args.cpu:
        ctx = chip_smoke.phase_setup(
            "cpu", num_ents=40, num_rels=5, num_times=12, edges_per_time=30,
            embed_size=16, hidden_size=16, n_bases=16, train_seq_len=4,
            batch_size=3, num_pos_facts=20, fused_final=True)
    else:
        if not torch.cuda.is_available():
            print("bf16_drift: needs a CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(chip_smoke.smi_line(), flush=True)
        ctx = chip_smoke.phase_setup("cuda")
    fctx = chip_smoke.phase_setup_flagship(ctx)
    for tag, c in (("grrgcn", ctx), ("flagship", fctx)):
        runs = {}
        for name, over in (("bk", {"compute_dtype": "bfloat16"}),
                           ("bp", {"compute_dtype": "bfloat16",
                                   "kernels": False}),
                           ("fk", {}), ("fp", {"kernels": False})):
            runs[name], names = _trained(c, c["cfg"].replace(**over),
                                         args.steps)
        n = min(len(r) for r in runs.values())
        for s in range(n):
            flat = {k: torch.cat([t.flatten() for t in r[s]])
                    for k, r in runs.items()}
            yard = _rms(flat["fk"] - flat["bp"])
            print(f"{tag} step {s}: bf16 kernels - plain "
                  f"{_rms(flat['bk'] - flat['bp']) / yard:.4f}, f32 kernels "
                  f"- plain {_rms(flat['fk'] - flat['fp']) / yard:.6f} of "
                  f"the f32 - bf16 distance", flush=True)
        for i, name in enumerate(names):
            a, b, f = (runs[k][n - 1][i] for k in ("bk", "bp", "fk"))
            yard = _rms(f - b)
            print(f"  {tag} {name}: {_rms(a - b) / yard if yard else 0:.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
