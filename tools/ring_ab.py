#!/usr/bin/env python3
"""K13 and GRRGCN's ring_pallas path of two checkouts, in turns, on one GPU.

    python3 tools/ring_ab.py OLD NEW [--order ONON] [--out FILE]

OLD and NEW are checkouts of the repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory, and this one). Each
run is a fresh process in the checkout's root that imports that checkout's
``chip_smoke.py`` and package, builds its kernels, makes the chip smoke's
workload (synthetic icews14-sized data, seeded weights, 4 ranks on the one
card) and measures, with CUDA events or the host clock around a
synchronised run:

- K13 a call (``ring_spmm_fwd``) at the final-snapshot and window-step
  shapes, called as the path calls it (with the data's tables where the
  checkout has them);
- K13's forward and backward together through ``ring_spmm`` at the
  final-snapshot shape, and the backward alone where the checkout has
  ``ring_spmm_bwd``;
- the ring valid sweep's wall seconds and a ring training step's
  milliseconds (the smoke's ``_sweep`` and ``_train_path``).

The runs go in the order given by --order (O for OLD, N for NEW; default
ONNO). Prints one JSON line a run, each with the card's name and power
limit, and writes them all to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys


def _measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from temp_tpu_torch.parallel import ring_spmm as rs

    if not torch.cuda.is_available():
        raise SystemExit("ring_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": root, "smi": cs.smi_line()}
    res.update(cs.phase_build())
    ctx = cs.phase_setup("cuda")
    rctx = cs.phase_setup_ring(ctx)
    dev = rctx["device"]
    devices = rctx["mesh"].devices[0]
    takes = "tables" in inspect.signature(rs.ring_spmm_fwd).parameters
    cases = {tag: (args, r, tab) for tag, args, r, tab in _cases(cs, rctx)}
    for tag, (args, r, tab) in cases.items():
        kw = {"tables": tab} if takes else {}
        res[f"k13_{tag}_ms"] = cs.time_ms(
            lambda: rs.ring_spmm_fwd(*args, cs.RING_M, r, devices, **kw),
            dev)
    args, r, tab = cases["final"]
    kw = {"tables": tab} if takes else {}
    g = torch.randn(args[0].shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    hh = args[0].detach().clone().requires_grad_()
    ww = args[1].detach().clone().requires_grad_()

    def fwd_bwd():
        out = rs.ring_spmm(hh, ww, *args[2:], cs.RING_M, r, devices, **kw)
        torch.autograd.grad(out, (hh, ww), g)

    res["k13_final_fwd_bwd_ms"] = cs.time_ms(fwd_bwd, dev, reps=10)
    if hasattr(rs, "ring_spmm_bwd"):
        _, n2 = rs.ring_spmm_fwd(*args, cs.RING_M, r, devices, **kw)
        res["k13_final_bwd_ms"] = cs.time_ms(
            lambda: rs.ring_spmm_bwd(g, n2, *args, cs.RING_M, r, devices,
                                     **kw), dev)
    m, _, _ = cs._sweep(rctx, rctx["cfg"])
    res["ring_sweep_wall_s"] = m["wall_s"]
    res["ring_sweep_mrr"] = m["mrr"]
    res["ring_sweep_launches"] = m["launches"]
    _, step, _, _, _, _ = cs._train_path(rctx, rctx["cfg"])
    res["ring_train_ms_per_step"] = step["ms_per_step"]
    res["ring_train_losses"] = step["losses"]
    res["ring_train_launches"] = step["launches"]
    return res


def _cases(cs, rctx):
    """K13's two shapes, (tag, args, rows, tables) each: the chip smoke's
    ``_k13_cases`` where the checkout has it; for an older checkout
    (before the data's tables) the same two shapes built here, without
    tables."""
    if hasattr(cs, "_k13_cases"):
        return cs._k13_cases(rctx)
    import torch
    import torch.nn.functional as F

    dev, p, data = rctx["device"], rctx["params"], rctx["trainer"].data
    w = p["encoder"]["layer1"]["weight"]
    N, rows = rctx["N"], rctx["rows"]
    t = data.num_times // 2
    tf = torch.tensor([t], device=dev)
    h_final = F.pad(p["ent_embeds"], (0, 0, 0, cs.RING_M * rows - N))[None]
    tp = torch.arange(rctx["B"], device=dev) + t
    h_win = p["ent_embeds"][data.act_idx[tp].long().clamp(max=N - 1)]
    return (("final", (h_final, w, data.train.src[tf], data.train.dst[tf],
                       data.train.rel[tf], data.train.emask[tf]), rows, None),
            ("window", (h_win.contiguous(), w, data.train_src_loc[tp],
                        data.train_dst_loc[tp], data.train.rel[tp],
                        data.train.emask[tp]), rctx["a_cap"], None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--order", default="ONNO")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_measure(os.path.abspath(args.one))), flush=True)
        return 0
    runs = []
    for tag in args.order:
        root = os.path.abspath(args.old if tag == "O" else args.new)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.old, args.new,
             "--one", root], cwd=root, capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["side"] = "old" if tag == "O" else "new"
        print(json.dumps(res), flush=True)
        runs.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
