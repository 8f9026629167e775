#!/usr/bin/env python3
"""The final step's kernels (K3, K4, K6+K7, K11) and K2f of several
checkouts, in turns, on one GPU.

    python3 tools/final_ab.py ROOT [ROOT ...] [--order 0110] [--out FILE]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory, this one, or a
copy with one constant of its kernels changed). Each run is a fresh
process in the checkout's root that imports that checkout's
``chip_smoke.py`` and package, builds its kernels, makes the chip smoke's
workload (synthetic icews14-sized data, seeded weights, batch 8, d = 128)
and measures, on the smoke's batches, a call's milliseconds (CUDA events)
and the device time a call of each of its kernels (the profiler):

- K3 (``fused_final_fwd``): its two layer launches (``final_layer``), the
  score launch and the loss reduction, on the first training batch;
- K4 (``fused_final_bwd_loss``): ``final_dq``, ``final_dq_finish``,
  ``final_dtable`` and the relation sum, from K3's saved residuals;
- K6+K7 (``bi_layer_fwd``): its launch for both layers of the flagship's
  final step (``bi_layer``), on the flagship's first training batch;
- K11 (``fused_eval_ranks``): its two layer launches and the rank launch
  (``final_ranks``) on the first eval batch;
- K2f (``fused_window_fwd``) a launch, on the first eval batch's window
  (``conv1_in``), whose tile K3's layers share.

The runs go in the order given by --order (the ROOTs' indices; default
each once). Prints one JSON line a run, each with the card's name and
power limit, and writes them all to --out. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from window_ab import _device_ms  # noqa: E402

_K3 = ("final_layer", "final_scores", "final_loss_reduce")
_K4 = ("final_dq_kernel", "final_dq_finish", "final_dtable", "rel_sum")
_K11 = ("final_layer", "final_ranks", "final_rank_reduce")


def _record(cs, fn, names, dev) -> dict:
    """A call's milliseconds and, per kernel name, its device time and
    launches a call."""
    out = {"call_ms": cs.time_ms(fn, dev, reps=10)}
    for n, (ms, launches) in _device_ms(fn, list(names)).items():
        out[f"{n}_ms"] = ms
        out[f"{n}_launches"] = launches
    return out


def _measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from temp_tpu_torch.ops import fused_final as ff
    from temp_tpu_torch.ops import fused_final_bi as fbi
    from temp_tpu_torch.ops import fused_window as fw

    if not torch.cuda.is_available():
        raise SystemExit("final_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": root, "smi": cs.smi_line()}
    res.update(cs.phase_build())
    ctx = cs.phase_setup("cuda")
    dev = ctx["device"]
    batch = cs.final_batch(ctx)
    args = batch["fwd"]
    res["k3"] = _record(cs, lambda: ff.fused_final_fwd(*args), _K3, dev)
    _, saved = ff.fused_final_fwd(*args)
    gr, rtab, g = batch["gr"], args[-1], batch["tv"]
    res["k4"] = _record(
        cs, lambda: ff.fused_final_bwd_loss(saved, rtab, gr, g), _K4, dev)
    fctx = cs.phase_setup_flagship(ctx)
    fb_ = cs.final_batch_flagship(fctx)
    sel = fb_["h0x"] if fb_["bg"].noact else None
    a1, k1 = cs._bi_layer_args(fb_, 1)
    with torch.no_grad():
        a2, k2 = cs._bi_layer_args(fb_, 2, fbi.bi_layer_fwd(*a1, **k1))
        res["k6k7"] = _record(cs, lambda: (
            fbi.bi_layer_fwd(*a1, **k1),
            fbi.bi_layer_fwd(*a2, **k2, sel=sel)), ["bi_layer"], dev)
    eb = cs.eval_batch(ctx)
    with torch.no_grad():
        res["k11"] = _record(cs, lambda: ff.fused_eval_ranks(*eb["args"]),
                             _K11, dev)
    _, kw = cs.window_batch(ctx, True)
    kw.pop("conv1_in")
    wa = dict(fw.window_args(ctx["params"]["encoder"], ctx["cfg"], **kw),
              conv1_in=True)
    k2f = _record(cs, lambda: fw.fused_window_fwd(**wa), ["window_layer"],
                  dev)
    k2f["window_layer_ms_a_launch"] = (
        k2f["window_layer_ms"] / max(k2f["window_layer_launches"], 1))
    res["k2f"] = k2f
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default=None,
                    help="the ROOTs' indices in the order to run them")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(_measure(os.path.abspath(args.one))), flush=True)
        return 0
    order = args.order or "".join(str(i) for i in range(len(args.roots)))
    runs = []
    for tag in order:
        root = os.path.abspath(args.roots[int(tag)])
        cmd = [sys.executable, os.path.abspath(__file__), *args.roots,
               "--one", root]
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["index"] = int(tag)
        print(json.dumps(res), flush=True)
        runs.append(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
