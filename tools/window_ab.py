#!/usr/bin/env python3
"""K2f (the window's forward layer) and K9+K10's GRU launch of several
checkouts, in turns, on one GPU.

    python3 tools/window_ab.py ROOT [ROOT ...] [--order 0110] [--out FILE]

Each ROOT is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory, this one, or a
copy with one constant of its kernels changed). Each run is a fresh
process in the checkout's root that imports that checkout's
``chip_smoke.py`` and package, builds its kernels, makes the chip smoke's
workload (synthetic icews14-sized data, seeded weights, batch 8, d = 128)
and measures:

- K2f (``fused_window_fwd``) on the smoke's first eval batch (``conv1_in``:
  layer 1's conv given), on its training batch (the conv recomputed, the
  dropout masks) and on the flagship's forward-direction window (the
  ReLU, the third buffer): a call's milliseconds with CUDA events, and
  the device time a launch of K2f's kernels from the profiler;
- the flagship's layer backward (``bi_layer_bwd``) of both layers on the
  smoke's final-step batch: a call's milliseconds, and the device time a
  step of its GRU launch (``bi_bwd_gru_kernel``), weight launch and input
  launch.

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

_K2F = "window_layer"
_BI = ("bi_bwd_gru_kernel", "bi_wgrad_kernel", "final_bwd_input_kernel")


def _device_ms(fn, names, reps: int = 5) -> dict:
    """name -> (device ms a call of fn, launches a call) of the kernels
    whose names contain it, from the profiler over reps calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: [0.0, 0] for n in names}
    for ev in prof.key_averages():
        for n in names:
            if n in ev.key:
                t = getattr(ev, "device_time_total", None)
                out[n][0] += (ev.cuda_time_total if t is None else t) / 1e3
                out[n][1] += ev.count
    return {n: (t / reps, c // reps) for n, (t, c) in out.items()}


def _k2f(cs, fw, fwd_args, dev) -> dict:
    run = lambda: fw.fused_window_fwd(**fwd_args)  # noqa: E731
    ms, launches = _device_ms(run, [_K2F])[_K2F]
    return {"call_ms": cs.time_ms(run, dev, reps=10),
            "kernel_ms_a_launch": ms / max(launches, 1),
            "launches": launches}


def _measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from temp_tpu_torch.ops import fused_final_bi as fb
    from temp_tpu_torch.ops import fused_window as fw

    if not torch.cuda.is_available():
        raise SystemExit("window_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"root": root, "smi": cs.smi_line()}
    res.update(cs.phase_build())
    ctx = cs.phase_setup("cuda")
    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    cases = {}
    for conv1_in in (True, False):
        _, kw = cs.window_batch(ctx, conv1_in)
        kw.pop("conv1_in")
        masks = None
        if not conv1_in:
            B, L1, A, d = kw["h0_xs"].shape
            gen = torch.Generator(device=dev).manual_seed(0)
            keep = 1.0 - cfg.dropout
            masks = tuple((torch.rand(B, L1, A, d, generator=gen, device=dev)
                           < keep).to(torch.float32) / keep
                          for _ in range(2))
        cases["conv1_in" if conv1_in else "train"] = dict(
            fw.window_args(p["encoder"], cfg, masks=masks, **kw),
            conv1_in=conv1_in)
    fctx = cs.phase_setup_flagship(ctx)
    _, kw = cs.flagship_window_batch(fctx, "fwd")
    cases["flagship"] = dict(
        fw.window_args(fctx["params"]["encoder"], fctx["cfg"], **kw),
        conv1_in=False, n_buf=3)
    for tag, args in cases.items():
        res[f"k2f_{tag}"] = _k2f(cs, fw, args, dev)
    fb_ = cs.final_batch_flagship(fctx)
    gen = torch.Generator(device=dev).manual_seed(9)
    d_out = torch.randn(fb_["hists"][0].shape, generator=gen, device=dev)
    calls = [cs._bi_layer_args(fb_, 2, fb_["hists"][0]),
             cs._bi_layer_args(fb_, 1)]

    def bwd():
        for a, k in calls:
            fb.bi_layer_bwd(*a, d_out, **k)

    res["bi_layer_bwd_both_layers"] = {
        "call_ms": cs.time_ms(bwd, dev, reps=10),
        **{f"{n}_ms_a_step": ms for n, (ms, _) in
           _device_ms(bwd, list(_BI)).items()}}
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
