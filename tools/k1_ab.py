#!/usr/bin/env python3
"""K1's wrappers (``ops/spmm.py``) of two checkouts, in turns, on one GPU.

    python3 tools/k1_ab.py OLD NEW [--order ONNO] [--out FILE]

OLD and NEW are checkouts of the repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory, and this one). Each
run is a fresh process in the checkout's root that imports that checkout's
``chip_smoke.py`` and package, builds its kernels, makes the chip smoke's
workload (synthetic icews14-sized data, seeded weights) and, at each K1
shape of the smoke's ``_k1_cases`` ("final", "table", "train"), with the
data's tables, measures:

- ``*_ms``: milliseconds a call of ``spmm_fwd`` (and, at "final" and
  "train", ``spmm_bwd``) in float32, the smoke's ``time_ms`` (CUDA events
  around 20 calls in a row, so the host's cost a call shows where it
  exceeds the kernel's);
- ``*_host_us``: the host's microseconds a call, on the host clock over
  200 calls queued without a sync (the wrapper's own work: checks, the
  launcher's lookup, its arguments);
- ``final_autograd_ms``: the differentiable ``spmm`` forward and backward
  at "final";
- where the checkout has the bfloat16 mode (``hot=``), the same for
  ``hot=torch.bfloat16`` on the float32 h and w the main path hands it.

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
import time


def _host_us(fn, device, reps: int = 200) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize(device)
    return (t1 - t0) / reps * 1e6


def _measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from temp_tpu_torch.ops import spmm as sp

    if not torch.cuda.is_available():
        raise SystemExit("k1_ab: needs a CUDA device")
    res = {"root": root, "smi": cs.smi_line()}
    res.update(cs.phase_build())
    ctx = cs.phase_setup("cuda")
    dev = ctx["device"]
    modes = {"f32": {}}
    if "hot" in inspect.signature(sp.spmm_fwd).parameters:
        modes["bf16"] = {"hot": torch.bfloat16}
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, args, tables in cs._k1_cases(ctx):
        for mode, kw in modes.items():
            def fwd():
                return sp.spmm_fwd(*args, tables=tables, **kw)

            res[f"{mode}_{tag}_fwd_ms"] = cs.time_ms(fwd, dev)
            res[f"{mode}_{tag}_fwd_host_us"] = _host_us(fwd, dev)
            if tag == "table":
                continue
            g = torch.randn(args[0].shape, generator=gen, device=dev)
            n2 = sp._spmm_fwd(*args, tables=tables, **kw)[1]

            def bwd():
                return sp.spmm_bwd(g, n2, *args, tables=tables, **kw)

            res[f"{mode}_{tag}_bwd_ms"] = cs.time_ms(bwd, dev)
            res[f"{mode}_{tag}_bwd_host_us"] = _host_us(bwd, dev)
            if tag != "final":
                continue
            hh = args[0].detach().clone().requires_grad_()
            ww = args[5].detach().clone().requires_grad_()

            def fwd_bwd():
                out = sp.spmm(hh, *args[1:5], ww, tables=tables, **kw)
                torch.autograd.grad(out, (hh, ww), g)

            res[f"{mode}_final_autograd_ms"] = cs.time_ms(fwd_bwd, dev,
                                                          reps=10)
    return res


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
            timeout=600)
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
