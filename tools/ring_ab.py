#!/usr/bin/env python3
"""K13 and GRRGCN's ring_pallas path of two checkouts, in turns, on one GPU.

    python3 tools/ring_ab.py OLD NEW [--order ONON] [--bf16] [--out FILE]

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

With --bf16 each run measures the bfloat16 mode (``hot=torch.bfloat16``,
the card's default since "auto" resolves to it) instead:

- K13 bf16 and K13b bf16 a call at both shapes (CUDA events), the device
  time a call of every kernel they launch and their launches a call
  (the profiler), and the host's time a call (the host clock around 200
  calls, synchronised once at the end);
- where the host time of a K13 bf16 and a K13b bf16 call goes: the
  functions with the most own time over 500 calls (``cProfile``);
- GRRGCN's ring_pallas training step in bf16 (milliseconds a step over
  steps 3-14 of epoch 0 from the smoke's seeded weights and draws, then
  the device time a step of all kernels and of the ring kernels over two
  traced steps, with their launches a step) and its valid sweep in bf16,
  twice (wall seconds of each, MRR, launches);
- a hash of the bf16 outputs of K13 (out, norm^2) and K13b (dh, dw) at
  both shapes and of the 14 steps' losses: equal hashes in two checkouts
  say they compute the same bits.

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


def _measure_bf16(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from temp_tpu_torch.parallel import ring_spmm as rs

    if not torch.cuda.is_available():
        raise SystemExit("ring_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    BF = torch.bfloat16
    res = {"root": root, "smi": cs.smi_line(), "mode": "bf16"}
    res.update(cs.phase_build())
    ctx = cs.phase_setup("cuda")
    rctx = cs.phase_setup_ring(ctx)
    dev = rctx["device"]
    devices = rctx["mesh"].devices[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    hashes = []
    for tag, args, r, tab in cs._k13_cases(rctx):
        ring = (cs.RING_M, r, devices)
        with torch.no_grad():
            out, n2 = rs.ring_spmm_fwd(*args, *ring, tables=tab, hot=BF)
        g = torch.randn(out.shape, generator=gen, device=dev)
        calls = {
            "k13": lambda: rs.ring_spmm_fwd(*args, *ring, tables=tab,
                                            hot=BF),
            "k13b": lambda: rs.ring_spmm_bwd(g, n2, *args, *ring,
                                             tables=tab, hot=BF)}
        hashes += [out, n2, *calls["k13b"]()]
        for name, fn in calls.items():
            dev_ms, launches = _device_all(fn)
            res[f"{name}_bf16_{tag}"] = {
                "call_ms": cs.time_ms(fn, dev),
                "host_ms": _host_ms(fn),
                "device_ms_a_call": dev_ms, "launches_a_call": launches}
            if tag == "final":
                res[f"{name}_bf16_host_profile"] = _host_profile(fn)
    cfg = rctx["cfg"].replace(compute_dtype="bfloat16")
    step = _ring_steps(rctx, cfg)
    hashes.append(torch.tensor(step.pop("losses")))
    res["bf16_ring_step"] = step
    sweeps = [cs._sweep(rctx, cfg)[0] for _ in range(2)]
    res["bf16_ring_sweep"] = {"wall_s": [m["wall_s"] for m in sweeps],
                              "mrr": sweeps[0]["mrr"],
                              "launches": sweeps[0]["launches"]}
    res["hash"] = _hash(hashes)
    return res


def _device_all(fn, reps: int = 5):
    """(device ms a call of every kernel fn launches, launches a call),
    from the profiler over reps calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = [t for _, t in _kernel_events(prof)]
    return sum(ms) / reps, len(ms) / reps


def _kernel_events(prof):
    """(name, device ms) of each device event of a profile."""
    import torch

    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None)
            yield ev.name, (ev.cuda_time_total if us is None else us) / 1e3


def _host_ms(fn, reps: int = 200) -> float:
    """The host's milliseconds a call of fn: the host clock around reps
    calls that queue their work, synchronised once after them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def _host_profile(fn, reps: int = 500, top: int = 12) -> list:
    """The `top` functions by own host time over reps calls of fn
    (cProfile): [name, own us a call, calls a call]."""
    import cProfile
    import pstats

    import torch

    fn()
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    st = pstats.Stats(prof).stats
    rows = sorted(((f"{os.path.basename(k[0])}:{k[2]}", v[2] * 1e6 / reps,
                    v[1] / reps) for k, v in st.items()),
                  key=lambda r: -r[1])
    return [[n, round(us, 3), c] for n, us, c in rows[:top]]


def _ring_steps(rctx, cfg, steps: int = 12, warm: int = 2) -> dict:
    """Training steps of cfg from the smoke's seeded weights and draws:
    ms a step over `steps` steps after `warm`, their losses, then over two
    traced steps the device time a step of all kernels and of the ring
    kernels (names with "ring"), and their launches a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer

    model = get_model(cfg, rctx["data"], device=rctx["device"])
    tr = Trainer(cfg, model, rctx["data"], mesh=rctx.get("mesh"))
    params, opt = tr.init_state()
    batches = tr.epoch_batches(0)[:warm + steps + 2]
    it = iter(range(len(batches)))

    def step():
        i = next(it)
        t_pos, t_valid = batches[i]
        return tr.train_step(params, opt, t_pos, t_valid,
                             gen=tr.step_generator(0, i))

    losses = [step() for _ in range(warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 2
    evs = list(_kernel_events(prof))
    ring = [t for name, t in evs if "ring" in name]
    return {"ms_per_step": ms, "traced_wall_ms": wall,
            "busy_ms": sum(t for _, t in evs) / 2,
            "ring_kernels_ms": sum(ring) / 2,
            "ring_launches_a_step": len(ring) / 2,
            "losses": [float(x) for x in losses]}


def _hash(items) -> str:
    """sha256 (16 hex digits) of the bytes of the tensors in items."""
    import hashlib

    import torch

    m = hashlib.sha256()
    for x in items:
        t = x.detach().contiguous().cpu().reshape(-1)
        m.update(str(t.dtype).encode())
        m.update(t.view(torch.uint8).numpy().tobytes())
    return m.hexdigest()[:16]


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
    ap.add_argument("--bf16", action="store_true",
                    help="measure the bfloat16 mode (see above)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        measure = _measure_bf16 if args.bf16 else _measure
        print(json.dumps(measure(os.path.abspath(args.one))), flush=True)
        return 0
    runs = []
    for tag in args.order:
        root = os.path.abspath(args.old if tag == "O" else args.new)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), args.old, args.new,
             "--one", root] + (["--bf16"] if args.bf16 else []), cwd=root,
            capture_output=True, text=True, timeout=900)
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
