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

With --bf16 each run measures the bfloat16 modes of the window and of the
final step's backward instead:

- K2f bfloat16 (``hot=torch.bfloat16``) on the same three windows, a call
  and the device time a launch;
- K2b bfloat16 on the training windows (seeded cotangents): a call, and
  the device time a call of its GRU, input and weight launches
  (``window_bwd_gru``, ``window_bwd_input``, ``window_wgrad_kernel``);
- K5 bfloat16 (``fused_final_bwd_layer``, both layers, on the smoke's
  first training batch, its history in bfloat16, seeded cotangents) and
  K9+K10 bfloat16 (``bi_layer_bwd``, both layers, on the flagship's): a
  call, and the device time a call of their GRU, input and weight
  launches (``final_bwd_gru_kernel``, ``final_bwd_input_kernel``,
  ``final_wgrad_kernel``; ``bi_bwd_gru_kernel``, ``final_bwd_input_kernel``,
  ``bi_wgrad_kernel``);
- GRRGCN's and the flagship's default training step (compute_dtype
  "auto", bfloat16 on the card): milliseconds a step over steps 3-8 of
  epoch 0 from the smoke's seeded weights and draws, and over two more
  traced steps the device time a step of all kernels, of the window's,
  K5's and K9+K10's launches by name, and of the largest five;
- a hash of the outputs of every kernel whose sources the window's and the
  final step's code share, in both dtypes, on the smoke's seeded inputs:
  K2f (the three windows), K2b, K12 (the training window), K3, K4, K5
  (GRRGCN's final step), K6+K7, K8, K4 on the bi table, K9+K10 (the
  flagship's), K11 (a valid batch), and K13 with K13b (the ring layout's
  two shapes) in float32 and in bfloat16. Equal hashes in two checkouts
  say those kernels compute the same bits. A change that sums a kernel's
  products in another order changes its hashes by design: K5's and
  K9+K10's bfloat16 ones ("k5_bf16", "k9k10_bf16") against a parent whose
  K5 and K9+K10 bfloat16 took one TF32 product of the rounded operands a
  k8 step; every other hash stays.

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
import time

_K2F = "window_layer"
_BI = ("bi_bwd_gru_kernel", "bi_wgrad_kernel", "final_bwd_input_kernel")
_K5 = ("final_bwd_gru_kernel", "final_bwd_input_kernel", "final_wgrad_kernel")


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


def _hash(*items) -> str:
    """sha256 (16 hex digits) of the bytes of the tensors in items (nested
    lists and tuples; None skipped)."""
    import hashlib

    import torch

    m = hashlib.sha256()

    def add(x):
        if x is None:
            return
        if isinstance(x, (list, tuple)):
            for y in x:
                add(y)
            return
        t = x.detach().contiguous().cpu().reshape(-1)
        m.update(str(t.dtype).encode())
        m.update(t.view(torch.uint8).numpy().tobytes())

    add(items)
    return m.hexdigest()[:16]


def _final_inputs(cs, ctx, hot):
    """K3-K5's inputs on the smoke's first training batch, the history in
    the store dtype (float32, or `hot`)."""
    h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab = cs.final_batch(
        ctx)["fwd"]
    if hot is not None:
        h1, h2 = h1.to(hot).contiguous(), h2.to(hot).contiguous()
    return h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab


def _bi_inputs(cs, fctx, hot):
    """The flagship's final-step inputs (``final_batch_flagship``) with its
    histories and local tables in the store dtype: (fb_, a1, a2 without its
    input, kw2)."""
    fb_ = cs.final_batch_flagship(fctx)
    hists = [h if hot is None else h.to(hot).contiguous()
             for h in fb_["hists"]]
    h1f, h2f, hlf, h1b, h2b, hlb = hists
    bg, h0x, wrel = fb_["bg"], fb_["h0x"], fb_["wrel"]
    g, d = fb_["grus"], h0x.shape[2]
    loop1, loop2 = fb_["loops"]
    a1 = (h0x, h1f, h1b, bg, bg.gr.m1, wrel, 0, loop1, g["1f"], g["1b"])
    a2 = (h2f, h2b, bg, bg.gr.m2, wrel, d, loop2, g["2f"], g["2b"])
    kw2 = {"relu": True, "hl": (hlf, hlb), "imp": fb_["imp"],
           "csr": fb_["csr"]}
    return fb_, a1, a2, kw2


def _hashes(cs, ctx, fctx, cases, dev) -> dict:
    """The output hashes of --bf16 (the module docstring says which)."""
    import torch

    from temp_tpu_torch.ops import fused_final as ff
    from temp_tpu_torch.ops import fused_final_bi as fb
    from temp_tpu_torch.ops import fused_window as fw
    from temp_tpu_torch.ops.fused_window_mb import fused_window_mb_fwd
    from temp_tpu_torch.parallel.ring_spmm import ring_spmm_bwd, ring_spmm_fwd

    BF = torch.bfloat16
    out = {}
    a = {k: v for k, v in cases["train"].items() if k != "conv1_in"}
    B, L1, A, d = a["h0x"].shape
    eb = cs.eval_batch(ctx)
    for tag, hot in (("f32", None), ("bf16", BF)):
        for case, args in cases.items():
            out[f"k2f_{tag}_{case}"] = _hash(fw.fused_window_fwd(**args,
                                                                 hot=hot))
        gen = torch.Generator(device=dev).manual_seed(7)
        gbs = [torch.randn(B, L1, A, d, generator=gen, device=dev)
               for _ in range(2)]
        if hot is not None:
            gbs = [x.to(hot) for x in gbs]
        bufs = fw.fused_window_fwd(**a, conv1_in=False, hot=hot)
        out[f"k2b_{tag}"] = _hash(fw.fused_window_bwd(
            **a, buf1=bufs[0], buf2=bufs[1], gb1=gbs[0], gb2=gbs[1],
            hot=hot))
        out[f"k12_{tag}"] = _hash(fused_window_mb_fwd(**cases["train"],
                                                      hot=hot))

        fin = _final_inputs(cs, ctx, hot)
        h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab = fin
        loss, saved = ff.fused_final_fwd(*fin, hot=hot)
        out[f"k3_{tag}"] = _hash(loss, saved["table"], saved["out1"])
        got4 = ff.fused_final_bwd_loss(saved, rtab, gr, cs.final_batch(
            ctx)["tv"], hot=hot)
        out[f"k4_{tag}"] = _hash(got4)
        d_out2, _ = ff.select_bwd(got4[0], gr.active)
        l2 = ff.fused_final_bwd_layer(saved["out1"], h2, gr, gr.m2, wrel,
                                      d, loop2, g2, d_out2, hot=hot)
        l1 = ff.fused_final_bwd_layer(h0, h1, gr, gr.m1, wrel, 0, loop1, g1,
                                      l2[0], hot=hot)
        out[f"k5_{tag}"] = _hash(l2, l1)

        fb_, a1, a2, kw2 = _bi_inputs(cs, fctx, hot)
        bg, rtab, csr = fb_["bg"], fb_["rtab"], fb_["csr"]
        gr = bg.gr
        sel = fb_["h0x"] if bg.noact else None
        o1 = fb.bi_layer_fwd(*a1, csr=csr, hot=hot)
        table = fb.bi_layer_fwd(o1, *a2, **kw2, sel=sel, hot=hot)
        out[f"k6k7_{tag}"] = _hash(o1, table)
        loss, saved = fb.bi_loss_fwd(table, rtab, gr, csr, hot=hot)
        out[f"k8_{tag}"] = _hash(loss, [saved[k] for k in (
            "qhat", "lse", "scpos") if k in saved])
        got4 = ff.fused_final_bwd_loss(saved, rtab, gr, fb_["tv"], hot=hot)
        out[f"k4_bi_{tag}"] = _hash(got4)
        d_out2, _ = ff.select_bwd(got4[0], gr.active if bg.noact else None)
        l2 = fb.bi_layer_bwd(o1, *a2, d_out2.contiguous(), **kw2, hot=hot)
        l1 = fb.bi_layer_bwd(*a1, l2[0], csr=csr, hot=hot)
        out[f"k9k10_{tag}"] = _hash(l2, l1)

        h0, hist1, hist2, gr, q, wrel, loop1, loop2, g1, g2, rtab = eb["args"]
        if hot is not None:
            hist1, hist2 = hist1.to(hot), hist2.to(hot)
        with torch.no_grad():
            out[f"k11_{tag}"] = _hash(ff.fused_eval_ranks(
                h0, hist1.contiguous(), hist2.contiguous(), gr, q, wrel,
                loop1, loop2, g1, g2, rtab, hot=hot))

    rctx = cs.phase_setup_ring(ctx)
    for case, args, rows, tables in cs._k13_cases(rctx):
        ring = (cs.RING_M, rows, rctx["mesh"].devices[0])
        for tag, hot in (("f32", None), ("bf16", BF)):
            gen = torch.Generator(device=dev).manual_seed(11)
            with torch.no_grad():
                o, n2 = ring_spmm_fwd(*args, *ring, tables=tables, hot=hot)
                g = torch.randn(args[0].shape, generator=gen, device=dev)
                dh, dw = ring_spmm_bwd(g, n2, *args, *ring, tables=tables,
                                       hot=hot)
            out[f"k13_{tag}_{case}"] = _hash(o, n2, dh, dw)
    return out


def _bf16_backward(cs, ctx, fctx, dev) -> dict:
    """K5 bfloat16 (both layers, GRRGCN's final step) and K9+K10 bfloat16
    (both layers, the flagship's) on seeded cotangents: a call's
    milliseconds, and the device time and launches a call of each launch
    by kernel name."""
    import torch

    from temp_tpu_torch.ops import fused_final as ff
    from temp_tpu_torch.ops import fused_final_bi as fb

    BF = torch.bfloat16
    h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab = _final_inputs(
        cs, ctx, BF)
    d = h0.shape[1]
    gen = torch.Generator(device=dev).manual_seed(9)
    d_out = torch.randn(h1.shape, generator=gen, device=dev)
    csr = ff.final_csr(gr, h1.shape[1], max(wrel.shape[0], rtab.shape[0]))
    out1 = torch.randn(h1.shape, generator=gen, device=dev)

    def k5():
        ff.fused_final_bwd_layer(out1, h2, gr, gr.m2, wrel, d, loop2, g2,
                                 d_out, csr=csr, hot=BF)
        ff.fused_final_bwd_layer(h0, h1, gr, gr.m1, wrel, 0, loop1, g1,
                                 d_out, csr=csr, hot=BF)

    fb_, a1, a2, kw2 = _bi_inputs(cs, fctx, BF)
    x2 = torch.randn(fb_["h0x"].shape, generator=gen, device=dev)
    d_bi = torch.randn(x2.shape, generator=gen, device=dev)

    def k9k10():
        fb.bi_layer_bwd(x2, *a2, d_bi, **kw2, hot=BF)
        fb.bi_layer_bwd(*a1, d_bi, csr=fb_["csr"], hot=BF)

    res = {}
    for tag, run, names in (("k5_bf16", k5, _K5), ("k9k10_bf16", k9k10,
                                                    _BI)):
        dev_ms = _device_ms(run, list(names))
        res[tag] = {
            "call_ms": cs.time_ms(run, dev, reps=10),
            **{f"{n}_ms_a_call": t for n, (t, _) in dev_ms.items()},
            **{f"{n}_launches_a_call": k for n, (_, k) in dev_ms.items()}}
    return res


_K2B = ("window_bwd_gru", "window_bwd_input", "window_wgrad_kernel")


def _default_step(c, steps: int = 6, warm: int = 2, names=()) -> dict:
    """Training steps of config c with compute_dtype "auto" from the
    smoke's seeded weights and draws: ms a step over `steps` steps after
    `warm`, then the device time a step over two more traced (``_traced``,
    with the kernels `names` by name besides its own).
    """
    import torch

    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer

    cfg = c["cfg"].replace(compute_dtype="auto")
    model = get_model(cfg, c["data"], device=c["device"])
    tr = Trainer(cfg, model, c["data"])
    params, opt = tr.init_state()
    # warm, timed, and the profiler's warm-up and two steps
    batches = tr.epoch_batches(0)[:warm + steps + 3]
    it = iter(range(len(batches)))

    def step():
        i = next(it)
        t_pos, t_valid = batches[i]
        return tr.train_step(params, opt, t_pos, t_valid,
                             gen=tr.step_generator(0, i))

    for _ in range(warm):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    return {"resolved": model.cfg.compute_dtype, "ms_per_step": ms,
            **_traced(step, 2, names)}


def _traced(fn, reps: int, names=()) -> dict:
    """Device time a call of fn over `reps` traced calls (after one more):
    every kernel's ("busy"), the window kernels' and K5's and K9+K10's by
    name (and `names`'), the largest five names, and the traced wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    per = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(ev, "device_time_total", None)
            us = ev.cuda_time_total if us is None else us
            t, n = per.get(ev.name, (0.0, 0))
            per[ev.name] = (t + us / 1e3 / reps, n + 1)
    out = {"traced_wall_ms": wall,
           "busy_ms": sum(t for t, _ in per.values())}
    for want in dict.fromkeys((_K2F, *_K2B, *_K5, *_BI, *names)):
        hit = [(t, n) for name, (t, n) in per.items() if want in name]
        out[f"{want}_ms_a_step"] = sum(t for t, _ in hit)
        out[f"{want}_launches_a_step"] = sum(n for _, n in hit) // reps
    out["top"] = [[name[:60], t] for name, (t, _) in
                  sorted(per.items(), key=lambda kv: -kv[1][0])[:5]]
    return out


def _measure_bf16(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from temp_tpu_torch.ops import fused_window as fw

    if not torch.cuda.is_available():
        raise SystemExit("window_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    BF = torch.bfloat16
    res = {"root": root, "smi": cs.smi_line(), "mode": "bf16"}
    res.update(cs.phase_build())
    ctx = cs.phase_setup("cuda")
    fctx = cs.phase_setup_flagship(ctx)
    dev = ctx["device"]
    cases = _cases(cs, fw, ctx, fctx)
    for tag, args in cases.items():
        res[f"k2f_bf16_{tag}"] = _k2f(cs, fw, dict(args, hot=BF), dev)
    a = {k: v for k, v in cases["train"].items() if k != "conv1_in"}
    B, L1, A, d = a["h0x"].shape
    gen = torch.Generator(device=dev).manual_seed(8)
    gbs = [torch.randn(B, L1, A, d, generator=gen, device=dev).to(BF)
           for _ in range(2)]
    bufs = fw.fused_window_fwd(**a, conv1_in=False, hot=BF)
    bwd = dict(a, buf1=bufs[0], buf2=bufs[1], gb1=gbs[0], gb2=gbs[1],
               hot=BF)
    run = lambda: fw.fused_window_bwd(**bwd)  # noqa: E731
    dev_ms = _device_ms(run, list(_K2B))
    res["k2b_bf16"] = {
        "call_ms": cs.time_ms(run, dev, reps=10),
        **{f"{n}_ms_a_call": t for n, (t, _) in dev_ms.items()},
        **{f"{n}_launches_a_call": k for n, (_, k) in dev_ms.items()}}
    res.update(_bf16_backward(cs, ctx, fctx, dev))
    for tag, c in (("grrgcn", ctx), ("flagship", fctx)):
        res[f"default_step_{tag}"] = _default_step(c)
    res["hashes"] = _hashes(cs, ctx, fctx, cases, dev)
    return res


def _cases(cs, fw, ctx, fctx) -> dict:
    """K2f's three windows: the smoke's first eval batch (conv1_in), its
    training batch with seeded dropout masks, the flagship's
    forward-direction window (the ReLU, three buffers)."""
    import torch

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
    _, kw = cs.flagship_window_batch(fctx, "fwd")
    cases["flagship"] = dict(
        fw.window_args(fctx["params"]["encoder"], fctx["cfg"], **kw),
        conv1_in=False, n_buf=3)
    return cases


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
    dev = ctx["device"]
    fctx = cs.phase_setup_flagship(ctx)
    cases = _cases(cs, fw, ctx, fctx)
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
    ap.add_argument("--bf16", action="store_true",
                    help="measure the window's bfloat16 mode (see above)")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        measure = _measure_bf16 if args.bf16 else _measure
        print(json.dumps(measure(os.path.abspath(args.one))), flush=True)
        return 0
    order = args.order or "".join(str(i) for i in range(len(args.roots)))
    runs = []
    for tag in order:
        root = os.path.abspath(args.roots[int(tag)])
        cmd = [sys.executable, os.path.abspath(__file__), *args.roots,
               "--one", root] + (["--bf16"] if args.bf16 else [])
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
