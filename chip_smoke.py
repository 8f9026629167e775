#!/usr/bin/env python3
"""Chip smoke of temp_tpu_torch: the port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds as it ends:

1. device  - the card's name and power limit;
2. build   - one nvcc call for every kernel source, with the register and
             spill summary of each kernel;
3. setup   - a synthetic dataset at icews14's sizes (7128 entities, 230
             relations, 365 times, 200 train facts a time) and the
             grid/icews14/config_grrgcn.json model with seeded random weights;
4. k1      - kernel K1 (spmm_fwd) against its plain PyTorch version at the
             final-snapshot shape and at the eval conv1-table shape;
5. k2      - kernel K2 (fused_window_fwd) against its plain version on one
             eval batch of windows, for both conv1_in values;
6. path    - Trainer.run_eval over the whole valid split, with the kernels
             and then with their plain versions; the launch counts of the
             kernel run, the MRR of both, and the share of identical ranks;
7. k1b     - kernel K1b (spmm_bwd) against its plain version at the
             training final-step shape (the 50% edge subsample);
8. k2b     - kernel K2f in train mode (dropout masks) and K2b
             (fused_window_bwd) against autograd through the plain forward
             on one training batch of windows: all 12 cotangents;
9. train   - Trainer.train_step at the full config (fused_final off) for a
             few optimizer steps from seeded weights and draws, with the
             kernels and then with their plain versions; both loss
             trajectories, the launch counts of the kernel run (K1f, K1b,
             K2f, K2b), then one run_eval of the trained weights.

Then a "kernels" JSON line, the nvidia-smi name/power-limit line, and the
result line {"ok": true, "device": {...}}. Any failed check raises and exits
non-zero; there is no result line then. Without CUDA it exits 1 at once. A
watchdog ends a run that stops making progress and names the phase it was in.
TF32 is off for every product, on the kernels' side and the plain side.
"""

from __future__ import annotations

import faulthandler
import json
import os
import signal
import subprocess
import sys
import time
from contextlib import contextmanager

WATCHDOG_S = 300
TOL = 1e-4           # kernel vs plain, max abs error, f32 at full width
MRR_TOL = 1e-4       # whole valid sweep, kernels vs plain path
# gradients summed over many rows (weight cotangents over B*L1*A = 71,680
# rows): max abs error relative to max(1, the largest entry)
GRAD_TOL = 1e-4
# loss trajectories over a few Adam steps, kernels vs plain path, relative:
# f32 sums in another order, carried through the steps
TRAIN_TOL = 1e-4
TRAIN_STEPS = 8
H100_F32_FLOPS = 67e12   # f32 outside the tensor cores, SXM data sheet
H100_BYTES_S = 3.35e12   # HBM3

_state = {"phase": "start"}


def _on_alarm(signum, frame):
    print(f"WATCHDOG: no result after {WATCHDOG_S} s; stuck in phase "
          f"'{_state['phase']}'", flush=True)
    os._exit(1)


@contextmanager
def phase(name: str, out: dict):
    """Run one phase; print its line with the elapsed seconds at its end."""
    _state["phase"] = name
    t0 = time.perf_counter()
    yield out
    out["seconds"] = time.perf_counter() - t0
    fields = " ".join(f"{k}={v}" for k, v in out.items()
                      if not isinstance(v, (dict, list)))
    print(f"[{name}] {fields}", flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, device, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call; CUDA events on the card (the CPU clock is
    used only by the CPU rehearsal of the phases)."""
    import torch

    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def phase_device() -> dict:
    import torch

    return {"kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "smi": smi_line()}


def phase_build() -> dict:
    from temp_tpu_torch import _build

    t0 = time.perf_counter()
    report = _build.build()
    seconds = time.perf_counter() - t0
    _build.lib()
    print(_build.ptxas_summary(report), flush=True)
    return {"nvcc_s": round(seconds, 3), "built": bool(report)}


def phase_setup(device, num_ents=7128, num_rels=230, num_times=365,
                edges_per_time=200, seed=0, **cfg_over) -> dict:
    import torch

    from temp_tpu_torch.config import TKGConfig
    from temp_tpu_torch.data.snapshots import make_synthetic
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.train.loop import Trainer

    root = os.path.dirname(os.path.abspath(__file__))
    cfg = TKGConfig.from_json_file(
        os.path.join(root, "grid", "icews14", "config_grrgcn.json"),
        fused_window=True, **cfg_over)
    data = make_synthetic(num_ents=num_ents, num_rels=num_rels,
                          num_times=num_times, edges_per_time=edges_per_time,
                          seed=seed, edge_pad_multiple=cfg.edge_pad_multiple)
    model = get_model(cfg, data, device=device)
    params = model.init_params(cfg.seed)
    trainer = Trainer(cfg, model, data)
    return {"cfg": cfg, "data": data, "model": model, "params": params,
            "trainer": trainer, "device": torch.device(device),
            "N": num_ents, "T": data.num_times,
            "A": int(data.act_idx.shape[1]),
            "E": int(data.train.src.shape[1]),
            "L1": cfg.train_seq_len - 1, "B": cfg.eval_batch,
            "d": cfg.embed_size}


def _spmm_bound(h, src, rel, emask, n_rows):
    """Least time for one K1 call: the referenced rows of h and w, the edge
    arrays and the output moved once, against 3 flops per edge column."""
    m = emask.bool()
    d = h.shape[1]
    rows = int(src[m].unique().numel()) + int(rel[m].unique().numel())
    nbytes = rows * d * 4 + src.numel() * 16 + n_rows * d * 4
    flops = 3 * int(m.sum()) * d
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_k1(ctx) -> dict:
    import torch

    from temp_tpu_torch.ops.spmm import spmm_fwd, spmm_fwd_plain

    dev, p, tr = ctx["device"], ctx["params"], ctx["trainer"]
    data = tr.data
    w = p["encoder"]["layer1"]["weight"]
    t = data.num_times // 2
    out = {}
    # the final-snapshot shape: all N entity rows, one snapshot's edges
    final = (p["ent_embeds"], data.train.src[t], data.train.dst[t],
             data.train.rel[t], data.train.emask[t], w)
    # the conv1-table shape: all T snapshots' active rows side by side
    A = ctx["A"]
    offs = (torch.arange(data.num_times, device=dev) * A)[:, None]
    h_tab = p["ent_embeds"][data.act_idx.long().clamp(max=ctx["N"] - 1)]
    table = (h_tab.reshape(-1, ctx["d"]).contiguous(),
             (data.train_src_loc + offs).reshape(-1),
             (data.train_dst_loc + offs).reshape(-1),
             data.train.rel.reshape(-1), data.train.emask.reshape(-1), w)
    for tag, args in (("final", final), ("table", table)):
        k = spmm_fwd(*args)
        ref = spmm_fwd_plain(*args)
        err = max_err(k, ref)
        if not err <= TOL:
            raise AssertionError(f"K1 {tag}: max abs err {err} > {TOL}")
        h, src, dst, rel, em, _ = args
        msg = h[src.long()] * w[rel.long()] * em.to(h.dtype)[:, None]
        lib = torch.zeros_like(h)
        bound_ms, bound_by = _spmm_bound(h, src, rel, em, h.shape[0])
        out[tag] = {
            "shape": f"N={h.shape[0]} E={src.numel()} R={w.shape[0]} "
                     f"d={h.shape[1]}",
            "max_abs_err": err,
            "ms": time_ms(lambda: spmm_fwd(*args), dev),
            "plain_ms": time_ms(lambda: spmm_fwd_plain(*args), dev),
            "library_ms": time_ms(
                lambda: lib.zero_().index_add_(0, dst.long(), msg), dev),
            "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  K1 {tag}: {out[tag]}", flush=True)
    return out


def window_batch(ctx, conv1_in: bool):
    """The K2 arguments of the first eval batch of the valid sweep, as the
    path prepares them."""
    import torch

    from temp_tpu_torch.models.dynamic import gather_window

    model, data, p = ctx["model"], ctx["trainer"].data, ctx["params"]
    L1, B = ctx["L1"], ctx["B"]
    tp = torch.arange(B, device=ctx["device"]) + data.num_times // 2
    win = gather_window(data, tp, L1 + 1)
    prev_step = model.tbl_fwd.prev_step[tp].long()
    prev_row = model.tbl_fwd.prev_row[tp].long()
    pos = torch.arange(L1, device=ctx["device"])[None, :, None]
    dt = (pos - prev_step.clamp(min=0)).to(torch.float32)
    if conv1_in:
        h0 = model._window_conv1(model.precompute_eval_conv1(p, data), tp,
                                 L1 + 1)
    else:
        h0 = model._rows(p, win.act_idx[:, :L1])
    return win, dict(h0_xs=h0, src=win.src_loc[:, :L1],
                     dst=win.dst_loc[:, :L1], rel=win.rel[:, :L1],
                     emask=win.emask[:, :L1], prev_step=prev_step,
                     prev_row=prev_row, dt=dt, live=prev_step >= 0,
                     conv1_in=conv1_in)


def _window_bound(ctx, win, conv1_in: bool, masks: bool = False):
    """Least time for one K2 call: f32 flops of the GRU gate products
    (4 of [rows, d] x [d, 3d] a step), the self-loop products and the SpMMs
    over the active rows and real edges, against the buffers and inputs
    (the two dropout masks in training) moved once."""
    L1, d = ctx["L1"], ctx["d"]
    rows = int(win.act_mask[:, :L1].sum())
    edges = int(win.emask[:, :L1].sum())
    n_conv = 1 if conv1_in else 2
    flops = rows * (4 * 2 * d * 3 * d + n_conv * 2 * d * d) \
        + n_conv * edges * 3 * d
    n_rel = ctx["params"]["encoder"]["layer1"]["weight"].shape[0]
    w_bytes = (2 * d * 3 * d * 2 + 2 * d * d + n_rel * 2 * d) * 4
    nbytes = (rows * d * 4 * (5 if masks else 3) + edges * 16 + rows * 12
              + w_bytes)
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_k2(ctx) -> dict:
    from temp_tpu_torch.ops.fused_window import fused_window_scan

    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    out = {}
    for conv1_in in (True, False):
        win, kw = window_batch(ctx, conv1_in)
        run_k = lambda: fused_window_scan(p["encoder"], cfg, **kw)  # noqa
        run_p = lambda: fused_window_scan(p["encoder"], cfg,  # noqa: E731
                                          kernels=False, **kw)
        k1, k2 = run_k()
        r1, r2 = run_p()
        err = max(max_err(k1, r1), max_err(k2, r2))
        if not err <= TOL:
            raise AssertionError(f"K2 conv1_in={conv1_in}: max abs err "
                                 f"{err} > {TOL}")
        bound_ms, bound_by = _window_bound(ctx, win, conv1_in)
        tag = "conv1_in" if conv1_in else "recompute"
        out[tag] = {
            "shape": f"B={ctx['B']} L1={ctx['L1']} A={ctx['A']} "
                     f"E={ctx['E']} d={ctx['d']}",
            "max_abs_err": err, "ms": time_ms(run_k, dev, reps=5),
            "plain_ms": time_ms(run_p, dev, reps=5),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"  K2 {tag}: {out[tag]}", flush=True)
    return out


def phase_path(ctx) -> dict:
    """The valid sweep with the kernels, then with their plain versions."""
    import numpy as np
    import torch

    from temp_tpu_torch.models.objectives import metrics_from_ranks
    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.ops.fused_window import fused_window_fwd
    from temp_tpu_torch.ops.spmm import spmm_fwd
    from temp_tpu_torch.train.loop import Trainer

    dev, cfg = ctx["device"], ctx["cfg"]
    res = {}
    runs = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        c = cfg.replace(kernels=kernels)
        tr = Trainer(c, get_model(c, ctx["data"], device=dev), ctx["data"])
        spmm_fwd.launches = 0
        fused_window_fwd.launches = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ranks, mask, bces = tr.eval_sweep(ctx["params"], "valid")
        ranks, mask = ranks.cpu().numpy(), mask.cpu().numpy()
        wall = time.perf_counter() - t0
        m = metrics_from_ranks(ranks, mask)
        m["loss"] = float(bces.mean())
        m["wall_s"] = wall
        m["k1_launches"] = spmm_fwd.launches
        m["k2_launches"] = fused_window_fwd.launches
        runs[name] = (ranks, mask)
        res[name] = m
        print(f"  path {name}: {m}", flush=True)
    (rk, mk), (rp, mp) = runs["kernels"], runs["plain"]
    n_q = 2 * int(ctx["data"].valid.emask.sum())
    k, pl = res["kernels"], res["plain"]
    if not (np.array_equal(mk, mp) and k["n"] == pl["n"] == n_q):
        raise AssertionError(f"query masks differ or miss queries: "
                             f"{k['n']} / {pl['n']} / {n_q}")
    if not (np.isfinite(k["mrr"]) and np.isfinite(k["loss"])
            and 0.0 < k["mrr"] <= 1.0):
        raise AssertionError(f"bad metrics {k}")
    if not abs(k["mrr"] - pl["mrr"]) <= MRR_TOL:
        raise AssertionError(f"MRR kernels {k['mrr']} vs plain {pl['mrr']}")
    if dev.type == "cuda" and not (k["k1_launches"] > 0
                                   and k["k2_launches"] > 0):
        raise AssertionError(f"main path missed a kernel: {k}")
    res["same_rank_share"] = float(np.mean(rk[mk] == rp[mp]))
    return res


def rel_err(a, b) -> float:
    """max |a - b| / max(1, max |b|)."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def phase_k1b(ctx) -> dict:
    """K1b against its plain version at the training final-step shape: all
    N rows, one snapshot's padded train edges with the 50% subsample."""
    import torch

    from temp_tpu_torch.ops.sampling import subsample_edges
    from temp_tpu_torch.ops.spmm import _spmm_fwd, spmm_bwd, spmm_bwd_plain

    dev, p, data = ctx["device"], ctx["params"], ctx["trainer"].data
    t = data.num_times // 2
    gen = torch.Generator(device=dev).manual_seed(0)
    em = subsample_edges(gen, data.train.emask[t], 0.5)
    h, w = p["ent_embeds"], p["encoder"]["layer1"]["weight"]
    src, dst, rel = data.train.src[t], data.train.dst[t], data.train.rel[t]
    _, n2 = _spmm_fwd(h, src, dst, rel, em, w)
    g = torch.randn(h.shape, generator=gen, device=dev)
    args = (g, n2, h, src, dst, rel, em, w)
    dh, dw = spmm_bwd(*args)
    rh, rw = spmm_bwd_plain(*args)
    err_h, err_w = max_err(dh, rh), max_err(dw, rw)
    if not (err_h <= TOL and err_w <= TOL):
        raise AssertionError(f"K1b: max abs err dh {err_h}, dw {err_w} > {TOL}")
    # the library yardstick: the same backward as two index_add_ calls on
    # the per-edge messages (computed outside the timing)
    emf = em.to(torch.float32)[:, None]
    dmsg = (g * n2[:, None])[dst.long()] * emf
    mh, mw = dmsg * w[rel.long()], dmsg * h[src.long()]
    lib_h, lib_w = torch.zeros_like(h), torch.zeros_like(w)

    def library():
        lib_h.zero_().index_add_(0, src.long(), mh)
        lib_w.zero_().index_add_(0, rel.long(), mw)

    m = em.bool()
    d, n_kept = h.shape[1], int(m.sum())
    rows = (int(dst[m].unique().numel()) + int(src[m].unique().numel())
            + int(rel[m].unique().numel()))
    nbytes = (rows * d * 4 + src.numel() * 16 + h.shape[0] * 4
              + (h.shape[0] + w.shape[0]) * d * 4)
    flops = 6 * n_kept * d
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    out = {"shape": f"N={h.shape[0]} E={src.numel()} kept={n_kept} "
                    f"R={w.shape[0]} d={d}",
           "max_abs_err": max(err_h, err_w), "err_dh": err_h, "err_dw": err_w,
           "ms": time_ms(lambda: spmm_bwd(*args), dev),
           "plain_ms": time_ms(lambda: spmm_bwd_plain(*args), dev),
           "library_ms": time_ms(library, dev),
           "bound_ms": max(t_b, t_f) * 1e3,
           "bound_by": "bytes" if t_b >= t_f else "operations"}
    print(f"  K1b: {out}", flush=True)
    return out


_COTANGENTS = ("dh0x", "dwrel", "dloop1", "dloop2", "dwih1", "dwhh1",
               "dwih2", "dwhh2", "dbih1", "dbhh1", "dbih2", "dbhh2")


def _window_bwd_bound(ctx, win):
    """Least time for one K2b call: f32 flops over the active rows (per row
    and layer two GRU gate products and one self-loop product recomputed,
    and for each of them the input and the weight cotangent products:
    84 d^2 a row) and the SpMMs and their transposes over the real edges
    (16 d an edge), against the buffers, masks and cotangents read once
    and dh0x written once."""
    L1, d = ctx["L1"], ctx["d"]
    rows = int(win.act_mask[:, :L1].sum())
    edges = int(win.emask[:, :L1].sum())
    flops = rows * 84 * d * d + edges * 16 * d
    n_rel = ctx["params"]["encoder"]["layer1"]["weight"].shape[0]
    w_bytes = (4 * d * 3 * d * 2 + 2 * d * d * 2 + n_rel * 2 * d * 2) * 4
    nbytes = rows * d * 4 * 8 + edges * 16 + rows * 12 + w_bytes
    t_b, t_f = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def phase_k2b(ctx) -> dict:
    """K2f in train mode and K2b against autograd through the plain forward
    on the first training-shaped batch of windows, seeded masks and
    cotangents."""
    import torch

    from temp_tpu_torch.ops.fused_window import (
        fused_window_bwd, fused_window_bwd_plain, fused_window_fwd,
        fused_window_fwd_plain, window_args,
    )

    dev, p, cfg = ctx["device"], ctx["params"], ctx["cfg"]
    win, kw = window_batch(ctx, False)
    kw.pop("conv1_in")
    B, L1, A, d = kw["h0_xs"].shape
    keep = 1.0 - cfg.dropout
    gen = torch.Generator(device=dev).manual_seed(0)
    m1, m2 = ((torch.rand(B, L1, A, d, generator=gen, device=dev) < keep)
              .to(torch.float32) / keep for _ in range(2))
    gb1, gb2 = (torch.randn(B, L1, A, d, generator=gen, device=dev)
                for _ in range(2))
    a = window_args(p["encoder"], cfg, masks=(m1, m2), **kw)
    fwd_args = dict(a, conv1_in=False)
    k1, k2 = fused_window_fwd(**fwd_args)
    r1, r2 = fused_window_fwd_plain(**fwd_args)
    err_fwd = max(max_err(k1, r1), max_err(k2, r2))
    if not err_fwd <= TOL:
        raise AssertionError(f"K2f train: max abs err {err_fwd} > {TOL}")
    bwd_args = dict(a, buf1=k1, buf2=k2, gb1=gb1, gb2=gb2)
    got = fused_window_bwd(**bwd_args)
    ref = fused_window_bwd_plain(**a, gb1=gb1, gb2=gb2)
    errs = {n: rel_err(x, y) for n, x, y in zip(_COTANGENTS, got, ref)}
    bad = {n: e for n, e in errs.items() if not e <= GRAD_TOL}
    if bad:
        raise AssertionError(f"K2b: cotangents beyond {GRAD_TOL}: {bad}")
    fwd_bound, fwd_by = _window_bound(ctx, win, False, masks=True)
    bwd_bound, bwd_by = _window_bwd_bound(ctx, win)
    shape = f"B={B} L1={L1} A={A} E={ctx['E']} d={d}"
    out = {
        "fwd": {"shape": shape, "max_abs_err": err_fwd,
                "ms": time_ms(lambda: fused_window_fwd(**fwd_args), dev,
                              reps=5),
                "plain_ms": time_ms(lambda: fused_window_fwd_plain(
                    **fwd_args), dev, reps=3),
                "library_ms": None, "bound_ms": fwd_bound,
                "bound_by": fwd_by},
        "bwd": {"shape": shape, "max_abs_err": max(errs.values()),
                "errors": errs,
                "ms": time_ms(lambda: fused_window_bwd(**bwd_args), dev,
                              reps=5),
                "plain_ms": time_ms(lambda: fused_window_bwd_plain(
                    **a, gb1=gb1, gb2=gb2), dev, reps=3),
                "library_ms": None, "bound_ms": bwd_bound,
                "bound_by": bwd_by}}
    print(f"  K2f train: {out['fwd']}", flush=True)
    print(f"  K2b: {out['bwd']}", flush=True)
    return out


def phase_train(ctx) -> dict:
    """A few optimizer steps at the full config with the kernels, then the
    same steps (same seeded weights and draws) with their plain versions;
    then one valid sweep of the trained weights."""
    import numpy as np
    import torch

    from temp_tpu_torch.models.registry import get_model
    from temp_tpu_torch.ops.fused_window import (
        fused_window_bwd, fused_window_fwd,
    )
    from temp_tpu_torch.ops.spmm import spmm_bwd, spmm_fwd
    from temp_tpu_torch.train.loop import Trainer

    dev, cfg = ctx["device"], ctx["cfg"]
    counters = (spmm_fwd, spmm_bwd, fused_window_fwd, fused_window_bwd)
    res, trained = {}, None
    for name, kernels in (("kernels", True), ("plain", False)):
        c = cfg.replace(kernels=kernels)
        tr = Trainer(c, get_model(c, ctx["data"], device=dev), ctx["data"])
        if c.fused_final_on(dev):
            raise AssertionError("fused_final resolved on")
        params, opt = tr.init_state()
        batches = tr.epoch_batches(0)[:ctx.get("train_steps", TRAIN_STEPS)]
        for fn in counters:
            fn.launches = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses = [tr.train_step(params, opt, t_pos, t_valid,
                                gen=tr.step_generator(0, i))
                  for i, (t_pos, t_valid) in enumerate(batches)]
        losses = torch.stack(losses).cpu().tolist()
        wall = time.perf_counter() - t0
        res[name] = {"losses": losses,
                     "ms_per_step": wall * 1e3 / len(batches),
                     "launches": {fn.__name__: fn.launches
                                  for fn in counters}}
        print(f"  train {name}: {res[name]}", flush=True)
        if kernels:
            trained = (tr, params)
    k, pl = np.array(res["kernels"]["losses"]), np.array(res["plain"]["losses"])
    gap = float(np.max(np.abs(k - pl) / np.maximum(1.0, np.abs(pl))))
    res["max_rel_gap"] = gap
    if not (np.isfinite(k).all() and gap <= TRAIN_TOL):
        raise AssertionError(f"train: loss trajectories differ: {gap} > "
                             f"{TRAIN_TOL}")
    launches = res["kernels"]["launches"]
    if dev.type == "cuda" and not all(n > 0 for n in launches.values()):
        raise AssertionError(f"train path missed a kernel: {launches}")
    if dev.type == "cpu" and any(launches.values()):
        raise AssertionError(f"kernels launched on the CPU: {launches}")
    tr, params = trained
    m = tr.run_eval(params, "valid")
    if not (np.isfinite(m["mrr"]) and 0.0 < m["mrr"] <= 1.0
            and m["n"] == 2 * int(ctx["data"].valid.emask.sum())):
        raise AssertionError(f"eval after training: {m}")
    res["eval"] = m
    print(f"  train eval: {m}", flush=True)
    return res


_KERNELS = (
    ("spmm_fwd", "temp_tpu_torch/csrc/spmm.cu",
     "temp_tpu/ops/pallas_spmm.py:110"),
    ("spmm_bwd", "temp_tpu_torch/csrc/spmm.cu",
     "temp_tpu/ops/pallas_spmm.py:160"),
    ("fused_window_fwd", "temp_tpu_torch/csrc/fused_window.cu",
     "temp_tpu/ops/fused_window.py:223"),
    ("fused_window_bwd", "temp_tpu_torch/csrc/fused_window.cu",
     "temp_tpu/ops/fused_window.py:246"),
)


def kernels_line(k1: dict, k2: dict, path: dict, k1b: dict, k2b: dict,
                 train: dict) -> dict:
    """One record per kernel: its numbers at the main paths' shapes and its
    launches on the training path (``launches``) and on each path."""
    eval_launches = {"spmm_fwd": path["kernels"]["k1_launches"],
                     "fused_window_fwd": path["kernels"]["k2_launches"]}
    measured = {"spmm_fwd": k1["final"], "spmm_bwd": k1b,
                "fused_window_fwd": k2["conv1_in"],
                "fused_window_bwd": k2b["bwd"]}
    rec = []
    for name, src, replaces in _KERNELS:
        m = measured[name]
        by_path = {"train": train["kernels"]["launches"][name]}
        if name in eval_launches:
            by_path["eval"] = eval_launches[name]
        r = {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "launches": by_path["train"],
             "launches_by_path": by_path,
             "max_abs_err": m["max_abs_err"], "ms": m["ms"],
             "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
             "bound_by": m["bound_by"], "library_ms": m["library_ms"],
             "shape": m["shape"]}
        if name == "fused_window_fwd":
            r["train_mode"] = {k: k2b["fwd"][k] for k in (
                "ms", "plain_ms", "bound_ms", "max_abs_err")}
        rec.append(r)
    return {"kernels": rec}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(WATCHDOG_S)
    # backstop for a call that never returns to Python (a hung kernel under
    # synchronize): a C-level thread dumps the stacks and exits 1
    faulthandler.dump_traceback_later(WATCHDOG_S + 15, exit=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    with phase("device", {}) as dv:
        dv.update(phase_device())
    with phase("build", {}) as b:
        b.update(phase_build())
    with phase("setup", {}) as s:
        ctx = phase_setup("cuda")
        s.update({k: ctx[k] for k in ("N", "T", "A", "E", "L1", "B", "d")})
    with phase("k1", {}) as k1:
        k1.update(phase_k1(ctx))
    with phase("k2", {}) as k2:
        k2.update(phase_k2(ctx))
    with phase("path", {}) as pa:
        pa.update(phase_path(ctx))
        pa["mrr_kernels"] = pa["kernels"]["mrr"]
        pa["mrr_plain"] = pa["plain"]["mrr"]
    with phase("k1b", {}) as k1b:
        k1b.update(phase_k1b(ctx))
    with phase("k2b", {}) as k2b:
        k2b.update(phase_k2b(ctx))
    with phase("train", {}) as tra:
        tra.update(phase_train(ctx))
        tra["loss_kernels_last"] = tra["kernels"]["losses"][-1]
    _state["phase"] = "report"
    print(json.dumps(kernels_line(k1, k2, pa, k1b, k2b, tra)), flush=True)
    print(f"total_s={time.perf_counter() - t_start:.3f}", flush=True)
    print(smi_line(), flush=True)
    signal.alarm(0)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
