#!/usr/bin/env python3
"""The final step's kernels (K3, K4, K6+K7, K11) and K2f of several
checkouts, in turns, on one GPU.

    python3 tools/final_ab.py ROOT [ROOT ...] [--order 0110] [--bf16]
                              [--out FILE]

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

With --bf16 each run measures the bfloat16 modes (the card's default)
instead:

- K3 bfloat16 on the first training batch, its history in bfloat16: its
  two layer launches (a call of ``fused_final_fwd_launchers``' first
  function: the launches and the rounding of layer 2's input between
  them) and its score launch apart, a call's milliseconds and the device
  time a call of ``final_layer``, the rounding copy and ``final_scores``;
- K6+K7 bfloat16 on the flagship's first training batch: each layer's
  launch and both, a call and the device time of ``bi_layer``;
- K11 bfloat16 on the first eval batch: its two layer launches and its
  rank launch apart;
- GRRGCN's and the flagship's default training step (compute_dtype
  "auto"): ``window_ab``'s steps, with the layer kernels' device time a
  step by name;
- hashes: ``window_ab``'s of every kernel's outputs in both dtypes, and
  ("apart") of the bfloat16 kernels downstream of the layers on seeded
  inputs of their own (K3's score launch, K4 and K5 on GRRGCN's batch,
  K8, K4 and K9+K10 on the flagship's, K11's rank launch), so that they do
  not inherit a layer kernel's bits. Equal hashes in two checkouts say
  those kernels compute the same bits. A change of the layer launches'
  summation order moves "k3_bf16", "k4_bf16", "k5_bf16", "k6k7_bf16",
  "k8_bf16", "k4_bi_bf16", "k9k10_bf16" and "k11_bf16" of
  ``window_ab``'s by design (they read its output); every hash "apart"
  and every other one stays.

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
from window_ab import (  # noqa: E402
    _bi_inputs, _cases, _default_step, _device_ms, _final_inputs, _hash,
    _hashes,
)

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


_K3_BF16 = ("final_layer", "copy", "final_scores", "final_loss_reduce")


def _hashes_apart(cs, ctx, fctx, dev) -> dict:
    """Hashes of the bfloat16 kernels downstream of the layer launches, on
    seeded inputs in place of the layers' outputs (the module docstring
    says which)."""
    import torch

    from temp_tpu_torch.ops import fused_final as ff
    from temp_tpu_torch.ops import fused_final_bi as fb

    BF = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(13)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev) * 0.5

    out = {}
    h0, h1, h2, gr, wrel, loop1, loop2, g1, g2, rtab = _final_inputs(
        cs, ctx, BF)
    B, N, d = h1.shape
    csr = ff.final_csr(gr, N, max(wrel.shape[0], rtab.shape[0]))
    loss, saved = fb.bi_loss_fwd(rand(B, N, d), rtab, gr, csr, hot=BF)
    out["k3_scores_bf16"] = _hash(loss, [saved[k] for k in (
        "qhat", "lse", "scpos")])
    got4 = ff.fused_final_bwd_loss(saved, rtab, gr, cs.final_batch(ctx)[
        "tv"], hot=BF)
    out["k4_bf16"] = _hash(got4)
    l2 = ff.fused_final_bwd_layer(rand(B, N, d), h2, gr, gr.m2, wrel, d,
                                  loop2, g2, rand(B, N, d), csr=csr, hot=BF)
    l1 = ff.fused_final_bwd_layer(h0, h1, gr, gr.m1, wrel, 0, loop1, g1,
                                  rand(B, N, d), csr=csr, hot=BF)
    out["k5_bf16"] = _hash(l2, l1)

    fb_, a1, a2, kw2 = _bi_inputs(cs, fctx, BF)
    bg, rtab = fb_["bg"], fb_["rtab"]
    B, N, d = fb_["h0x"].shape
    loss, saved = fb.bi_loss_fwd(rand(B, N, d), rtab, bg.gr, fb_["csr"],
                                 hot=BF)
    out["k8_bf16"] = _hash(loss, [saved[k] for k in ("qhat", "lse",
                                                      "scpos")])
    out["k4_bi_bf16"] = _hash(ff.fused_final_bwd_loss(saved, rtab, bg.gr,
                                                      fb_["tv"], hot=BF))
    l2 = fb.bi_layer_bwd(rand(B, N, d), *a2, rand(B, N, d), **kw2, hot=BF)
    l1 = fb.bi_layer_bwd(*a1, rand(B, N, d), csr=fb_["csr"], hot=BF)
    out["k9k10_bf16"] = _hash(l2, l1)

    eb = cs.eval_batch(ctx)
    rtab, q = eb["args"][-1], eb["args"][4]
    with torch.no_grad():
        out["k11_ranks"] = _hash(ff.table_ranks(rand(*eb["args"][1].shape),
                                                rtab, q))
    return out


def _parts(cs, dev, fns: dict, names) -> dict:
    """For each of `fns` (tag -> function of no arguments): a call's
    milliseconds and the device time and launches a call of each kernel
    name."""
    out = {}
    for tag, fn in fns.items():
        r = {"call_ms": cs.time_ms(fn, dev, reps=10)}
        for n, (ms, k) in _device_ms(fn, list(names)).items():
            r[f"{n}_ms"], r[f"{n}_launches"] = ms, k
        out[tag] = r
    return out


def _measure_bf16(root: str) -> dict:
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
    BF = torch.bfloat16
    res = {"root": root, "smi": cs.smi_line(), "mode": "bf16"}
    res.update(cs.phase_build())
    ctx = cs.phase_setup("cuda")
    fctx = cs.phase_setup_flagship(ctx)
    dev = ctx["device"]
    layers, scores = ff.fused_final_fwd_launchers(
        *_final_inputs(cs, ctx, BF), hot=BF)
    res["k3_bf16"] = _parts(cs, dev, {"layers": layers, "scores": scores},
                            _K3_BF16)
    fb_, a1, a2, kw2 = _bi_inputs(cs, fctx, BF)
    sel = fb_["h0x"] if fb_["bg"].noact else None
    with torch.no_grad():
        x2 = fbi.bi_layer_fwd(*a1, csr=fb_["csr"], hot=BF)

        def layer1():
            return fbi.bi_layer_fwd(*a1, csr=fb_["csr"], hot=BF)

        def layer2():
            return fbi.bi_layer_fwd(x2, *a2, **kw2, sel=sel, hot=BF)

        res["k6k7_bf16"] = _parts(
            cs, dev, {"layer1": layer1, "layer2": layer2,
                      "both": lambda: (layer1(), layer2())},
            ["bi_layer", "copy"])
        h0, hist1, hist2, *rest = cs.eval_batch(ctx)["args"]
        layers, rank, _ = ff.fused_eval_ranks_launchers(
            h0, hist1.to(BF).contiguous(), hist2.to(BF).contiguous(), *rest,
            hot=BF)
        res["k11_bf16"] = _parts(cs, dev, {"layers": layers, "ranks": rank},
                                 ["final_layer", "copy", "final_ranks"])
    for tag, c in (("grrgcn", ctx), ("flagship", fctx)):
        res[f"default_step_{tag}"] = _default_step(
            c, names=("final_layer", "bi_layer", "final_scores"))
    res["hashes"] = _hashes(cs, ctx, fctx, _cases(cs, fw, ctx, fctx), dev)
    res["hashes_apart"] = _hashes_apart(cs, ctx, fctx, dev)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default=None,
                    help="the ROOTs' indices in the order to run them")
    ap.add_argument("--out", default=None)
    ap.add_argument("--bf16", action="store_true",
                    help="measure the bfloat16 modes (see above)")
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
