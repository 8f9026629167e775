"""The whole batch's history windows as one batched call: kernel K12.

The JAX package's ``fused_window_scan_mb`` runs the K2 forward of all B
windows of a batch as one Pallas program (``_fwd_kernel_mb``) instead of B
programs under ``vmap``, and reuses the per-element K2 backward. On this
card K2f already runs all B windows in each of its launches (one a layer
and step over [B, L1, A, d], ``ops/fused_window.py``), so K12's forward is
K2f's batched launches, counted on ``fused_window_mb_fwd``; its backward is
K2b (``fused_window_bwd``), as the JAX module's is the per-element one. The
JAX module cuts the batch into sub-batches that fit the TPU's VMEM
(``pick_sub_batch``); the port does not.

On a CPU tensor ``fused_window_mb_fwd`` runs its plain version, the
per-element plain K2 over the batch; on a CUDA tensor it launches K2f's
kernels or raises. ``hot=torch.bfloat16`` is the JAX kernel's bfloat16
instantiation, which the JAX module builds to give the values of B
independent per-element windows: K2f's bfloat16 launches (counted here),
its plain version B calls of K2's bfloat16 plain version, its backward
K2b's bfloat16 mode.
"""

from __future__ import annotations

import torch

from temp_tpu_torch.ops.fused_window import (
    _device, apply_window, fused_window_fwd_plain, window_args,
    window_fwd_launches,
)


def fused_window_mb_fwd_plain(h0x, src, dst, rel, em, gidx, live, dt, wrel,
                              loop1, loop2, g1, g2, lam: float,
                              conv1_in: bool, m1=None, m2=None,
                              act2: bool = False, n_buf: int = 2, hot=None):
    """Plain version of K12: ``fused_window_fwd_plain`` one element at a
    time (in the mode `hot`), stacked. Arguments and result as in
    ``fused_window_fwd``; differentiable by autograd."""
    per = [fused_window_fwd_plain(
        h0x[b:b + 1], src[b:b + 1], dst[b:b + 1], rel[b:b + 1],
        em[b:b + 1], gidx[b:b + 1], live[b:b + 1], dt[b:b + 1], wrel, loop1,
        loop2, g1, g2, lam, conv1_in, None if m1 is None else m1[b:b + 1],
        None if m2 is None else m2[b:b + 1], act2, n_buf, hot=hot)
        for b in range(h0x.shape[0])]
    return tuple(torch.cat(bufs) for bufs in zip(*per))


def fused_window_mb_fwd(h0x, src, dst, rel, em, gidx, live, dt, wrel, loop1,
                        loop2, g1, g2, lam: float, conv1_in: bool, m1=None,
                        m2=None, act2: bool = False, n_buf: int = 2,
                        hot=None):
    """K12 for B windows: arguments and result as in ``fused_window_fwd``,
    whose launches it makes, in the mode `hot` (None for float32, or
    torch.bfloat16)."""
    if n_buf not in (2, 3):
        raise ValueError(f"fused_window_mb_fwd: n_buf = {n_buf}, not 2 or 3")
    if _device("fused_window_mb_fwd", h0x) == "cpu":
        return fused_window_mb_fwd_plain(h0x, src, dst, rel, em, gidx, live,
                                         dt, wrel, loop1, loop2, g1, g2, lam,
                                         conv1_in, m1, m2, act2, n_buf, hot)
    return window_fwd_launches(fused_window_mb_fwd, h0x, src, dst, rel, em,
                               gidx, live, dt, wrel, loop1, loop2, g1, g2,
                               lam, conv1_in, m1, m2, act2, n_buf, hot)


fused_window_mb_fwd.launches = 0


def fused_window_scan_mb(enc_params, cfg, lc2, h0_xs, src, dst, rel, emask,
                         prev_step, prev_row, dt, live, masks, train: bool,
                         n_buf: int, direction=None, conv1_in: bool = False,
                         kernels: bool = True, drop_rates=None):
    """The JAX package's ``fused_window_scan_mb``: B history windows
    through K12, with K2b as its backward (``kernels=False``: its plain
    version, differentiated by autograd). Every operand has a leading batch
    dimension, as in ``window_args``; `masks` (the training self-loop
    dropout masks over keep, each [B, L1, A, d], or None) takes the place
    of the JAX function's per-element keys; lc2 gives layer 2's activation.
    Runs in ``cfg.hot_dtype``. Returns (buf1, buf2[, buf3]), each
    [B, L1, A, d] in the store dtype.

    `drop_rates` (per-step DropEdge rates) is refused: the JAX function
    takes no rates and its caller drops them without a word."""
    if drop_rates is not None:
        raise NotImplementedError(
            "fused_window_scan_mb: per-step drop rates (DropEdge) are not "
            "applied by the batched window; the JAX package ignores them")
    if conv1_in and train:
        raise ValueError("fused_window_scan_mb: conv1_in (precomputed "
                         "layer-1 convs) is an eval-only mode")
    a = window_args(enc_params, cfg, h0_xs, src, dst, rel, emask, prev_step,
                    prev_row, dt, live, masks if train else None, direction,
                    lc2.activation)
    hot = cfg.hot_dtype
    if not kernels:
        return fused_window_mb_fwd_plain(conv1_in=bool(conv1_in),
                                         n_buf=n_buf, hot=hot, **a)
    return apply_window(fused_window_mb_fwd, a, conv1_in, n_buf, hot)
