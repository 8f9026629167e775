"""Ring-exchanged relational SpMM: kernel K13.

The counterpart of the JAX package's ``parallel/ring_pallas.py``
(``_ring_kernel``, reached through ``_rel_spmm_ring`` in
``edge_partition="ring_pallas"`` mode). The entity states are cut into m
row shards of `rows` rows; rank i owns shard i and exactly the edges whose
destination row it owns (``ring_regroup_data``), so its degrees are local.
In m steps every shard visits every rank once: at step k rank i holds
shard (i + k) % m and

1. starts the copy of that shard to its left neighbour's next slot, on a
   copy stream, after the event that marks the shard resident;
2. aggregates the messages of its edges whose source lies in the visiting
   shard into its own rows (one kernel launch on the rank's stream);
3. makes its step k + 1 wait on the event of the copy it receives.

Slots are never reused (each rank has m of them), so the only order needed
is receive-before-read, which the event wait gives; no block waits on
another. The ranks' outputs are then gathered onto the controller's device
(the JAX package's ``all_gather``). For one graph, with norm = 1 / deg,

    out[v] = norm[v]^2 * sum_{e : dst_e = v} h[src_e] . W[rel_e]

where W[r] is diagonal (s = 1) or block-diagonal with s x s blocks (s <= 8;
the weights [R, n_bases * s * s] unpacked, as ``rel_message`` takes them).
Every function takes B graphs at once: h [B, m * rows, d] and edges
[B, E], E = m * cap; rank i owns the same row range and edge slice in each.

On CUDA tensors ``ring_spmm_fwd`` launches the kernel in
``csrc/ring_spmm.cu`` (m launches a rank a call) or raises; on CPU tensors
it runs ``ring_spmm_fwd_plain``, the same ring in torch ops, which is also
the "ring" mode's SpMM for any block shape. ``RingSpMM`` differentiates
K13: its backward is autograd through that plain ring, as the JAX
package's is XLA ops (dmsg at the destinations, dw summed over the ranks,
dh's per-edge contributions sent back to their owners: the
reduce-scatter).
"""

from __future__ import annotations

import torch

from temp_tpu_torch import _build
from temp_tpu_torch.ops.spmm import build_csr

_MAX_D = 256  # the kernel keeps d / 32 <= 8 columns per lane in registers
_MAX_S = 8    # block width of block-diagonal relation weights


def _blocks(d_in: int, d_out: int, w):
    """(n_bases, si, so) of relation weights [R, n_bases * si * so] that
    take d_in columns to d_out."""
    wide = w.shape[1]
    nb = d_in * d_out // wide if wide else 0
    if nb < 1 or nb * wide != d_in * d_out or d_in % nb or d_out % nb:
        raise ValueError(f"ring_spmm: weight {tuple(w.shape)} is not "
                         f"[R, n_bases * si * so] for d_in = {d_in}, "
                         f"d_out = {d_out}")
    return nb, d_in // nb, d_out // nb


def _transform(hs, wr, si: int, so: int):
    """Per-edge relation transform: h rows [n, nb * si] by their weights
    [n, nb * si * so]."""
    if si == so == 1:
        return hs * wr
    nb = hs.shape[1] // si
    return torch.einsum("ebi,ebio->ebo", hs.reshape(-1, nb, si),
                        wr.reshape(-1, nb, si, so)).reshape(-1, nb * so)


def _rank_edges(src, dst, rel, emask, r: int, m: int, rows: int, dev):
    """Rank r's edge slice on its device: (src, local dst, rel, keep), each
    [B, cap]; padding dsts are clipped into the shard."""
    cap = src.shape[1] // m
    sl = slice(r * cap, (r + 1) * cap)
    dstl = (dst[:, sl].long() - r * rows).clamp(0, rows - 1)
    return (src[:, sl].to(dev).long(), dstl.to(dev), rel[:, sl].to(dev).long(),
            emask[:, sl].to(dev).bool())


def _check(h, w, src, dst, rel, emask, m: int, rows: int, devices,
           d_out: int):
    if h.dim() != 3 or h.shape[1] != m * rows:
        raise ValueError(f"ring_spmm: h {tuple(h.shape)} must be "
                         f"[B, {m} * {rows}, d]")
    B, E = src.shape
    if (h.shape[0] != B or E % m or dst.shape != src.shape
            or rel.shape != src.shape or emask.shape != src.shape):
        raise ValueError(f"ring_spmm: edges {tuple(src.shape)} must be "
                         f"[B, m * cap] for h {tuple(h.shape)}, m = {m}")
    if len(devices) != m:
        raise ValueError(f"ring_spmm: {len(devices)} devices for {m} ranks")
    if any(torch.device(d).type != h.device.type for d in devices):
        raise ValueError(f"ring_spmm: ranks on {devices}, h on {h.device}")
    return _blocks(h.shape[-1], d_out, w)


def ring_spmm_fwd_plain(h, w, src, dst, rel, emask, m: int, rows: int,
                        devices, d_out: int | None = None):
    """Plain PyTorch version of K13, and the "ring" mode's SpMM: the same
    ring, each rank's step a gather, transform and ``index_add`` of the
    edges whose source lies in the visiting shard, the shards' copies
    tensor copies. Any block shape (weights [R, n_bases * si * so], d_out
    columns out, by default h's width); differentiable by autograd in h and
    w. Returns (out [B, m * rows, d_out], norm^2 [B, m * rows]) on h's
    device."""
    B, _, d_in = h.shape
    d_out = d_in if d_out is None else d_out
    _, si, so = _check(h, w, src, dst, rel, emask, m, rows, devices, d_out)
    ranks = []
    for r, dev in enumerate(devices):
        s_l, d_l, r_l, keep = _rank_edges(src, dst, rel, emask, r, m, rows,
                                          dev)
        seg = (torch.arange(B, device=dev)[:, None] * rows + d_l)
        deg = torch.zeros(B * rows, device=dev).index_add_(
            0, seg.reshape(-1), keep.reshape(-1).to(torch.float32))
        norm = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                           torch.zeros_like(deg))
        ranks.append(dict(src=s_l, seg=seg.reshape(-1), keep=keep,
                          b=torch.arange(B, device=dev)[:, None],
                          n2=norm * norm, w_e=w.to(dev)[r_l.reshape(-1)],
                          raw=torch.zeros(B * rows, d_out, device=dev)))
    visit = [h[:, r * rows:(r + 1) * rows].to(dev)
             for r, dev in enumerate(devices)]
    for k in range(m):
        for r, rk in enumerate(ranks):
            # every edge slot gathers from the visiting shard; the messages
            # of those whose source lies elsewhere (or that are masked)
            # are scaled to 0, so no step waits on the host for a count
            owner = (r + k) % m
            sel = rk["keep"] & (rk["src"] // rows == owner)
            local = torch.where(sel, rk["src"] - owner * rows, 0)
            hs = visit[r][rk["b"], local].reshape(-1, d_in)
            msg = _transform(hs, rk["w_e"], si, so) * sel.reshape(-1, 1)
            rk["raw"] = rk["raw"].index_add(0, rk["seg"], msg)
        if k < m - 1:  # rank r receives its right neighbour's shard
            visit = [visit[(r + 1) % m].to(dev)
                     for r, dev in enumerate(devices)]
    out = torch.cat([(rk["raw"] * rk["n2"][:, None]).reshape(B, rows, d_out)
                     .to(h.device) for rk in ranks], dim=1)
    n2 = torch.cat([rk["n2"].reshape(B, rows).to(h.device) for rk in ranks],
                   dim=1)
    return out, n2


def _ring_fwd_cuda(h, w, src, dst, rel, emask, m: int, rows: int, devices,
                   s: int):
    B, _, d = h.shape
    if h.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"ring_spmm_fwd: kernel takes float32 h and weight, "
                        f"got {h.dtype} and {w.dtype}")
    if d > _MAX_D:
        raise ValueError(f"ring_spmm_fwd: d = {d} > {_MAX_D}")
    lib = _build.lib()
    ctrl = torch.cuda.current_stream(h.device)
    h, w = h.contiguous(), w.contiguous()
    # each rank's compute and copy streams (from PyTorch's stream pool)
    comp = [torch.cuda.Stream(device=dev) for dev in devices]
    copy = [torch.cuda.Stream(device=dev) for dev in devices]
    slots, csr, outs, n2s, resident = [], [], [], [], []
    for r, dev in enumerate(devices):
        comp[r].wait_stream(ctrl)
        comp[r].wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(comp[r]):
            s_l, d_l, r_l, keep = _rank_edges(src, dst, rel, emask, r, m,
                                              rows, dev)
            # one sort a call: the rank's edges by (graph, source owner,
            # local dst), so step k reads the CSR of owner (r + k) % m
            key = ((torch.arange(B, device=dev)[:, None] * m
                    + s_l // rows) * rows + d_l)
            rowptr, s_src, s_rel = build_csr(
                key.reshape(-1), B * m * rows,
                s_l.reshape(-1).to(torch.int32),
                r_l.reshape(-1).to(torch.int32), keep=keep.reshape(-1))
            csr.append((rowptr, s_src, s_rel, w.to(dev)))
            slot = torch.empty(m, B, rows, d, device=dev)
            slot[0].copy_(h[:, r * rows:(r + 1) * rows])
            slots.append(slot)
            outs.append(torch.empty(B, rows, d, device=dev))
            n2s.append(torch.empty(B, rows, device=dev))
            resident.append({0: comp[r].record_event()})
    for k in range(m):
        for r in range(m):
            if k < m - 1:  # 1. send the visiting shard to the left
                left = (r - 1) % m
                copy[r].wait_event(resident[r][k])
                with torch.cuda.stream(copy[r]):
                    slots[left][k + 1].copy_(slots[r][k], non_blocking=True)
                    resident[left][k + 1] = copy[r].record_event()
            if k > 0:  # 3. (of step k - 1) the shard has arrived
                comp[r].wait_event(resident[r][k])
            rowptr, s_src, s_rel, w_r = csr[r]
            p = lambda t: t.data_ptr()  # noqa: E731
            with torch.cuda.device(devices[r]):  # the stream's own card
                err = lib.ring_spmm_step_launch(  # 2. aggregate
                    p(rowptr), p(s_src), p(s_rel), p(slots[r][k]), p(w_r),
                    p(outs[r]), p(n2s[r]), B, m, rows, d, s, (r + k) % m,
                    int(k == 0), int(k == m - 1), comp[r].cuda_stream)
            _build.check(err, "ring_spmm_fwd")
            ring_spmm_fwd.launches += 1
    for r, dev in enumerate(devices):
        # the slots a rank sends from are read until its copies end; the
        # gather below runs on each device's current stream
        comp[r].wait_stream(copy[r])
        torch.cuda.current_stream(dev).wait_stream(comp[r])
        ctrl.wait_stream(comp[r])
    out = torch.cat([o.to(h.device) for o in outs], dim=1)
    n2 = torch.cat([n.to(h.device) for n in n2s], dim=1)
    return out, n2


def ring_spmm_fwd(h, w, src, dst, rel, emask, m: int, rows: int, devices):
    """K13: (out [B, m * rows, d], norm^2 [B, m * rows]) on h's device. The
    kernel when h lies on a CUDA device (ranks on `devices`, all CUDA), the
    plain version when it lies on the CPU."""
    _, s, _ = _check(h, w, src, dst, rel, emask, m, rows, devices,
                     h.shape[-1])
    if h.device.type == "cpu":
        return ring_spmm_fwd_plain(h, w, src, dst, rel, emask, m, rows,
                                   devices)
    if h.device.type != "cuda":
        raise ValueError(f"ring_spmm_fwd: no kernel for device {h.device}")
    if s > _MAX_S:
        raise ValueError(f"ring_spmm_fwd: blocks of {s} > {_MAX_S}")
    return _ring_fwd_cuda(h, w, src, dst, rel, emask, m, rows, devices, s)


ring_spmm_fwd.launches = 0


class RingSpMM(torch.autograd.Function):
    """K13 differentiated in h and w: the forward is ``ring_spmm_fwd``, the
    backward autograd through the plain ring (recomputed), which is the
    JAX package's transpose in torch ops: dmsg at the destinations, dw
    summed over the ranks, dh's per-edge contributions carried back round
    the ring to their owners (the reduce-scatter)."""

    @staticmethod
    def forward(ctx, h, w, src, dst, rel, emask, m, rows, devices):
        out, _ = ring_spmm_fwd(h, w, src, dst, rel, emask, m, rows, devices)
        ctx.save_for_backward(h, w, src, dst, rel, emask)
        ctx.ring = (m, rows, devices)
        return out

    @staticmethod
    def backward(ctx, g):
        h, w, src, dst, rel, emask = ctx.saved_tensors
        with torch.enable_grad():
            h, w = h.detach().requires_grad_(), w.detach().requires_grad_()
            out, _ = ring_spmm_fwd_plain(h, w, src, dst, rel, emask,
                                         *ctx.ring)
            dh, dw = torch.autograd.grad(out, (h, w), g)
        return dh, dw, None, None, None, None, None, None, None


def ring_spmm(h, w, src, dst, rel, emask, m: int, rows: int, devices,
              kernels: bool = True):
    """K13 as a differentiable function of h [B, m * rows, d] and w
    (``kernels=False``: its plain version, on any device)."""
    if not kernels:
        return ring_spmm_fwd_plain(h, w, src, dst, rel, emask, m, rows,
                                   tuple(devices))[0]
    return RingSpMM.apply(h.contiguous(), w.contiguous(), src, dst, rel,
                          emask, m, rows, tuple(devices))
