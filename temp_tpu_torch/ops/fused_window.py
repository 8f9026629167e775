"""Whole-window GRRGCN history recurrence: kernels K2f and K2b.

``fused_window_fwd`` computes what the JAX package's
``fused_window_scan(..., n_buf)`` returns, for a batch of B windows at
once: for every step k the prev-state gather with exp(-λ·dt) decay, layer 1
(the given conv input, or SpMM plus self-loop), a GRU, layer 2 over layer
1's output (with a ReLU on its conv output when ``act2``, as the Bi models
have), a GRU, and both outputs into [B, L1, A, d] buffers; with ``n_buf=3``
also layer 2's conv output after the ReLU (the "local" stream that the
flagship's impute blend reads) into a third. In training the self-loop term
of each layer is multiplied by a streamed dropout mask (m1, m2
[B, L1, A, d], already scaled by 1/keep). The backward-direction window of
the Bi models is the same computation on the ``gru_bwd`` weights
(``window_args(direction="bwd")``) and the backward history tables.

``fused_window_bwd`` gives the 12 cotangents of the JAX package's
``_bwd_kernel`` (inputs, relation weights, both self-loop weights, the GRU
weights and biases of both layers) from the cotangents of the two or three
buffers, recomputing every step from the saved buffers and masks in reverse
order. ``FusedWindow`` is the autograd function made of the two.

On a CPU tensor each wrapper runs its plain version (the backward's is
autograd through ``fused_window_fwd_plain``); on a CUDA tensor it launches
the hand-written kernels in ``csrc/fused_window.cu`` or raises: forward two
launches a step (layer 1, then layer 2), backward five a step and two more,
the products of both on the tensor cores in 3xTF32 at f32 accuracy, the
forward's and the backward's recompute the same sums in the same order.

``hot=torch.bfloat16`` is the JAX kernels' bfloat16 instantiation
(``dtype_str="bfloat16"``, store dtype bfloat16): every product takes
operands rounded to bfloat16 with float32 sums, the SpMM rounds the
gathered source rows, the gathered relation weights and each message, the
buffers come back in bfloat16, and the backward rounds the cotangents at
the JAX kernel's cast points (``hot_mm``, ``hot_round`` and ``round_store``
below state which). On the card it launches the kernels' bfloat16 mode
(``csrc/fused_window_bf16.cu``, native bfloat16 products), the same
launches: the wrapper rounds each weight once a call and layer 1's rows
once (``kernel_operands``; JAX's ``astype(bfloat16)``, where the kernels
read them only rounded), layer 2 reads layer 1's bfloat16 buffer as it is.
"""

from __future__ import annotations

import torch

from temp_tpu_torch import _build
from temp_tpu_torch.ops.gru import GRU_KEY, hot_round
from temp_tpu_torch.ops.spmm import build_csr, spmm_fwd_plain

_MAX_D = 256
# K2b's GRU tile: 2d threads (d / 16 warps of 16 columns), at d = 128 in
# float32 32-row tiles of 103,680 bytes of shared memory, two blocks an SM,
# in bfloat16 16-row tiles of 68,096 bytes, three an SM
_MAX_D_BWD = 128
# K2b's weight launch cuts each step's B*A rows into this many ranges, each
# summed by its own blocks into its own copy of the weight cotangents. At the
# main path's 5,120 rows a step and d = 128: 20 ring slots of 32 rows a
# range, 8 x 56 tiles of 64 x 64 = 448 blocks, within one wave of the
# H100's 132 SMs at four 128-thread blocks an SM
_WGRAD_SPLIT = 8
# the weight cotangents as the weight launch lays them out in one buffer
_WGRAD_LAYOUT = ("dwih2", "dbih2", "dwhh2", "dbhh2", "dloop2",
                 "dwih1", "dbih1", "dwhh1", "dbhh1", "dloop1")


# -- the JAX kernels' bfloat16 cast points, as differentiable functions -----
#
# The JAX kernels write their backward by hand, and round the cotangents at
# fixed points; these three functions carry those points in their
# backward, so that autograd through a plain forward built of them gives
# the kernels' backward (K2b's here, K5's in ops/fused_final.py):
# - hot_mm(a, b): the product of a and b rounded (a [..., K], b [K, N]),
#   float32 sums; its cotangents are products of the rounded cotangent
#   (``_dot_c1(d.astype(bf16), w.astype(bf16))`` and ``_dot_c0(x.astype(
#   bf16), d.astype(bf16))`` in the JAX kernels);
# - hot_round(x) (ops/gru.py): x rounded, and its cotangent rounded (a
#   one-hot gather or scatter of rounded values: the SpMM's source rows,
#   relation weights and messages);
# - round_store(x): x rounded (written to a bfloat16 buffer), its
#   cotangent left in float32 (the kernels' float32 cotangent scratch).


class _HotMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, dtype):
        ar, br = hot_round(a, dtype), hot_round(b, dtype)
        ctx.save_for_backward(ar, br)
        ctx.dtype = dtype
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = hot_round(g, ctx.dtype)
        gb = ar.reshape(-1, ar.shape[-1]).t() @ gr.reshape(-1, gr.shape[-1])
        return gr @ br.t(), gb, None


def hot_mm(a, b, dtype):
    """a @ b (b a 2-d weight) with both operands rounded to `dtype` and
    float32 sums; the plain a @ b when dtype is None."""
    return a @ b if dtype is None else _HotMM.apply(a, b, dtype)


def round_store(x, dtype):
    """x rounded to `dtype` (in x's dtype), its cotangent passed through
    unrounded. The sum x + (rounded - x) is exactly the rounded value: the
    difference of two floats within a factor 2 of each other is exact."""
    if dtype is None:
        return x
    xd = x.detach()
    return x + (xd.to(dtype).to(x.dtype) - xd)


def spmm_hot_plain(h, src, dst, rel, em, weight, dtype):
    """The JAX kernels' bfloat16 SpMM: h [M, d], weight [R, d], flat edges
    src/dst/rel [E] and their float mask em [E] -> [M, d]. Per edge the
    message (rounded h[src] * rounded w[rel]) * (norm[dst] * em), rounded,
    summed per destination in float32, then times norm (norm = 1 / deg over
    the masked edges, 0 without any)."""
    n = h.shape[0]
    src, dst, rel = src.long(), dst.long(), rel.long()
    em = em.to(torch.float32)
    deg = torch.zeros(n, device=h.device).index_add_(0, dst, em)
    norm = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                       torch.zeros_like(deg))
    escale = (norm[dst] * em)[:, None]
    msg = hot_round(hot_round(h[src], dtype) * hot_round(weight[rel], dtype)
                    * escale, dtype)
    agg = torch.zeros(n, h.shape[1], device=h.device).index_add(0, dst, msg)
    return agg * norm[:, None]


def _gru_t(x, h, g, hot=None):
    """torch-semantics GRU cell on pre-transposed weights (wih_t [d, 3d]);
    its two products in `hot` (``hot_mm``)."""
    d = h.shape[-1]
    gi = hot_mm(x, g["wih_t"], hot) + g["bih"]
    gh = hot_mm(h, g["whh_t"], hot) + g["bhh"]
    r = torch.sigmoid(gi[..., :d] + gh[..., :d])
    z = torch.sigmoid(gi[..., d:2 * d] + gh[..., d:2 * d])
    n = torch.tanh(gi[..., 2 * d:] + r * gh[..., 2 * d:])
    return (1.0 - z) * n + z * h


def fused_window_fwd_plain(h0x, src, dst, rel, em, gidx, live, dt, wrel,
                           loop1, loop2, g1, g2, lam: float, conv1_in: bool,
                           m1=None, m2=None, act2: bool = False,
                           n_buf: int = 2, relu_mask=None, hot=None):
    """Plain PyTorch version of K2f; arguments as in ``fused_window_fwd``.
    Differentiable by autograd (that is K2b's plain version, also in
    bfloat16: see ``hot_mm``). relu_mask [B, L1, A, d] (1 where the ReLU
    passes), when given, stands for the ReLU's pattern: the pattern of
    another computation of the same window (the kernels', whose outputs
    differ from these by rounding), so that the two differentiate through
    the same side of the ReLU where layer 2's conv output lies within
    rounding of 0."""
    B, L1, A, d = h0x.shape
    buf1 = torch.zeros_like(h0x)
    buf2 = torch.zeros_like(h0x)
    buf3 = torch.zeros_like(h0x) if n_buf == 3 else None
    bidx = torch.arange(B, device=h0x.device)[:, None]
    offs = (torch.arange(B, device=h0x.device) * A)[:, None]
    # live is 0 or 1, so scaling by live * decay equals (gather * live) * decay
    scale = (live * torch.exp(-lam * dt))[..., None]
    w1, w2 = wrel[:, :d], wrel[:, d:]

    def conv(x, k, w, loop, m):
        # batch elements as one block-diagonal graph of B*A rows
        s = (src[:, k] + offs).reshape(-1)
        t = (dst[:, k] + offs).reshape(-1)
        edges = (x.reshape(B * A, d), s, t, rel[:, k].reshape(-1),
                 em[:, k].reshape(-1), w)
        agg = (spmm_fwd_plain(*edges) if hot is None
               else spmm_hot_plain(*edges, hot))
        lp = hot_mm(x, loop, hot)
        if m is not None:
            lp = lp * m[:, k]
        return agg.reshape(B, A, d) + lp

    for k in range(L1):
        rows = gidx[:, k].long()
        h1 = buf1.reshape(B, L1 * A, d)[bidx, rows] * scale[:, k]
        h2 = buf2.reshape(B, L1 * A, d)[bidx, rows] * scale[:, k]
        c1 = h0x[:, k] if conv1_in else conv(h0x[:, k], k, w1, loop1, m1)
        out1 = _gru_t(c1, h1, g1, hot)
        buf1[:, k] = round_store(out1, hot)
        c2 = conv(out1, k, w2, loop2, m2)
        if act2:
            r2 = torch.relu(c2)
            if relu_mask is not None:
                # the ReLU's value, its derivative from the given pattern
                m = relu_mask[:, k]
                r2 = c2 * m + (r2 - c2 * m).detach()
            c2 = r2
        if buf3 is not None:
            buf3[:, k] = round_store(c2, hot)
        buf2[:, k] = round_store(_gru_t(c2, h2, g2, hot), hot)
    bufs = (buf1, buf2) if buf3 is None else (buf1, buf2, buf3)
    # the buffers in the store dtype: their bfloat16 cotangents come back
    # as float32, as the JAX kernel's gs.astype(float32)
    return bufs if hot is None else tuple(b.to(hot) for b in bufs)


def _check_cuda(name, tensors: dict, B, L1, A, E, d, hot=None):
    """Device, dtype, shape, contiguity and alignment of the kernels'
    operands: the buffers and their cotangents in the store dtype (`hot`,
    or float32), every other float operand in float32."""
    dev = tensors["h0x"].device
    act = (B, L1, A, d)
    shapes = {"h0x": act, "src": (B, L1, E), "dst": (B, L1, E),
              "rel": (B, L1, E), "em": (B, L1, E), "gidx": (B, L1, A),
              "live": (B, L1, A), "dt": (B, L1, A), "loop1": (d, d),
              "loop2": (d, d), "m1": act, "m2": act, "buf1": act,
              "buf2": act, "buf3": act, "gb1": act, "gb2": act, "gb3": act}
    ints = ("src", "dst", "rel", "gidx")
    stored = ("buf1", "buf2", "buf3", "gb1", "gb2", "gb3")
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {key} on {t.device}, h0x on {dev}")
        want = (torch.int32 if key in ints else
                hot if hot is not None and key in stored else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, the kernel takes "
                            f"{want}")
        if key in shapes and tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} is not 16-byte aligned (the "
                             f"kernels copy its rows 16 bytes at a time)")
    if tensors["wrel"].dim() != 2 or tensors["wrel"].shape[1] != 2 * d:
        raise ValueError(f"{name}: wrel must be [R, 2d]")
    for key in ("wih1", "whh1", "wih2", "whh2"):
        if tuple(tensors[key].shape) != (d, 3 * d):
            raise ValueError(f"{name}: {key} must be [d, 3d]")
    for key in ("bih1", "bhh1", "bih2", "bhh2"):
        if tuple(tensors[key].shape) != (3 * d,):
            raise ValueError(f"{name}: {key} must be [3d]")
    if d > _MAX_D or d % 16:
        raise ValueError(f"{name}: d = {d}; the kernel takes multiples of "
                         f"16 up to {_MAX_D}")


def operand(t, hot=None):
    """t as the kernels read it: contiguous, and in the bfloat16 mode (hot)
    rounded to it once, JAX's ``astype(bfloat16)`` of an operand that the
    JAX kernels read only so; in float32 (hot None) t itself when it is
    contiguous."""
    return (t if hot is None else t.to(hot)).contiguous()


def gru_operands(g, hot=None, bwd: bool = False) -> dict:
    """A GRU's weights (a dict of wih_t/whh_t [d, 3d]) as the kernels read
    them (``operand``): W_ih and W_hh transposed ("wih_t", "whh_t") and,
    with `bwd`, in torch's layout ("wih", "whh", [3d, d])."""
    w = {"wih_t": operand(g["wih_t"], hot), "whh_t": operand(g["whh_t"], hot)}
    if bwd:
        w.update(wih=operand(g["wih_t"].t(), hot),
                 whh=operand(g["whh_t"].t(), hot))
    return w


def layer_operands(loop, g, hot=None, bwd: bool = False) -> dict:
    """One layer's weights as the kernels read them: the self-loop ("loop")
    and its GRU's (``gru_operands``) and, with `bwd`, the self-loop
    transposed ("loop_t")."""
    w = {"loop": operand(loop, hot), **gru_operands(g, hot, bwd)}
    if bwd:
        w["loop_t"] = operand(loop.t(), hot)
    return w


def kernel_operands(h0x, loop1, loop2, g1, g2, hot=None,
                    bwd: bool = False) -> tuple:
    """What the window kernels read of the layer input and the weights:
    (x1, w1, w2), x1 layer 1's input rows and w1/w2 each layer's weights
    (``layer_operands``); all contiguous. In float32 (hot None) the tensors
    as given (x1 is h0x). In the bfloat16 mode each rounded to `hot` once:
    the JAX kernels read h0x, the self-loops and the GRU weights only as
    ``astype(bfloat16)``."""
    return (operand(h0x, hot), layer_operands(loop1, g1, hot, bwd),
            layer_operands(loop2, g2, hot, bwd))


def _lib_fn(lib, name: str, hot):
    """The launcher `name` of the float32 kernels, or of their bfloat16 mode
    (``name``_bf16) for hot=torch.bfloat16; raises for another dtype."""
    if hot is None:
        return getattr(lib, name)
    if hot != torch.bfloat16:
        raise TypeError(f"{name}: no kernel mode for {hot}")
    return getattr(lib, f"{name}_bf16")


def _named(h0x, src, dst, rel, em, gidx, live, dt, wrel, loop1, loop2, g1,
           g2, m1, m2, **more):
    return {"h0x": h0x, "src": src, "dst": dst, "rel": rel, "em": em,
            "gidx": gidx, "live": live, "dt": dt, "wrel": wrel,
            "loop1": loop1, "loop2": loop2, "m1": m1, "m2": m2,
            "wih1": g1["wih_t"], "whh1": g1["whh_t"], "bih1": g1["bih"],
            "bhh1": g1["bhh"], "wih2": g2["wih_t"], "whh2": g2["whh_t"],
            "bih2": g2["bih"], "bhh2": g2["bhh"], **more}


def _ptr(t):
    return None if t is None else t.data_ptr()


def _device(name, t) -> str:
    """t's device type, "cpu" or "cuda"; raises on another."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return t.device.type


def _step_csr(key_ids, em, B, L1, A, *edge_arrays):
    """CSR over (element, step, row) of [B, L1, E] step-local row ids; the
    masked edges (em = 0) in no row."""
    step = torch.arange(B * L1, device=key_ids.device, dtype=torch.int32)
    key = (step.reshape(B, L1, 1) * A + key_ids).reshape(-1)
    return build_csr(key, B * L1 * A, *(a.reshape(-1) for a in edge_arrays),
                     keep=em.reshape(-1) > 0)


def fused_window_fwd(h0x, src, dst, rel, em, gidx, live, dt, wrel, loop1,
                     loop2, g1, g2, lam: float, conv1_in: bool, m1=None,
                     m2=None, act2: bool = False, n_buf: int = 2, hot=None):
    """K2f for B windows.

    h0x [B, L1, A, d] input rows (the layer-1 conv outputs when
    ``conv1_in``); src/dst/rel [B, L1, E] step-local edge lists with em
    [B, L1, E] their float mask; gidx [B, L1, A] each row's previous state as
    a row of the element's flat [L1*A] buffer, live/dt [B, L1, A]; wrel
    [R, 2d] both layers' diagonal relation weights side by side; loop1/loop2
    [d, d]; g1/g2 GRU weights as dicts of wih_t/whh_t [d, 3d] and bih/bhh
    [3d]; m1/m2 [B, L1, A, d] the self-loop dropout masks over keep, or None
    (eval); act2 a ReLU on layer 2's conv output; n_buf 2 or 3; hot None
    (float32) or torch.bfloat16 (the bfloat16 mode). Returns (buf1,
    buf2[, buf3]), each [B, L1, A, d] in the store dtype (float32, or
    `hot`).
    """
    if n_buf not in (2, 3):
        raise ValueError(f"fused_window_fwd: n_buf = {n_buf}, not 2 or 3")
    if _device("fused_window_fwd", h0x) == "cpu":
        return fused_window_fwd_plain(h0x, src, dst, rel, em, gidx, live, dt,
                                      wrel, loop1, loop2, g1, g2, lam,
                                      conv1_in, m1, m2, act2, n_buf,
                                      hot=hot)
    return window_fwd_launches(fused_window_fwd, h0x, src, dst, rel, em,
                               gidx, live, dt, wrel, loop1, loop2, g1, g2,
                               lam, conv1_in, m1, m2, act2, n_buf, hot)


fused_window_fwd.launches = 0


def window_fwd_launches(owner, h0x, src, dst, rel, em, gidx, live, dt, wrel,
                        loop1, loop2, g1, g2, lam: float, conv1_in: bool, m1,
                        m2, act2: bool, n_buf: int, hot=None):
    """K2f's launches on a CUDA tensor (raises on another device), counted
    on ``owner.launches``: the wrapper that launches them (K2f's own, or
    K12's, which runs on them). With hot=torch.bfloat16 its bfloat16 mode:
    the buffers in bfloat16, layer 2 reading layer 1's buffer as its
    input."""
    name = owner.__name__
    if _device(name, h0x) != "cuda":
        raise ValueError(f"{name}: no kernel for device {h0x.device}")
    B, L1, A, d = h0x.shape
    E = src.shape[-1]
    _check_cuda(name, _named(h0x, src, dst, rel, em, gidx, live, dt, wrel,
                             loop1, loop2, g1, g2, m1, m2), B, L1, A, E, d)
    lib = _build.lib()
    launch = _lib_fn(lib, "window_layer_launch", hot)
    # CSR over (element, step, destination row) for both layers' SpMMs
    rowptr, s_src, s_rel, s_em = _step_csr(dst, em, B, L1, A, src, rel, em)

    store = torch.float32 if hot is None else hot
    x1, w1, w2 = kernel_operands(h0x, loop1, loop2, g1, g2, hot)
    buf1 = torch.zeros_like(h0x, dtype=store)
    buf2 = torch.zeros_like(h0x, dtype=store)
    buf3 = torch.zeros_like(h0x, dtype=store) if n_buf == 3 else None
    stream = torch.cuda.current_stream(h0x.device).cuda_stream
    p = _ptr
    # x_bf16: the layer's input is bfloat16 (both layers in that mode)
    x_bf16 = int(hot is not None)
    for k in range(L1):
        for x, given, col, w, m, relu, g, buf, loc in (
                (x1, conv1_in, 0, w1, m1, False, g1, buf1, None),
                (buf1, False, d, w2, m2, act2, g2, buf2, buf3)):
            err = launch(
                p(x), int(given), p(rowptr), p(s_src), p(s_rel), p(s_em),
                p(wrel), 2 * d, col, p(w["loop"]), p(m), int(relu),
                p(w["wih_t"]), p(w["whh_t"]), p(g["bih"]), p(g["bhh"]),
                p(gidx), p(live), p(dt), float(lam), p(buf), p(loc), B, L1,
                A, d, x_bf16, k, stream)
            _build.check(err, name)
            owner.launches += 1
    return (buf1, buf2) if buf3 is None else (buf1, buf2, buf3)


def fused_window_bwd_plain(h0x, src, dst, rel, em, gidx, live, dt, wrel,
                           loop1, loop2, g1, g2, lam: float, m1, m2, gb1,
                           gb2, gb3=None, act2: bool = False,
                           relu_mask=None, hot=None):
    """Plain version of K2b: autograd through ``fused_window_fwd_plain``
    (with `relu_mask` and `hot` as there; the cotangents gb* in the store
    dtype). Returns the 12 cotangents in the order of
    ``fused_window_bwd``."""
    leaves = [t.detach().requires_grad_(True) for t in (
        h0x, wrel, loop1, loop2, g1["wih_t"], g1["whh_t"], g2["wih_t"],
        g2["whh_t"], g1["bih"], g1["bhh"], g2["bih"], g2["bhh"])]
    (x, w, l1, l2, wih1, whh1, wih2, whh2, bih1, bhh1, bih2, bhh2) = leaves
    gbs = (gb1, gb2) if gb3 is None else (gb1, gb2, gb3)
    with torch.enable_grad():
        bufs = fused_window_fwd_plain(
            x, src, dst, rel, em, gidx, live, dt, w, l1, l2,
            {"wih_t": wih1, "whh_t": whh1, "bih": bih1, "bhh": bhh1},
            {"wih_t": wih2, "whh_t": whh2, "bih": bih2, "bhh": bhh2},
            lam, False, m1, m2, act2, len(gbs), relu_mask, hot)
        grads = torch.autograd.grad(bufs, leaves, gbs, allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves))


def fused_window_bwd(h0x, src, dst, rel, em, gidx, live, dt, wrel, loop1,
                     loop2, g1, g2, lam: float, m1, m2, buf1, buf2, gb1, gb2,
                     gb3=None, act2: bool = False, hot=None):
    """K2b: the cotangents of K2f's inputs from gb1/gb2 (and gb3 with
    n_buf=3), the cotangents of its outputs buf1/buf2 (saved by the
    forward; the third buffer need not be; buffers and cotangents in the
    store dtype). Arguments as in ``fused_window_fwd`` (conv1_in is not
    differentiable). Returns (dh0x, dwrel, dloop1, dloop2, dwih1, dwhh1,
    dwih2, dwhh2, dbih1, dbhh1, dbih2, dbhh2), the GRU weights' in the
    wih_t/whh_t layout, all float32."""
    if _device("fused_window_bwd", h0x) == "cpu":
        return fused_window_bwd_plain(h0x, src, dst, rel, em, gidx, live, dt,
                                      wrel, loop1, loop2, g1, g2, lam, m1,
                                      m2, gb1, gb2, gb3, act2, hot=hot)
    B, L1, A, d = h0x.shape
    E = src.shape[-1]
    R = wrel.shape[0]
    _check_cuda("fused_window_bwd", _named(
        h0x, src, dst, rel, em, gidx, live, dt, wrel, loop1, loop2, g1, g2,
        m1, m2, buf1=buf1, buf2=buf2, gb1=gb1, gb2=gb2, gb3=gb3), B, L1, A,
        E, d, hot)
    if d > _MAX_D_BWD:
        raise ValueError(f"fused_window_bwd: d = {d} > {_MAX_D_BWD}")
    lib = _build.lib()
    fn = {n: _lib_fn(lib, n, hot) for n in (
        "window_bwd_gru_launch", "window_bwd_input_launch",
        "window_wgrad_launch")}
    dev = h0x.device
    eid = torch.arange(B * L1 * E, device=dev, dtype=torch.int32)
    # masked edges are in no CSR: their per-edge relation cotangent in ewg
    # is neither written nor read
    d_ptr, d_src, d_rel, d_em = _step_csr(dst, em, B, L1, A, src, rel, em)
    s_ptr, s_dst, s_rel, s_em, s_eid = _step_csr(
        src, em, B, L1, A, dst, rel, em, eid.reshape(B, L1, E))
    r_ptr, r_eid = build_csr(rel.reshape(-1), R, eid,
                             keep=em.reshape(-1) > 0)

    # the buffers' cotangents, float32 accumulators of the steps' adds
    db1, db2 = gb1.to(torch.float32, copy=True), gb2.to(torch.float32,
                                                        copy=True)
    if gb3 is not None:
        gb3 = gb3.to(torch.float32)
    # layer 1's input and the weights as the kernels read them; layer 2's
    # input is layer 1's buffer in the store dtype
    x1, w1, w2 = kernel_operands(h0x, loop1, loop2, g1, g2, hot, bwd=True)
    dh0x = torch.empty_like(h0x)
    n2 = torch.empty(B * L1 * A, device=dev)
    ewg1 = torch.empty(B * L1 * E * d, device=dev)
    ewg2 = torch.empty(B * L1 * E * d, device=dev)
    rows = B * A
    f32 = dict(device=dev, dtype=torch.float32)
    # the scratch the weight launch reads only rounded: bfloat16 in that mode
    xs = dict(device=dev, dtype=torch.float32 if hot is None else hot)
    # per-step scratch of each layer: conv, h0g, d_gi, d_gh, d_conv, d_lp
    scr = [{"conv": torch.empty(rows * d, **xs),
            "h0g": torch.empty(rows * d, **xs),
            "dgi": torch.empty(rows * 3 * d, **f32),
            "dgh": torch.empty(rows * 3 * d, **f32),
            "dconv": torch.empty(rows * d, **f32),
            "dlp": torch.empty(rows * d, **f32)} for _ in range(2)]
    dwrel = torch.empty(R, 2 * d, **f32)
    shapes = {n: ((d, d) if "loop" in n else (3 * d,) if n.startswith("db")
                  else (d, 3 * d)) for n in _WGRAD_LAYOUT}
    sizes = [torch.Size(shapes[n]).numel() for n in _WGRAD_LAYOUT]
    wpart = torch.zeros(_WGRAD_SPLIT, sum(sizes), **f32)
    wsum = torch.empty(sum(sizes), **f32)

    stream = torch.cuda.current_stream(dev).cuda_stream
    p = _ptr
    lam = float(lam)
    # per layer, layer 2 first: its input, mask, ReLU, weights (the
    # self-loop and its transpose, W_ih and W_hh in both layouts), biases,
    # wrel column, own buffer, cotangent buffer and the cotangent of its
    # conv output (the third buffer's), the norm^2 output, scratch,
    # per-edge relation cotangents, and where the input cotangent goes
    # (added into db1, or written to dh0x)
    layers = (
        (buf1, m2, act2, w2, g2, d, buf2, db2, gb3, n2, scr[1], ewg2, db1, 1),
        (x1, m1, False, w1, g1, 0, buf1, db1, None, None, scr[0], ewg1, dh0x,
         0))

    def launched(err, what):
        _build.check(err, f"fused_window_bwd ({what})")
        fused_window_bwd.launches += 1

    for k in reversed(range(L1)):
        for (x, m, relu, w, g, col, own, dbuf, gloc, n2_out, s, ewg, target,
             acc) in layers:
            launched(fn["window_bwd_gru_launch"](
                p(x), p(d_ptr), p(d_src), p(d_rel), p(d_em), p(wrel), 2 * d,
                col, p(w["loop"]), p(m), int(relu), p(w["wih_t"]),
                p(w["whh_t"]), p(g["bih"]), p(g["bhh"]), p(w["wih"]),
                p(w["whh"]), p(gidx), p(live), p(dt), lam, p(own), p(dbuf),
                p(gloc), p(n2_out), p(s["conv"]), p(s["h0g"]), p(s["dgi"]),
                p(s["dgh"]), p(s["dconv"]), p(s["dlp"]), B, L1, A, d, k,
                stream), "gru")
            launched(fn["window_bwd_input_launch"](
                p(s_ptr), p(s_dst), p(s_rel), p(s_em), p(s_eid), p(n2),
                p(s["dconv"]), p(s["dlp"]), p(wrel), 2 * d, col,
                p(w["loop_t"]), p(x), p(ewg), p(target), acc, B, L1, A, d, k,
                stream), "input")
        s1, s2 = scr
        launched(fn["window_wgrad_launch"](
            p(s2["conv"]), p(s2["h0g"]), p(buf1), p(s2["dgi"]),
            p(s2["dgh"]), p(s2["dlp"]), p(s1["conv"]), p(s1["h0g"]),
            p(x1), p(s1["dgi"]), p(s1["dgh"]), p(s1["dlp"]), p(wpart),
            _WGRAD_SPLIT, B, L1, A, d, k, stream), "wgrad")
    launched(lib.window_wgrad_reduce_launch(p(wpart), _WGRAD_SPLIT,
                                            wsum.numel(), p(wsum), stream),
             "wgrad_reduce")
    launched(lib.window_rel_grad_launch(p(r_ptr), p(r_eid), p(ewg1),
                                        p(ewg2), p(dwrel), R, d, stream),
             "rel_grad")
    w = {n: t.view(shapes[n]) for n, t in
         zip(_WGRAD_LAYOUT, torch.split(wsum, sizes))}
    return (dh0x, dwrel, w["dloop1"], w["dloop2"], w["dwih1"], w["dwhh1"],
            w["dwih2"], w["dwhh2"], w["dbih1"], w["dbhh1"], w["dbih2"],
            w["dbhh2"])


fused_window_bwd.launches = 0


class FusedWindow(torch.autograd.Function):
    """Differentiable K2: `fwd` forward (``fused_window_fwd``, or K12's
    ``fused_window_mb_fwd``), ``fused_window_bwd`` backward, in the mode
    `hot` (None for float32, or torch.bfloat16). `graph` holds the tensors
    that take no gradient (src, dst, rel, em, gidx, live, dt, m1, m2).
    Returns n_buf buffers."""

    @staticmethod
    def forward(ctx, fwd, hot, lam, conv1_in, act2, n_buf, graph, h0x, wrel,
                loop1, loop2, wih1, whh1, bih1, bhh1, wih2, whh2, bih2,
                bhh2):
        src, dst, rel, em, gidx, live, dt, m1, m2 = graph
        g1 = {"wih_t": wih1, "whh_t": whh1, "bih": bih1, "bhh": bhh1}
        g2 = {"wih_t": wih2, "whh_t": whh2, "bih": bih2, "bhh": bhh2}
        bufs = fwd(h0x, src, dst, rel, em, gidx, live, dt, wrel, loop1, loop2,
                   g1, g2, lam, conv1_in, m1, m2, act2, n_buf, hot=hot)
        ctx.lam, ctx.conv1_in, ctx.act2, ctx.graph = lam, conv1_in, act2, graph
        ctx.hot = hot
        ctx.save_for_backward(h0x, wrel, loop1, loop2, wih1, whh1, bih1,
                              bhh1, wih2, whh2, bih2, bhh2, bufs[0], bufs[1])
        return bufs

    @staticmethod
    def backward(ctx, *gbs):
        if ctx.conv1_in:
            raise RuntimeError("fused_window: conv1_in (precomputed layer-1 "
                               "convs) is an eval-only mode")
        (h0x, wrel, loop1, loop2, wih1, whh1, bih1, bhh1, wih2, whh2, bih2,
         bhh2, buf1, buf2) = ctx.saved_tensors
        src, dst, rel, em, gidx, live, dt, m1, m2 = ctx.graph
        gbs = [torch.zeros_like(buf1) if g is None else g.contiguous()
               for g in gbs]
        gb3 = gbs[2] if len(gbs) == 3 else None
        (dh0x, dwrel, dloop1, dloop2, dwih1, dwhh1, dwih2, dwhh2, dbih1,
         dbhh1, dbih2, dbhh2) = fused_window_bwd(
            h0x, src, dst, rel, em, gidx, live, dt, wrel, loop1, loop2,
            {"wih_t": wih1, "whh_t": whh1, "bih": bih1, "bhh": bhh1},
            {"wih_t": wih2, "whh_t": whh2, "bih": bih2, "bhh": bhh2},
            ctx.lam, m1, m2, buf1, buf2, gbs[0], gbs[1], gb3, ctx.act2,
            hot=ctx.hot)
        return (None, None, None, None, None, None, None, dh0x, dwrel, dloop1,
                dloop2, dwih1, dwhh1, dbih1, dbhh1, dwih2, dwhh2, dbih2,
                dbhh2)


def fused_window_supported(cfg, base: str, activation2=None,
                           train: bool = False) -> bool:
    """Config-only envelope of K2 (and of its plain version): the GRRGCN
    family (either direction) with diagonal relation weights, the standard
    one-layer GRU, fixed decay, no time embedding, no activation or a ReLU
    on layer 2, and a width the kernels take (training: the backward's).
    Dropout on the self-loop is inside the envelope; the per-step random
    edge subsample (``random_dropout``) and DropEdge are not."""
    d = cfg.embed_size
    return (base == "GRRGCN"
            and not cfg.rec_only_last_layer
            and not cfg.type1
            and cfg.num_layers == 1
            and not cfg.learnable_lambda
            and not cfg.use_time_embedding
            and not (train and (cfg.random_dropout or cfg.edge_dropout))
            and cfg.n_bases == d == cfg.hidden_size
            and d <= (_MAX_D_BWD if train else _MAX_D) and d % 16 == 0
            and activation2 in (None, "relu"))


def window_args(enc_params, cfg, h0_xs, src, dst, rel, emask, prev_step,
                prev_row, dt, live, masks=None, direction=None,
                activation2=None) -> dict:
    """The keyword arguments of ``fused_window_fwd`` (less conv1_in and
    n_buf) for B history windows: h0_xs [B, L1, A, d]; src/dst/rel/emask
    [B, L1, E] compact-local edges; prev_step/prev_row/dt/live [B, L1, A];
    masks None (eval) or the training self-loop dropout masks (m1, m2), each
    [B, L1, A, d] over keep; direction None, "fwd" or "bwd" picks the GRU
    weights ("gru", "gru_fwd", "gru_bwd"); activation2 None or "relu",
    layer 2's."""
    A = prev_step.shape[-1]
    p1, p2 = enc_params["layer1"], enc_params["layer2"]
    key = GRU_KEY[direction]

    def gru(p):
        g = p[key][0]
        return {"wih_t": g["w_ih"].T.contiguous(),
                "whh_t": g["w_hh"].T.contiguous(),
                "bih": g["b_ih"].contiguous(), "bhh": g["b_hh"].contiguous()}

    gidx = (prev_step.long().clamp(min=0) * A + prev_row.long()).to(torch.int32)
    m1, m2 = (None, None) if masks is None else (
        masks[0].contiguous(), masks[1].contiguous())
    return dict(
        h0x=h0_xs.contiguous(), src=src.to(torch.int32).contiguous(),
        dst=dst.to(torch.int32).contiguous(),
        rel=rel.to(torch.int32).contiguous(),
        em=emask.to(torch.float32).contiguous(), gidx=gidx.contiguous(),
        live=live.to(torch.float32).contiguous(),
        dt=dt.to(torch.float32).contiguous(),
        wrel=torch.cat([p1["weight"], p2["weight"]], dim=1).contiguous(),
        loop1=p1["loop_weight"].contiguous(),
        loop2=p2["loop_weight"].contiguous(), g1=gru(p1), g2=gru(p2),
        lam=float(cfg.inv_temperature), m1=m1, m2=m2,
        act2=activation2 == "relu")


def apply_window(fwd, a: dict, conv1_in: bool, n_buf: int, hot=None):
    """``FusedWindow`` with the forward `fwd` on ``window_args``' dict, in
    the mode `hot`."""
    g1, g2 = a["g1"], a["g2"]
    graph = tuple(a[k] for k in ("src", "dst", "rel", "em", "gidx", "live",
                                 "dt", "m1", "m2"))
    return FusedWindow.apply(
        fwd, hot, a["lam"], bool(conv1_in), a["act2"], n_buf, graph,
        a["h0x"],
        a["wrel"], a["loop1"], a["loop2"], g1["wih_t"], g1["whh_t"],
        g1["bih"], g1["bhh"], g2["wih_t"], g2["whh_t"], g2["bih"],
        g2["bhh"])


def fused_window_scan(enc_params, cfg, h0_xs, src, dst, rel, emask,
                      prev_step, prev_row, dt, live, conv1_in: bool = False,
                      kernels: bool = True, masks=None, direction=None,
                      activation2=None, n_buf: int = 2):
    """Run B history windows through K2 (``kernels=False``: its plain
    version, differentiated by autograd) in ``cfg.hot_dtype``; arguments as
    in ``window_args``. Returns (buf1, buf2[, buf3]): n_buf buffers in the
    store dtype (float32, or the hot dtype)."""
    a = window_args(enc_params, cfg, h0_xs, src, dst, rel, emask, prev_step,
                    prev_row, dt, live, masks, direction, activation2)
    hot = cfg.hot_dtype
    if not kernels:
        return fused_window_fwd_plain(conv1_in=bool(conv1_in), n_buf=n_buf,
                                      hot=hot, **a)
    return apply_window(fused_window_fwd, a, conv1_in, n_buf, hot)
