"""The window's native bfloat16 products (K2f and K2b in their bfloat16
mode, ``csrc/fused_window_bf16.cu`` on ``csrc/window_bf16.cuh``), checked
without a card.

- The arithmetic: ``mma.sync m16n8k16`` with bfloat16 operands and float32
  accumulators multiplies exactly (a product of two bfloat16 values fits
  float32) and adds 16 depth terms a step into the accumulator. A numpy
  model of that, with the step's sum rounded to nearest and with it
  truncated (the tensor cores' own rounding is not documented; the two
  bracket it), at the window's depths (128: the gate and self-loop
  products at d = 128; 384: K2b's transposed gate products over 3d; 3,584:
  a range of the weight launch, whose depth is rows), is held to float64
  and to the JAX kernels' ``_dot`` of bfloat16 operands with float32
  results (``temp_tpu/ops/fused_window.py``), which the TPU kernels'
  bfloat16 instantiation computes.
- The fragments: the lanes' ldmatrix addresses of ``window_bf16.cuh``
  (``frag_ptr``, ``frag_ptr_t``), ldmatrix's and the mma's register
  layouts (PTX ISA), emulated lane by lane, give the product of the tiles
  ``tile_product_bf`` and ``wgrad_tile_bf`` stage.
- The host side: ``ops/fused_window.kernel_operands``, the wrapper's
  bfloat16 copies of layer 1's rows and the weights (and their layouts),
  bit for bit JAX's ``astype(jnp.bfloat16)``; the bfloat16 launchers' C
  declarations against ``_build.SIGNATURES``; no product loop of the new
  kernels rounds or splits an operand.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from temp_tpu.ops.fused_window import _dot
from temp_tpu_torch import _build
from temp_tpu_torch.ops import fused_window as fw

from test_torch_slice import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CSRC = os.path.dirname(_build.SOURCES[0])
# float32's unit roundoff (nearest) and its ulp (truncation)
U_RN, U_TR = 2.0 ** -24, 2.0 ** -23


def bf16(x):
    """x rounded to bfloat16 (nearest, ties to even), as float32."""
    return np.array(jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def to_f32(s, mode: str):
    """float64 s as float32: rounded to nearest, or truncated (toward
    zero)."""
    f = s.astype(np.float32)
    if mode == "trunc":
        over = np.abs(f.astype(np.float64)) > np.abs(s)
        f = np.where(over, np.nextafter(f, np.float32(0)), f)
    return f


def mma_model(a, b, mode: str):
    """a [M, K] @ b [K, N] (bfloat16 values) as mma.sync m16n8k16
    accumulates: per k16 step the exact sum of its 16 products added to the
    float32 accumulator and the result rounded (`mode` "nearest" or
    "trunc")."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        step = a64[:, k0:k0 + 16] @ b64[k0:k0 + 16]
        acc = to_f32(acc.astype(np.float64) + step, mode)
    return acc


@pytest.mark.parametrize("K", [128, 384, 3584])
def test_bf16_mma_model_against_float64_and_jax(K):
    """The modelled product of bfloat16 operands within the bound of its
    roundings of float64's: one rounding a k16 step, each under one ulp
    (truncation) or half (nearest) of the partial sum, so at most K / 16
    ulps of sum |a_i b_i|; and within that plus JAX's own float32 sums (K
    roundings of at most half an ulp) of ``_dot``'s result on the same
    bfloat16 operands (preferred_element_type float32), the JAX kernels'
    bfloat16 product."""
    g = np.random.default_rng(K)
    M, N = 32, 48
    a = bf16(g.standard_normal((M, K)).astype(np.float32))
    b = bf16((g.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    jax_out = np.asarray(_dot(jnp.asarray(a, jnp.bfloat16),
                              jnp.asarray(b, jnp.bfloat16), None))
    assert jax_out.dtype == np.float32
    for mode, u in (("nearest", U_RN), ("trunc", U_TR)):
        got = mma_model(a, b, mode)
        bound = K / 16 * u * mag
        assert np.all(np.abs(got - exact) <= bound), mode
        assert np.all(np.abs(got - jax_out) <= bound + K * U_RN * mag), mode
    # and the port's plain bfloat16 product (hot_mm: rounded operands,
    # float32 sums) as JAX's is
    plain = fw.hot_mm(torch.from_numpy(a), torch.from_numpy(b),
                      torch.bfloat16).numpy()
    assert np.all(np.abs(plain - jax_out) <= 2 * K * U_RN * mag)


# -- the fragments, lane by lane ---------------------------------------------

def lane_ptr(lane, ld):
    """window_bf16.cuh frag_ptr: (row, col) offset of the lane's address."""
    return (lane & 15), (lane >> 4) * 8


def lane_ptr_t(lane, ld):
    """window_bf16.cuh frag_ptr_t."""
    return (lane >> 4) * 8 + (lane & 7), ((lane >> 3) & 1) * 8


def ldmatrix_x4(mem, addr, trans: bool):
    """ldmatrix .x4 .b16 over a 2-d shared array `mem`: addr[l] the (row,
    col) lane l names (lanes 8i..8i+7 the rows of matrix i). Returns regs
    [32, 4, 2]: lane l's register j holds matrix j's elements (row l // 4,
    cols 2(l % 4), 2(l % 4) + 1), or with trans (rows 2(l % 4), 2(l % 4) +
    1, col l // 4); the first element in the low half."""
    mats = [np.stack([mem[addr[8 * i + r][0],
                          addr[8 * i + r][1]:addr[8 * i + r][1] + 8]
                      for r in range(8)]) for i in range(4)]
    regs = np.zeros((32, 4, 2), mem.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j, m in enumerate(mats):
            regs[lane, j] = (m[2 * t:2 * t + 2, g] if trans
                             else m[g, 2 * t:2 * t + 2])
    return regs


def mma_m16n8k16(c, a, b0, b1):
    """mma.sync.m16n8k16.row.col on lane registers (PTX ISA layouts): a
    [32, 4, 2], b0/b1 [32, 2] the two B registers, c [32, 4] the
    accumulators (c0, c1 row g cols 2t, 2t+1; c2, c3 row g + 8). Returns
    the new c, computed in float64."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j, (r, k) in enumerate(((g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            A[r, k:k + 2] = a[lane, j]
        B[2 * t:2 * t + 2, g] = b0[lane]
        B[2 * t + 8:2 * t + 10, g] = b1[lane]
    D = A @ B
    out = c.copy()
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                      D[g + 8, 2 * t + 1]]
    return out


def acc_rc(lane, mt, nt, i):
    """rgcn_gru_layer.cuh acc_row / acc_col of accumulator (mt, nt, i)."""
    return (mt * 16 + (lane >> 2) + (8 if i >= 2 else 0),
            nt * 8 + 2 * (lane & 3) + (i & 1))


def test_tile_fragments_give_the_product():
    """``tile_product_bf``'s loads for one warp: A (MT = 2 m16 tiles of a
    row-major [rows, K] array, row stride K + 8) by ldsm_x4 at frag_ptr,
    B (the warp's 16 columns of a depth-major ring slot, row stride
    3 * 64 + 8, window g at column 64 g) by ldsm_x4_t at frag_ptr, two
    mma a window and m tile; the accumulators at acc_row / acc_col hold
    A @ B."""
    g = np.random.default_rng(0)
    K, ws, c0, win = 32, 3 * 64 + 8, 16, 1
    A = g.integers(-8, 8, (32, K + 8)).astype(np.float64)
    W = g.integers(-8, 8, (K, ws)).astype(np.float64)
    acc = np.zeros((2, 2, 32, 4))
    for k0 in range(0, K, 16):
        fa = [ldmatrix_x4(A, [(mt * 16 + lane_ptr(l, 0)[0],
                               k0 + lane_ptr(l, 0)[1]) for l in range(32)],
                          False) for mt in range(2)]
        fb = ldmatrix_x4(W, [(k0 + lane_ptr(l, 0)[0],
                              64 * win + c0 + lane_ptr(l, 0)[1])
                             for l in range(32)], True)
        for mt in range(2):
            acc[mt, 0] = mma_m16n8k16(acc[mt, 0], fa[mt], fb[:, 0], fb[:, 1])
            acc[mt, 1] = mma_m16n8k16(acc[mt, 1], fa[mt], fb[:, 2], fb[:, 3])
    want = A[:, :K] @ W[:, 64 * win + c0:64 * win + c0 + 16]
    for lane in range(32):
        for mt in range(2):
            for nt in range(2):
                for i in range(4):
                    r, c = acc_rc(lane, mt, nt, i)
                    assert acc[mt, nt, lane, i] == want[r, c]


def test_wgrad_fragments_give_the_product():
    """``wgrad_tile_bf``'s loads for one warp: X^T's m16 tiles (the warp's
    32 x columns at wm, of X's depth-major slot rows, stride 64 + 8) by
    ldsm_x4_t at frag_ptr_t, G's pairs of n8 tiles (its 32 g columns at wn)
    by ldsm_x4_t at frag_ptr; the accumulators hold X^T G."""
    g = np.random.default_rng(1)
    K, ld, wm, wn = 32, 64 + 8, 32, 0
    X = g.integers(-8, 8, (K, ld)).astype(np.float64)
    G = g.integers(-8, 8, (K, ld)).astype(np.float64)
    acc = np.zeros((2, 4, 32, 4))
    for k0 in range(0, K, 16):
        fa = [ldmatrix_x4(X, [(k0 + lane_ptr_t(l, ld)[0],
                               wm + mt * 16 + lane_ptr_t(l, ld)[1])
                              for l in range(32)], True) for mt in range(2)]
        for np_ in range(2):
            fb = ldmatrix_x4(G, [(k0 + lane_ptr(l, ld)[0],
                                  wn + np_ * 16 + lane_ptr(l, ld)[1])
                                 for l in range(32)], True)
            for mt in range(2):
                acc[mt, 2 * np_] = mma_m16n8k16(acc[mt, 2 * np_], fa[mt],
                                                fb[:, 0], fb[:, 1])
                acc[mt, 2 * np_ + 1] = mma_m16n8k16(
                    acc[mt, 2 * np_ + 1], fa[mt], fb[:, 2], fb[:, 3])
    want = X[:, wm:wm + 32].T @ G[:, wn:wn + 32]
    for lane in range(32):
        for mt in range(2):
            for nt in range(4):
                for i in range(4):
                    r, c = acc_rc(lane, mt, nt, i)
                    assert acc[mt, nt, lane, i] == want[r, c]


# -- the host side -----------------------------------------------------------

def _jax_bf16_bits(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)


def _torch_bits(t):
    assert t.dtype == torch.bfloat16 and t.is_contiguous()
    return t.view(torch.int16).numpy().view(np.uint16)


def test_kernel_operands_round_once_as_jax():
    """The wrapper's bfloat16 operands: layer 1's rows, each layer's
    self-loop and its transpose, W_ih and W_hh transposed ([d, 3d]) and in
    torch's layout ([3d, d]), contiguous, bit for bit JAX's
    ``astype(jnp.bfloat16)`` of the same float32 values (halfway cases
    included); in float32 the tensors as given."""
    g = np.random.default_rng(3)
    d = 16

    def f32(*shape):
        x = g.standard_normal(shape).astype(np.float32)
        # a few exact halfway points between bfloat16 neighbours
        x.reshape(-1)[:4] = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8,
                                      -(1 + 2 ** -8), 3 * 2 ** -9],
                                     np.float32)
        return x

    h0x = f32(2, 3, 5, d)
    loops = [f32(d, d), f32(d, d)]
    grus = [{"wih_t": f32(d, 3 * d), "whh_t": f32(d, 3 * d),
             "bih": f32(3 * d), "bhh": f32(3 * d)} for _ in range(2)]
    T = torch.from_numpy
    tg = [{k: T(v) for k, v in gr.items()} for gr in grus]
    x1, w1, w2 = fw.kernel_operands(T(h0x), T(loops[0]), T(loops[1]), tg[0],
                                    tg[1], hot=torch.bfloat16, bwd=True)
    assert np.array_equal(_torch_bits(x1), _jax_bf16_bits(h0x))
    for w, loop, gr in ((w1, loops[0], grus[0]), (w2, loops[1], grus[1])):
        want = {"loop": loop, "loop_t": loop.T, "wih_t": gr["wih_t"],
                "whh_t": gr["whh_t"], "wih": gr["wih_t"].T,
                "whh": gr["whh_t"].T}
        assert set(w) == set(want)
        for k, v in want.items():
            assert np.array_equal(_torch_bits(w[k]), _jax_bf16_bits(v)), k
    _, f1, _ = fw.kernel_operands(T(h0x), T(loops[0]), T(loops[1]), tg[0],
                                  tg[1], hot=torch.bfloat16)
    assert set(f1) == {"loop", "wih_t", "whh_t"}
    h = T(h0x)
    x1, w1, _ = fw.kernel_operands(h, T(loops[0]), T(loops[1]), tg[0],
                                   tg[1], bwd=True)
    assert x1 is h and w1["wih_t"] is tg[0]["wih_t"]
    assert torch.equal(w1["wih"], tg[0]["wih_t"].t())
    assert w1["wih"].is_contiguous() and w1["loop_t"].is_contiguous()


def _extern_c(src: str) -> dict:
    """name -> parameter count of each extern "C" function in src."""
    out = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[name] = len([p for p in params.split(",") if p.strip()])
    return out


def test_bf16_window_launchers_match_the_build():
    """``csrc/fused_window_bf16.cu`` exports each window launcher
    ``name_bf16`` (and the occupancy query) with as many parameters as
    ``_build.SIGNATURES[name]``, every one in ``BF16_LAUNCHERS``;
    ``fused_window.cu`` its float32 ones; and no product loop of the
    bfloat16 window (``tile_product_bf``, ``wgrad_tile_bf``) rounds,
    splits or multiplies in TF32."""
    bf = _extern_c(open(os.path.join(CSRC, "fused_window_bf16.cu")).read())
    f32 = _extern_c(open(os.path.join(CSRC, "fused_window.cu")).read())
    names = ("window_layer_launch", "window_bwd_gru_launch",
             "window_bwd_input_launch", "window_wgrad_launch",
             "window_occupancy")
    assert set(bf) == {f"{n}_bf16" for n in names}
    for n in names:
        assert n in _build.BF16_LAUNCHERS
        assert bf[f"{n}_bf16"] == f32[n] == len(_build.SIGNATURES[n]), n
    hdr = open(os.path.join(CSRC, "window_bf16.cuh")).read()
    for fn in ("tile_product_bf", "wgrad_tile_bf"):
        start = hdr.index(f"void {fn}(")
        body = hdr[start:hdr.index("\n}\n", start)]
        assert "mma_bf16(" in body, fn
        for banned in ("split_tf32", "round_bf16", "mma_tf32", "mma3",
                       "tf32"):
            assert banned not in body, (fn, banned)
