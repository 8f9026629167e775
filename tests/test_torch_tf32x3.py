"""The tolerance argument for the tensor-core products (3xTF32) of the
window's and the final step's kernels (K2f, K2b, K3, K4, K5, K9+K10).

The backward tiles (``csrc/rgcn_gru_layer.cuh`` ``tile_product``) split
each f32 operand x into hi, x with its 13 low mantissa bits cleared, and
lo = x - hi (exact in f32), passed to the tensor core as it is: a tf32
operand's 13 low bits are not read, so the product sees lo truncated to
11 significant bits. The weight launch (``wgrad_tile``), whose sums run
over thousands of rows, rounds hi to tf32 instead (nearest, ties away, as
``cvt.rna.tf32.f32``). Each step of 8 depth terms adds lo*hi + hi*lo +
hi*hi, from zero, into an f32 accumulator. A numpy model of those
products, at the depths of the kernels' products (128: the gate and
self-loop products at d = 128; 384: the transposed gate products over 3d;
3,584: a range of K5's weight launch, whose depth is rows), is held to
float64 within 1e-6 of the largest entry, tenfold inside the smoke's 1e-5
(``SCALED_TOL``). Plain f32 (one rounded multiply-add a term, as the
forward tiles) and a single TF32 product are printed beside it. The card's
own accumulation order inside an mma is not modelled: the card's checks
(``chip_smoke.py``, ``tests/test_torch_gpu.py``) decide.
"""

import numpy as np
import pytest

TOL = 1e-6


def tf32(x):
    """x (float32) rounded to tf32: nearest, ties away from zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def trunc13(x):
    """x (float32) with its 13 low mantissa bits cleared: tf32 by
    truncation, and what the tensor core reads of a tf32 operand."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x, rounded: bool):
    """(hi, lo as the tensor core reads it) of the kernels' split."""
    hi = tf32(x) if rounded else trunc13(x)
    return hi, trunc13((x - hi).astype(np.float32))


def product_3xtf32(a, b, rounded: bool):
    """a [M, K] @ b [K, N] as the kernels compute it: per step of 8 depth
    terms the three split products, exact (float64: each is a product of
    two 11-bit significands) and rounded once to f32, added to the f32
    accumulator."""
    ahi, alo = split(a, rounded)
    bhi, blo = split(b, rounded)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        t = (alo[:, s].astype(np.float64) @ bhi[s].astype(np.float64)
             + ahi[:, s].astype(np.float64) @ blo[s].astype(np.float64)
             + ahi[:, s].astype(np.float64) @ bhi[s].astype(np.float64))
        acc = (acc + t.astype(np.float32)).astype(np.float32)
    return acc


def product_f32(a, b):
    """a @ b as one f32 multiply-add a depth term, in order."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        prod = (a[:, k:k + 1].astype(np.float64) * b[k:k + 1].astype(
            np.float64) + acc).astype(np.float32)
        acc = prod
    return acc


@pytest.mark.parametrize("rounded,bound", [(False, 2.0 ** -20),
                                           (True, 2.0 ** -21)])
def test_split_keeps_21_bits(rounded, bound):
    g = np.random.default_rng(0)
    x = g.standard_normal(4096).astype(np.float32)
    hi, lo = split(x, rounded)
    # both parts are tf32 values; together they hold x to 2^-20 (hi
    # truncated) or 2^-21 (hi rounded)
    assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)
    assert np.all(lo.view(np.uint32) & np.uint32(0x1FFF) == 0)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= bound
    assert np.abs(hi - x).max() > 0  # tf32 alone drops bits
    # ties round away from zero, as cvt.rna does
    t = np.array([1 + 2.0 ** -11, -(1 + 2.0 ** -11)], np.float32)
    assert tf32(t).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
    assert trunc13(t).tolist() == [1.0, -1.0]


@pytest.mark.parametrize("depth,rows,cols,scale,rounded", [
    (128, 256, 64, 1.0, False),     # gate and self-loop products, d = 128
    (384, 256, 64, 1.0, False),     # d_gi @ W_ih, d_gh @ W_hh over 3d
    (3584, 64, 64, 1e-3, True),     # a range of K5's weight launch (rows)
])
def test_split_product_is_within_f32_rounding(depth, rows, cols, scale,
                                              rounded):
    g = np.random.default_rng(depth)
    a = (g.standard_normal((rows, depth)) * scale).astype(np.float32)
    # xavier-sized weights, or for the weight launch cotangent-sized rows
    b = (g.standard_normal((depth, cols)) / np.sqrt(depth)).astype(
        np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    big = float(np.abs(ref).max())
    err3 = float(np.abs(product_3xtf32(a, b, rounded) - ref).max())
    err32 = float(np.abs(product_f32(a, b) - ref).max())
    err1 = float(np.abs(tf32(a).astype(np.float64) @ tf32(b) - ref).max())
    print(f"depth {depth}: 3xTF32 {err3 / big:.3e}, plain f32 "
          f"{err32 / big:.3e}, one TF32 product {err1 / big:.3e} of the "
          f"largest entry {big:.3e}")
    assert err3 <= TOL * big
    # the same order as plain f32, and far from a single TF32 product
    assert err3 <= 10 * max(err32, 1e-9 * big)
    assert err1 > 10 * err3


def mma_rz(c, prods):
    """One tensor-core step as modelled here: the f32 sum c [M, N] plus the
    exact products prods [k, M, N], each addend truncated toward zero to
    the 24-bit grid of the largest of them (alignment without guard bits),
    summed, and the sum truncated toward zero to f32. Pessimistic beside
    the card: it keeps no extra alignment bits."""
    terms = np.concatenate([c[None].astype(np.float64), prods], 0)
    top = np.abs(terms).max(0)
    grid = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - 23)
    s = (np.trunc(terms / grid) * grid).sum(0)
    f = s.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(s)
    return np.where(over, np.nextafter(f, np.float32(0)), f).astype(
        np.float32)


def product_tc(a, b, window: int):
    """a [M, K] @ b [K, N] as the tensor-core tiles compute it (the split of
    ``split`` with hi truncated, as ``tile_product``): per step of 8 depth
    terms the products lo*hi, hi*lo and hi*hi in that order, each an mma
    step (``mma_rz``) on a running sum that starts from zero every
    `window` depth terms and is then added to the f32 accumulator with a
    rounded add."""
    ahi, alo = split(a, False)
    bhi, blo = split(b, False)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for w0 in range(0, a.shape[1], window):
        t = np.zeros_like(acc)
        for k in range(w0, min(a.shape[1], w0 + window), 8):
            s = slice(k, k + 8)
            for x, y in ((alo, bhi), (ahi, blo), (ahi, bhi)):
                t = mma_rz(t, np.einsum("mk,kn->kmn", x[:, s].astype(
                    np.float64), y[s].astype(np.float64)))
        acc = (acc + t).astype(np.float32)
    return acc


@pytest.mark.parametrize("depth", [
    128,    # K2f's and K9+K10's self-loop and gate products at d = 128
    384,    # the bi tile's transposed products over 2d, then d, a section
])
def test_tile_accumulation_depth_keeps_f32_accuracy(depth):
    """The window's forward layer (K2f) and the flagship's bi GRU tile
    (K9+K10) compute every product with ``tile_product``: the truncated
    split and a running sum of 8 depth terms in the tensor core, then a
    rounded f32 add. Under the truncating accumulation of ``mma_rz`` that
    stays within 1e-6 of the largest entry of the float64 product; the
    tensor core's own sum over the whole depth (as one long chain of
    products into one accumulator would keep it) does not."""
    g = np.random.default_rng(depth + 1)
    a = g.standard_normal((96, depth)).astype(np.float32)
    b = (g.standard_normal((depth, 48)) / np.sqrt(depth)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    big = float(np.abs(ref).max())
    err8 = float(np.abs(product_tc(a, b, 8) - ref).max())
    err_all = float(np.abs(product_tc(a, b, depth) - ref).max())
    print(f"depth {depth}: 8 terms a sum {err8 / big:.3e}, the whole depth "
          f"{err_all / big:.3e} of the largest entry {big:.3e}")
    assert err8 <= TOL * big
    assert err_all > err8


def _softmax_rows(g, rows: int, n: int, cols: int, scale: float):
    """The probability tile of K4: exp(score - lse) of `rows` queries over
    the first `cols` of n columns, float32, scaled by `scale` (d_table's
    loss weight)."""
    s = (g.standard_normal((rows, n)) * 3).astype(np.float32)
    lse = np.log(np.exp(s.astype(np.float64)).sum(1, keepdims=True))
    return (np.exp(s[:, :cols] - lse) * scale).astype(np.float32)


@pytest.mark.parametrize("case", ["scores", "dq", "d_table"])
def test_loss_products_keep_f32_accuracy(case):
    """K3's and K4's tensor-core products (``csrc/fused_final.cu``
    ``score_product`` and ``cot_product``) use the tiles' split and 8-term
    running sums: the score tile (64 queries by 64 table rows at depth d =
    128); K4's dq = P T over one column range of the main shape (891
    columns, 14 tiles of 64 whose sums carry on in one f32 accumulator);
    and d_table = P^T Q over both directions' 256 queries (8 tiles of 64),
    P the loss-weighted probabilities. Under ``mma_rz`` each stays within
    1e-6 of the largest entry of the float64 product. The kernels take a
    k8 step's terms in another order (pairs of depth terms in slots t and
    t + 4), which the model does not see: a step sums the same 8 terms."""
    g = np.random.default_rng({"scores": 11, "dq": 12, "d_table": 13}[case])
    if case == "scores":
        a = (g.standard_normal((64, 128)) * 0.5).astype(np.float32)
        b = g.standard_normal((128, 64)).astype(np.float32)
    elif case == "dq":
        a = _softmax_rows(g, 64, 7128, 891, 1.0)
        b = g.standard_normal((891, 128)).astype(np.float32)
    else:
        a = np.ascontiguousarray(_softmax_rows(g, 512, 7128, 64,
                                               1 / 3200).T)
        b = g.standard_normal((512, 128)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    big = float(np.abs(ref).max())
    err = float(np.abs(product_tc(a, b, 8) - ref).max())
    print(f"{case}: 3xTF32 {err / big:.3e} of the largest entry {big:.3e}")
    assert err <= TOL * big
